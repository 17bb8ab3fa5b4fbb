"""The port's negotiation against the JAX package's: message tables,
fusion plans, algorithm resolution, fault specs, the response cache and
the controller's duplicate-name check.

The same Request sets go through ``horovod_tpu.core.MessageTable`` and the
port's Python and native tables: the Responses must be equal, and every
coordinated error string equal byte for byte (``ConstructMPIResponse``'s
texts, ``operations.cc:315-517``).
"""

import dataclasses

import pytest

from horovod_tpu import core as ref_core
from horovod_tpu import scheduler as ref_sched
from horovod_tpu_torch import core as port_core
from horovod_tpu_torch import cpp_core as port_cpp
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch import scheduler as port_sched

AR, AG, BC = 0, 1, 2


def _req(core, rank, rtype=AR, name="t", dtype="float32", shape=(4, 2),
         root=-1, device=None, wire="", algo=""):
    return core.Request(request_rank=rank,
                        request_type=core.RequestType(rtype),
                        tensor_name=name, tensor_type=dtype,
                        tensor_shape=tuple(shape), root_rank=root,
                        device=rank if device is None else device,
                        wire_dtype=wire, algo=algo)


def _ranks(n, **kw):
    return [dict(rank=r, **kw) for r in range(n)]


def _with(specs, rank, **kw):
    specs = [dict(s) for s in specs]
    specs[rank].update(kw)
    return specs


# Each case: table size, request specs (in arrival order), and the
# (hosts, processes) of algorithm selection.
CASES = {
    "allreduce_ok": (4, _ranks(4), None),
    "single_rank": (1, _ranks(1), None),
    "dtype": (4, _with(_ranks(4), 2, dtype="float64"), None),
    "dtype_first": (3, _with(_ranks(3), 0, dtype="int32"), None),
    "op": (2, _with(_ranks(2), 1, rtype=AG), None),
    "shape": (4, _with(_ranks(4), 1, shape=(3, 3)), None),
    "broadcast_shape": (2, _with(_ranks(2, rtype=BC, root=0), 1,
                                 shape=(2,)), None),
    "device": (2, _with(_ranks(2), 1, device=-1), None),
    "allgather_ragged": (3, [dict(rank=r, rtype=AG, shape=(r + 1, 2))
                             for r in range(3)], None),
    "allgather_rank": (2, _with(_ranks(2, rtype=AG), 1, shape=(2, 2, 2)),
                       None),
    "allgather_dim": (4, _with(_ranks(4, rtype=AG, shape=(2, 4)), 3,
                               shape=(2, 5)), None),
    "allgather_scalar": (2, _ranks(2, rtype=AG, shape=()), None),
    "broadcast_root": (2, _with(_ranks(2, rtype=BC, root=0), 1, root=1),
                       None),
    "broadcast_ok": (3, _ranks(3, rtype=BC, root=2, dtype="bfloat16"),
                     None),
    "wire": (2, _with(_ranks(2, wire="bf16"), 1, wire="int8"), None),
    "wire_raw": (2, _with(_ranks(2), 1, wire="int8"), None),
    "wire_ok": (2, _ranks(2, wire="int8"), None),
    "algo": (2, _with(_ranks(2, algo="small"), 1, algo=""), None),
    "auto_small": (2, _ranks(2, algo="auto", dtype="bfloat16",
                             shape=(16384,)), None),
    "auto_ring": (2, _ranks(2, algo="auto", dtype="bfloat16",
                            shape=(40000,)), None),
    "auto_hier": (4, _ranks(4, algo="auto", shape=(1 << 16,)), (2, 4)),
    "reversed_arrival": (3, list(reversed(_ranks(3))), None),
}


def _negotiate(table, core, size, specs, algo_topo):
    if algo_topo is not None:
        table.configure_algo_selection(*algo_topo,
                                       core.DEFAULT_ALGO_CROSSOVER_BYTES)
    out = []
    for s in specs:
        r = _req(core, **s)
        if table.increment(r):
            out.append(table.construct_response(r.tensor_name))
    assert len(table) == 0
    return [dataclasses.asdict(r) for r in out]


@pytest.mark.parametrize("impl", ["python", "native"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_message_table_matches_the_reference(case, impl):
    size, specs, algo_topo = CASES[case]
    want = _negotiate(ref_core.MessageTable(size), ref_core, size, specs,
                      algo_topo)
    table = (port_core.MessageTable(size) if impl == "python"
             else port_cpp.CppMessageTable(size))
    got = _negotiate(table, port_core, size, specs, algo_topo)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        g["response_type"] = int(g["response_type"])
        w["response_type"] = int(w["response_type"])
        assert g == w
    if case.endswith("_ok") or case.startswith(("auto", "allgather_ragged",
                                                "reversed", "single")):
        assert got[0]["error_message"] == ""
    elif case != "allgather_scalar":
        assert got[0]["error_message"].startswith("Mismatched"), got


def _fusion_inputs(core):
    specs = [(AR, "a", "", ""), (AR, "b", "", ""), (BC, "c", "", ""),
             (AR, "d", "", ""), (AR, "e", "int8", ""), (AR, "f", "int8", ""),
             (AR, "g", "", "small"), (AR, "h", "", ""), (AR, "big", "", ""),
             (AR, "i", "", ""), (AR, "j", "", "")]
    resps = [core.Response(core.ResponseType(t), [n], devices=[0, 1],
                           wire_dtype=w, algo=a) for t, n, w, a in specs]
    sizes = {"big": 900, "i": 100, "j": 100}
    dtypes = {"h": "float16", "j": "int32"}
    return resps, (lambda n: sizes.get(n, 40)), \
        (lambda n: dtypes.get(n, "float32"))


@pytest.mark.parametrize("threshold", [0, 40, 100, 160, 1 << 20])
def test_plan_fusion_matches_the_reference(threshold):
    want = [dataclasses.asdict(r) for r in ref_core.plan_fusion(
        *_fusion_inputs(ref_core), threshold)]
    for plan in (port_core.plan_fusion, port_sched.plan_tick,
                 port_cpp.cpp_plan_fusion, port_cpp.cpp_plan_tick):
        got = [dataclasses.asdict(r) for r in plan(
            *_fusion_inputs(port_core), threshold)]
        for g, w in zip(got, want):
            g["response_type"] = int(g["response_type"])
            w["response_type"] = int(w["response_type"])
        assert got == want, plan


@pytest.mark.parametrize("pref", ["", "ring", "small", "hier", "auto"])
def test_resolve_algo_matches_the_reference(pref):
    for nbytes in (0, 1 << 10, 64 << 10, (64 << 10) + 1, 1 << 24):
        for hosts, procs in ((1, 1), (1, 4), (2, 4), (4, 4)):
            want = ref_sched.resolve_algo(pref, nbytes, hosts, procs)
            assert port_sched.resolve_algo(pref, nbytes, hosts, procs) \
                == want
            assert port_cpp.cpp_resolve_algo(
                pref, nbytes, hosts, procs,
                port_core.DEFAULT_ALGO_CROSSOVER_BYTES) == want


FAULTS = ["", "crash:rank=1:tick=3", "hang:rank=0:tick=1;rejoin:rank=0:tick=9",
          "slow:rank=2:ms=5", "slow:rank=2:ms=5:tick=4",
          "corrupt:rank=0:tick=2:leg=shm:count=3", "crash_in_save:rank=0:epoch=0",
          "crash:rank=1", "crash:rank=x:tick=1", "slow:rank=1:ms=0",
          "corrupt:rank=0:tick=1:leg=nope", "explode:rank=0:tick=1",
          "crash:rank=-1:tick=1", "crash:rank=0:tick=0"]


@pytest.mark.parametrize("spec", FAULTS)
def test_fault_specs_parse_like_the_reference(spec):
    def parse(core):
        try:
            return [dataclasses.astuple(f)
                    for f in core.parse_fault_specs(spec)]
        except ValueError as e:
            return str(e)
    assert parse(port_core) == parse(ref_core)


@pytest.mark.parametrize("name", ["OK", "precondition_error", "aborted",
                                  "retryable", "invalid_argument"])
def test_status_matches_the_reference(name):
    def make(core):
        fn = getattr(core.Status, name)
        s = fn() if name == "OK" else fn("why")
        return int(s.type), s.reason, s.ok()
    assert make(port_core) == make(ref_core)
    assert port_core.SHUT_DOWN_ERROR.reason == ref_core.SHUT_DOWN_ERROR.reason


def _cache_trace(core, metrics):
    """Replies of a response cache to a fixed sequence of batches, and the
    hit/miss/eviction counters it moved."""
    before = dict(metrics.registry.snapshot()["counters"])
    cache = core._LocalResponseCache(3)
    r = lambda name, shape=(4,): _req(core, 0, name=name, shape=shape)  # noqa
    fused = [core.Response(core.ResponseType.ALLREDUCE, ["a", "b"],
                           devices=[0])]
    out = [cache.lookup([r("a"), r("b")], table_empty=True)]
    cache.store([r("a"), r("b")], fused)
    out.append(cache.lookup([r("a"), r("b")], table_empty=True))
    out.append(cache.lookup([r("a"), r("b")], table_empty=False))
    out.append(cache.lookup([r("a", (5,)), r("b")], table_empty=True))
    for n in "cdef":
        cache.lookup([r(n)], table_empty=True)
    cache.flush()
    after = metrics.registry.snapshot()["counters"]
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("control.cache_hits", "control.cache_misses",
                       "control.cache_evictions")}
    return [None if x is None else [dataclasses.asdict(y) for y in x]
            for x in out], moved


def test_response_cache_matches_the_reference():
    from horovod_tpu import metrics as ref_metrics
    got, got_moved = _cache_trace(port_core, port_metrics)
    want, want_moved = _cache_trace(ref_core, ref_metrics)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            for a, b in zip(g, w):
                a["response_type"] = int(a["response_type"])
                b["response_type"] = int(b["response_type"])
            assert g == w
    assert got_moved == want_moved
    assert got[1] is not None and got_moved["control.cache_hits"] > 0


@pytest.mark.parametrize("impl", ["python", "native"])
def test_stall_records_name_the_missing_ranks(impl):
    table = (port_core.MessageTable(3) if impl == "python"
             else port_cpp.CppMessageTable(3))
    table.increment(_req(port_core, 1, name="late"))
    [(name, age, missing)] = table.pending_names_older_than(0.0)
    assert (name, missing) == ("late", [0, 2]) and age >= 0.0


def test_duplicate_name_in_flight_matches_the_reference():
    """The controller's enqueue refuses a name already in flight with the
    reference's text.  Neither controller is started, so the first entry
    stays in flight."""
    import numpy as np
    import torch
    from horovod_tpu import topology as ref_topology
    from horovod_tpu.parallel import mesh as ref_mesh
    from horovod_tpu_torch import topology as port_topology

    def entry(core, value):
        return core.TensorTableEntry(
            name="dup", request_type=core.RequestType.ALLREDUCE,
            per_rank=[value], dtype="float32", root_rank=-1, average=False,
            callback=lambda status, result: None)

    topo = ref_topology.resolve()
    ref = ref_core.Controller(topo, ref_mesh.build_ranks_mesh(topo))
    port = port_core.Controller(port_topology.resolve(), "cpu")
    try:
        texts = []
        for core, ctrl, value in (
                (ref_core, ref, [np.ones(2, np.float32)] * topo.local_size),
                (port_core, port, [torch.ones(2)])):
            e = entry(core, value[0])
            e.per_rank = value
            assert ctrl.enqueue(e).ok()
            texts.append(ctrl.enqueue(e).reason)
        assert texts[0] == texts[1]
        assert texts[1].startswith("Duplicate tensor name in queue: dup.")
    finally:
        ref.stop()
        port.stop()
