"""The port's process sets against the JAX package's
(``horovod_tpu/process_set.py``, ``Controller._negotiate_sets`` /
``_execute_set``, ``CppProcessSetTable``).

* Exact equality with the reference: ``parse_spec`` on valid and malformed
  specs down to the texts; the registry's answers after one sequence of
  add, remove, reconfigure, increment and construct calls; the port's
  native table against the reference's; set-tagged request and response
  frames byte for byte; ``resolve``'s and ``add_process_set``'s errors;
  a reconfigure retiring that set's ``PER_SET_SERIES`` only.
* A job of one process: a one-rank set through the local loop's
  ``_negotiate_sets``, each collective equal to the reference's
  ``execute_host`` on the same contribution; a set with a rank outside
  the world refused.
* One job of four gloo processes on fake hosts A, A, B, B, spawned once
  (``_torch_pset_worker.tenant_cases``): ``tenantA:0,1`` and
  ``tenantB:2,3`` run every collective at once under the same tensor
  names, each result equal bit for bit to ``execute_host`` on the same
  contributions (integer averages floor-divide) with zero cross-talk; the
  set {1, 2} across the hosts is refused with ``PRECONDITION_ERROR``; a
  per-set reconfigure rebuilds that set's group among its remaining
  members and leaves the other sets and the world as they were.
"""

import struct
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import cpp_core as ref_cpp
from horovod_tpu import process_set as ref_ps
from horovod_tpu import wire as ref_wire
from horovod_tpu.core import RequestType as RefRequestType
from horovod_tpu_torch import cpp_core, wire
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch import process_set as psmod
from horovod_tpu_torch.core import RequestType, StatusType

from _torch_eager_worker import free_port, spawn
from _torch_pset_worker import (CASES, HOSTS, SETS, TENANTS, contribution,
                                tenant_cases)

# The eager plane's knobs, unset for the jobs unless a job sets them.
KNOBS = ("LOCAL_RANK", "HOST_FINGERPRINT", "WIRE_DTYPE", "FUSION_THRESHOLD",
         "CACHE_CAPACITY", "ALLREDUCE_ALGO", "NO_CPP", "FAULT", "TIMELINE",
         "COORD_ADDR", "PROCESS_SETS", "CONTROL_TOPO", "ELASTIC")


def test_top_level_names_are_the_reference_surface():
    import horovod_tpu as ref
    names = ("ProcessSet", "add_process_set", "remove_process_set",
             "process_set_by_name", "reconfigure_process_set",
             "ParameterPublisher")
    assert all(hasattr(ref, n) for n in names)
    assert [getattr(hvd, n).__module__ for n in names] == [
        "horovod_tpu_torch.process_set"] * 5 + ["horovod_tpu_torch.publish"]


# ------------------------------------------------------------ spec parsing

@pytest.mark.parametrize("spec", [
    "tenantA:0,1;tenantB:2,3", " a : 4 ; ", "", "x:3,1,2;;y:0"])
def test_parse_spec_valid(spec):
    assert psmod.parse_spec(spec) == ref_ps.parse_spec(spec)


@pytest.mark.parametrize("spec", [
    "noranks", ":0,1", "a:0,x", "a:-1", "a:", "ok:0;bad"])
def test_parse_spec_malformed_texts(spec):
    with pytest.raises(ValueError) as want:
        ref_ps.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        psmod.parse_spec(spec)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- registry

def _set_req(mod, rank, name="g", set_id=1, shape=(4,), dtype="float32",
             rtype=0, root=-1):
    return mod.Request(request_rank=rank,
                       request_type=mod.RequestType(rtype),
                       tensor_name=name, tensor_type=dtype,
                       tensor_shape=shape, device=rank, root_rank=root,
                       process_set=set_id)


def _resp(r):
    return (int(r.response_type), list(r.tensor_names), r.error_message,
            list(r.devices), list(r.tensor_sizes), r.wire_dtype, r.algo,
            r.process_set)


def _registry_trace(reg, mod):
    """One sequence of every registry call; the answers in order."""
    out = [reg.parse_spec("a:1,0;b:2,3"), reg.add("c", [5, 4]),
           reg.add("c", [6]), reg.add("d", [7, 7]), reg.add("e", []),
           reg.parse_spec("f:9;bad"), reg.count()]
    for sid in range(0, 7):
        out += [reg.size_of(sid), reg.generation(sid)]
        out += [reg.local_rank(sid, g) for g in range(10)]
    out += [reg.id_of(n) for n in ("a", "b", "c", "f", "zz")]
    out += [reg.reconfigure(3, 4), reg.reconfigure(3, 4),
            reg.reconfigure(99, 0), reg.get(3).ranks, reg.get(3).generation]
    out += [reg.remove(2), reg.remove(2), reg.count(), reg.add("b", [2]),
            [(p.id, p.name, p.ranks) for p in reg.all()]]
    # Negotiation in set 1 (members 0, 1): each kind, a mismatch, range
    # guards, and the quiesce.
    sid = reg.id_of("a")
    for name, rtype, shapes, dtypes, root in (
            ("g", 0, [(4,), (4,)], ["float32"] * 2, -1),
            ("ag", 1, [(2, 3), (1, 3)], ["float32"] * 2, -1),
            ("bc", 2, [(5,), (5,)], ["int64"] * 2, 1),
            ("bad", 0, [(4,), (4,)], ["float32", "int32"], -1)):
        for r in (0, 1):
            out.append(reg.increment(sid, _set_req(
                mod, r, name, sid, shapes[r], dtypes[r], rtype, root)))
        out.append(_resp(reg.construct_response(sid, name)))
    out += [reg.increment(sid, _set_req(mod, 2, "h", sid)),
            reg.increment(99, _set_req(mod, 0, "h", 99)),
            reg.increment(sid, _set_req(mod, 0, "q", sid))]
    reg.clear_negotiation_state()
    out += [reg.increment(sid, _set_req(mod, 1, "q", sid)),
            reg.increment(sid, _set_req(mod, 0, "q", sid))]
    with pytest.raises(KeyError):
        reg.construct_response(99, "g")
    return out


def test_registry_answers_equal_the_reference():
    import horovod_tpu.core as ref_core
    import horovod_tpu_torch.core as port_core
    got = _registry_trace(psmod.ProcessSetRegistry(4), port_core)
    want = _registry_trace(ref_ps.ProcessSetRegistry(4), ref_core)
    assert got == want


def test_native_table_equals_the_reference():
    """The port's ``CppProcessSetTable`` (its own build of ``cpp/``)
    against the reference's, on the same trace as the registries."""
    import horovod_tpu.core as ref_core
    import horovod_tpu_torch.core as port_core
    assert cpp_core.available()
    assert ref_cpp._process_sets_lib() is not None

    class Table:
        """The trace's registry interface over a native table."""

        def __init__(self, cls):
            self.t = cls(cache_capacity=4)

        def __getattr__(self, name):
            return getattr(self.t, name)

        def get(self, sid):
            return types.SimpleNamespace(
                ranks=tuple(g for g in range(10)
                            if self.t.local_rank(sid, g) >= 0),
                generation=self.t.generation(sid))

        def all(self):
            return [types.SimpleNamespace(id=i, name=n,
                                          ranks=self.get(i).ranks)
                    for n in ("a", "b", "c", "f")
                    for i in [self.t.id_of(n)] if i > 0]

        def clear_negotiation_state(self):
            pass   # the native table has no quiesce entry point

    port = Table(cpp_core.CppProcessSetTable)
    ref = Table(ref_cpp.CppProcessSetTable)
    try:
        assert (_registry_trace(port, port_core)
                == _registry_trace(ref, ref_core))
    finally:
        port.close()
        ref.close()


def test_reconfigure_retires_that_sets_series_only():
    reg = psmod.ProcessSetRegistry(4)
    a, b = reg.add("xa", [0, 2, 4]), reg.add("xb", [1, 3])
    for name in ("xa", "xb"):
        for prefix in psmod.PER_SET_SERIES:
            port_metrics.registry.set_gauge(
                f"{prefix}#process_set={name}", 1.0)
        port_metrics.registry.observe(
            f"control.tick_seconds#process_set={name}", 0.5)
        port_metrics.registry.inc(
            f"control.set_requests#process_set={name}", 3)
    assert psmod.PER_SET_SERIES == ref_ps.PER_SET_SERIES
    assert reg.reconfigure(a, 2) == 1
    snap = port_metrics.registry.snapshot()
    for prefix in psmod.PER_SET_SERIES:
        assert f"{prefix}#process_set=xb" in snap["gauges"]
        if prefix != "elastic.set_generation":
            assert f"{prefix}#process_set=xa" not in snap["gauges"]
    assert snap["gauges"]["elastic.set_generation#process_set=xa"] == 1
    assert "control.tick_seconds#process_set=xa" not in snap["histograms"]
    assert "control.tick_seconds#process_set=xb" in snap["histograms"]
    assert snap["counters"]["control.set_requests#process_set=xa"] == 3
    assert reg.get(b).generation == 0
    for name in ("xa", "xb"):
        psmod.retire_metrics(name)


# -------------------------------------------------------------------- wire

def _frames(core, w):
    reqs = [core.Request(request_rank=1, request_type=core.RequestType(k),
                         tensor_name=f"set/{k}", tensor_type="float32",
                         tensor_shape=(3, 5), root_rank=k - 2 if k else -1,
                         device=3, process_set=s)
            for k, s in ((0, 2), (1, 0), (2, 1))]
    resps = [core.Response(core.ResponseType.ALLREDUCE, ["g"],
                           devices=[0, 1], process_set=2),
             core.Response(core.ResponseType.ALLGATHER, ["ag"],
                           devices=[2, 3], tensor_sizes=[2, 1],
                           process_set=1),
             core.Response(core.ResponseType.BROADCAST, ["tip"],
                           devices=[0])]
    return (w.serialize_request_list(reqs[:1]),
            w.serialize_request_list(reqs),
            w.serialize_request_list(reqs[1:2]),
            w.serialize_response_list(resps),
            w.serialize_response_list(resps[2:]))


def test_set_tagged_frames_equal_the_reference():
    import horovod_tpu.core as ref_core
    import horovod_tpu_torch.core as port_core
    got, want = _frames(port_core, wire), _frames(ref_core, ref_wire)
    assert got == want
    assert got[0][0] & wire.FLAG_SET_EXT and got[3][0] & wire.FLAG_SET_EXT
    assert not got[2][0] & wire.FLAG_SET_EXT
    assert not got[4][0] & wire.FLAG_SET_EXT
    assert got[0].endswith(struct.pack("<i", 2))
    back, _, _ = wire.parse_request_list(got[1])
    assert [r.process_set for r in back] == [2, 0, 1]
    back, _, _ = wire.parse_response_list(got[3])
    assert [r.process_set for r in back] == [2, 1, 0]


# ------------------------------------------------------ one process, size 1

@pytest.fixture
def size1(monkeypatch):
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE") + KNOBS:
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _ref_entry(kind, per_rank, dtype, average=False, root=-1):
    return types.SimpleNamespace(
        request_type=RefRequestType[kind.upper()], per_rank=per_rank,
        dtype=dtype, average=average, root_rank=root)


def _bits_equal(got: np.ndarray, want: np.ndarray) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def test_resolve_and_add_process_set_errors_equal_the_reference(size1):
    ps = hvd.add_process_set([0])
    ref = ref_ps.add_process_set([0])
    try:
        assert ps.name == ref.name == "set_0"
        with pytest.raises(ValueError) as want:
            ref_ps.add_process_set([2], name=ref.name)
        with pytest.raises(ValueError) as got:
            hvd.add_process_set([2], name=ps.name)
        assert str(got.value) == str(want.value)
        for bad in ("never-registered", 99, 0, object()):
            with pytest.raises(ValueError) as want:
                ref_ps.resolve(bad)
            with pytest.raises(ValueError) as got:
                psmod.resolve(bad)
            assert str(got.value) == str(want.value)
        assert psmod.resolve(ps.name) is psmod.resolve(ps.id) is \
            psmod.resolve(ps)
        assert not hvd.remove_process_set("never-registered")
        assert hvd.process_set_by_name(ps.name) is ps
    finally:
        assert hvd.remove_process_set(ps) and ref_ps.remove_process_set(ref)
    assert hvd.process_set_by_name(ps.name) is None


def test_add_process_set_is_single_process_after_init(monkeypatch):
    """In a job of several processes (the reference's text)."""
    from horovod_tpu_torch import basics
    monkeypatch.setattr(basics._state, "initialized", True)
    monkeypatch.setattr(basics._state, "topology",
                        types.SimpleNamespace(process_count=2))
    with pytest.raises(RuntimeError, match="single-process only"):
        hvd.add_process_set([0, 1], name="late")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_solo_set_runs_through_the_local_loop(size1, case):
    """A one-rank set in a job of one process: the local loop's
    ``_negotiate_sets``, the result equal to ``execute_host`` on the same
    contribution, the per-set series recorded."""
    _, kind, dtype, average, root = next(c for c in CASES if c[0] == case)
    ps = hvd.add_process_set([0], name="solo")
    key = "control.set_requests#process_set=solo"
    before = hvd.metrics()["counters"].get(key, 0)
    try:
        x = contribution(0, 0, case)
        if kind == "broadcast":
            root = 0
            out = hvd.broadcast(torch.from_numpy(x), root, name=case,
                                process_set=ps)
        elif kind == "allreduce":
            out = hvd.allreduce(torch.from_numpy(x), average=average,
                                name=case, process_set="solo")
        else:
            out = hvd.allgather(torch.from_numpy(x), name=case,
                                process_set=ps.id)
        want = ref_ps.execute_host(_ref_entry(kind, [x], dtype, average,
                                              root), 1)
        assert _bits_equal(out.numpy(), np.asarray(want))
        snap = hvd.metrics()
        assert snap["counters"][key] == before + 1
        assert "control.tick_seconds#process_set=solo" in snap["histograms"]
    finally:
        hvd.remove_process_set(ps)


def test_set_outside_the_world_and_bad_root_are_refused(size1):
    ps = hvd.add_process_set([0, 1], name="pair")
    solo = hvd.add_process_set([0], name="one")
    try:
        hm = hvd.controller().handle_manager
        h = hvd.allreduce_async(torch.ones(2), name="p", process_set=ps)
        status, _ = hm.wait(h, 10)
        assert status.type == StatusType.PRECONDITION_ERROR
        assert status.reason.startswith(
            "process set 'pair' spans ranks [0, 1] on more than one host "
            "(rank 0 on ")
        assert "rank 1 outside this 1-rank world" in status.reason
        with pytest.raises(hvd.CollectiveError) as got:
            hvd.broadcast(torch.ones(2), 3, name="b", process_set=solo)
        with pytest.raises(ValueError) as want:
            ref_ps.execute_host(_ref_entry("broadcast", [np.ones(2)],
                                           "float32", root=3), 1)
        assert str(want.value) in str(got.value)
    finally:
        hvd.remove_process_set(ps)
        hvd.remove_process_set(solo)


# --------------------------------------------- four gloo processes, A A B B

@pytest.fixture(scope="module")
def tenant_job():
    assert cpp_core.available()      # built once, before the workers load it
    env = {"HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{free_port()}",
           "HOROVOD_TPU_CONTROL_TIMEOUT_S": "20",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2",
           "HOROVOD_TPU_PROCESS_SETS": SETS}
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv("HOROVOD_TPU_" + knob, raising=False)
        got = spawn(tenant_cases, len(HOSTS), env, fingerprints=HOSTS)
    assert got["exit"] == [0] * len(HOSTS)
    return {r: {m[0]: m[1:] for m in got[r]} for r in range(len(HOSTS))}


def _want(tenant: int, case: str) -> np.ndarray:
    _, kind, dtype, average, root = next(c for c in CASES if c[0] == case)
    per = [contribution(tenant, r, case) for r in range(2)]
    return np.asarray(ref_ps.execute_host(
        _ref_entry(kind, per, dtype, average, root), 2))


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_two_tenants_equal_execute_host(tenant_job, rank, case):
    """Both tenants, the same names, at once: each member's result is the
    reference's ``execute_host`` on its own tenant's contributions, bit
    for bit, before and after the per-set reconfigure of ``wide``."""
    name, local, before = tenant_job[rank]["tenant"]
    (after,) = tenant_job[rank]["tenant_after"]
    assert (name, local) == (TENANTS[rank // 2], rank % 2)
    want = _want(rank // 2, case)
    assert _bits_equal(before[case], want)
    assert _bits_equal(after[case], want)
    if case == "iavg":      # floor division, not the world's float mean
        assert want.dtype == np.int32 and (want * 2 != sum(
            contribution(rank // 2, r, case) for r in range(2))).any()


@pytest.mark.parametrize("rank", range(4))
def test_world_and_counters_are_per_tenant(tenant_job, rank):
    got = tenant_job[rank]
    np.testing.assert_array_equal(got["world"][0], np.full(3, 6.0))
    np.testing.assert_array_equal(got["world_after"][0], np.full(3, 6.0))
    (counters,) = got["counters"]
    mine, other = TENANTS[rank // 2], TENANTS[1 - rank // 2]
    assert counters[f"control.set_requests#process_set={mine}"] == len(CASES)
    assert f"control.set_requests#process_set={other}" not in counters


@pytest.mark.parametrize("rank", range(4))
def test_a_set_across_hosts_is_refused(tenant_job, rank):
    code, reason = tenant_job[rank]["cross"]
    assert code == StatusType.PRECONDITION_ERROR
    assert reason == (
        "process set 'cross' spans ranks [1, 2] on more than one host "
        "(rank 1 on 'A', rank 2 on 'B'): every member rank of a set must "
        "live on one host -- the set-scoped eager data plane is host-local "
        "(see docs/process-sets.md).")


@pytest.mark.parametrize("rank", range(4))
def test_per_set_reconfigure_leaves_the_rest(tenant_job, rank):
    gen, ranks, has_group, got, tenant_gens = \
        tenant_job[rank]["reconfigured"]
    assert (gen, ranks, tenant_gens) == (1, (0, 1, 2), [0, 0])
    assert has_group == (rank < 3)
    if rank < 3:
        np.testing.assert_array_equal(got, np.full(2, 6.0))
    if rank == 0:
        code, reason = tenant_job[0]["wide"]
        assert code == StatusType.PRECONDITION_ERROR
        assert reason.startswith("process set 'wide' spans ranks [0, 1, 2]")
