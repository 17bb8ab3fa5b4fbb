"""The port's eager API at size 1: ``allreduce`` / ``allgather`` /
``broadcast``, their async forms with ``poll`` and ``synchronize``, the
response cache, the timeline, the metrics and the errors, on the CPU.

At size 1 every collective is local: an allreduce sums one contribution
(``x``) and averages it over one rank (floats divide and cast back,
integers floor-divide, as ``horovod_tpu/ops/executor.py:512-520``), as the
JAX package's executor does for one rank.
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.ops import eager

DTYPES = [torch.uint8, torch.int8, torch.int32, torch.int64, torch.float32,
          torch.float64, torch.bfloat16, torch.float16]


@pytest.fixture()
def size1(monkeypatch):
    """hvd.init() at size 1 on the CPU, with no launcher or eager knob in
    the environment; shut down after the test."""
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "TIMELINE", "WIRE_DTYPE", "FUSION_THRESHOLD",
                 "CACHE_CAPACITY", "ALLREDUCE_ALGO", "FAULT"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _rand(dtype, dim, seed=1234):
    gen = torch.Generator().manual_seed(seed)
    shape = (17,) * dim
    if dtype.is_floating_point:
        return (torch.rand(shape, generator=gen) * 200 - 100).to(dtype)
    low = 0 if dtype == torch.uint8 else -100
    return torch.randint(low, 100, shape, generator=gen).to(dtype)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_allreduce_sum_and_average_at_size_1(size1, dtype, dim):
    x = _rand(dtype, dim)
    out = hvd.allreduce(x, average=False, name=f"ar.{dtype}.{dim}")
    assert out.dtype == dtype and out.device == x.device
    assert torch.equal(out, x)
    assert out.data_ptr() != x.data_ptr()
    avg = hvd.allreduce(x, average=True, name=f"avg.{dtype}.{dim}")
    assert avg.dtype == dtype and torch.equal(avg, x)


def test_async_burst_poll_synchronize_and_fusion(size1):
    """50 outstanding handles, then poll and synchronize (the reference's
    async-fused pattern): each result is its own tensor, and the ticks
    fuse them into fewer allreduce responses than tensors."""
    before = port_metrics.registry.snapshot()["counters"].get(
        "controller.ops#type=allreduce", 0)
    tensors = [torch.full((7, 3), float(i)) for i in range(50)]
    handles = [hvd.allreduce_async(t, average=False, name=f"fused.{i}")
               for i, t in enumerate(tensors)]
    for h, t in zip(handles, tensors):
        while not hvd.poll(h):
            pass
        assert torch.equal(hvd.synchronize(h), t)
    ops = port_metrics.registry.snapshot()["counters"][
        "controller.ops#type=allreduce"] - before
    assert 1 <= ops <= 50


def test_mixed_average_flags_share_a_buffer(size1):
    hs = [hvd.allreduce_async(torch.tensor([3, 4]), average=bool(i % 2),
                              name=f"mix.{i}") for i in range(4)]
    for h in hs:
        assert torch.equal(hvd.synchronize(h), torch.tensor([3, 4]))


def test_allgather_and_broadcast_at_size_1(size1):
    x = torch.arange(12.).reshape(4, 3)
    assert torch.equal(hvd.allgather(x, name="ag"), x)
    assert torch.equal(hvd.broadcast(x, 0, name="bc"), x)
    assert torch.equal(hvd.broadcast(torch.tensor(7.0), 0, name="bc.0d"),
                       torch.tensor(7.0))
    with pytest.raises(hvd.CollectiveError, match="rank-zero tensor"):
        hvd.allgather(torch.tensor(1.0), name="ag.0d")
    with pytest.raises(hvd.CollectiveError, match="root rank 1"):
        hvd.broadcast(x, 1, name="bc.bad")


def test_per_rank_holds_one_value(size1):
    x = torch.ones(3)
    assert torch.equal(hvd.allreduce(hvd.PerRank([x]), average=False,
                                     name="pr"), x)
    assert torch.equal(hvd.allreduce(hvd.scatter_ranks(x[None]),
                                     average=False, name="sr"), x)
    with pytest.raises(ValueError, match="one rank per process, got 2"):
        hvd.allreduce(hvd.PerRank([x, x]), name="pr.2")


def test_numpy_input_becomes_a_host_tensor(size1):
    out = hvd.allreduce(np.arange(4, dtype=np.int32), average=False,
                        name="np")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    assert out.tolist() == [0, 1, 2, 3]


def test_response_cache_hits_on_a_repeated_burst(size1):
    before = port_metrics.registry.snapshot()["counters"].get(
        "control.cache_hits", 0)
    for _ in range(5):
        for h in [hvd.allreduce_async(torch.ones(4), name=f"c.{j}")
                  for j in range(4)]:
            hvd.synchronize(h)
    counters = hvd.metrics()["counters"]
    assert counters["control.cache_hits"] > before
    assert "controller.handle_wait_seconds" in hvd.metrics()["histograms"]
    text = port_metrics.prometheus_text()
    assert "htpu_control_cache_hits" in text


def test_metrics_module_is_callable(size1):
    snap = hvd.metrics()
    assert set(snap) >= {"counters", "gauges", "histograms", "ts", "rank"}
    assert snap["rank"] == 0
    assert hvd.metrics.registry is port_metrics.registry


def test_timeline_at_size_1_parses(monkeypatch, tmp_path):
    path = tmp_path / "trace.json"
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_TIMELINE", str(path))
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        for i in range(2):
            hvd.allreduce(torch.ones(8), name=f"tl.{i}")
    finally:
        hvd.shutdown()
    events = json.loads(path.read_text())
    pids = {e["args"]["name"]: e["pid"] for e in events
            if e.get("name") == "process_name"}
    for i in range(2):
        names = [e.get("name") for e in events
                 if e.get("pid") == pids[f"tl.{i}"]]
        assert "NEGOTIATE_ALLREDUCE" in names and "QUEUE" in names, names
    assert events[0]["name"] == "trace_t0"


def test_basics_queries_at_size_1(size1):
    assert (hvd.process_index(), hvd.process_count()) == (0, 1)
    assert hvd.mpi_threads_supported()
    assert hvd.wire_dtype() == ""
    assert hvd.controller() is basics._state.controller
    assert hvd.controller().mesh_async_hazard() == 0


@pytest.mark.parametrize("query", [hvd.controller, hvd.mpi_threads_supported,
                                   hvd.process_index, hvd.process_count])
def test_queries_raise_before_init(query):
    hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError):
        query()


def test_shutdown_fails_what_is_in_flight(size1):
    """Entries still in flight at shutdown complete with the reference's
    shut-down text (``operations.cc:258-263``); later calls fail fast."""
    from horovod_tpu_torch.core import SHUT_DOWN_ERROR, Controller
    from horovod_tpu_torch.topology import resolve
    ctrl = Controller(resolve(), "cpu")    # never started: nothing ticks
    got = []
    entry = eager.TensorTableEntry(
        name="late", request_type=eager.RequestType.ALLREDUCE,
        per_rank=[torch.ones(2)], dtype="float32", root_rank=-1,
        average=False, callback=lambda s, r: got.append(s))
    assert ctrl.enqueue(entry).ok()
    ctrl.stop()
    assert got == [SHUT_DOWN_ERROR]
    assert ctrl.enqueue(entry) == SHUT_DOWN_ERROR


def test_size_1_starts_its_loop_at_the_first_enqueue(size1):
    """A job of one process runs no controller thread until its first
    eager collective, then one, until shutdown."""
    ctrl = hvd.controller()
    assert ctrl._thread is None
    assert hvd.allreduce(torch.ones(3), average=False).tolist() == [1.0] * 3
    thread = ctrl._thread
    assert thread is not None and thread.is_alive()
    hvd.allreduce(torch.ones(3))
    assert ctrl._thread is thread
    hvd.shutdown()
    assert not thread.is_alive()


@pytest.mark.parametrize("fault", ["no_sources", "build_fails"])
def test_native_core_build_failure_takes_the_python_path(monkeypatch, fault):
    """Without a library built from this tree's ``cpp/``, ``load()`` warns
    and returns None (the pure-Python control path), even where a library
    from another build lies in ``lib/``; the controller then negotiates in
    Python."""
    import subprocess
    from horovod_tpu_torch import core
    from horovod_tpu_torch import cpp_core
    from horovod_tpu_torch.topology import resolve
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "NO_CPP"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    monkeypatch.setattr(cpp_core, "_lib", None)
    if fault == "no_sources":
        monkeypatch.setattr(cpp_core, "_CPP_DIR", "/nonexistent/cpp")
        match = "sources"
    else:
        def make():
            raise subprocess.CalledProcessError(2, "make", stderr=b"boom")
        monkeypatch.setattr(cpp_core, "_make", make)
        match = "build failed"
    with pytest.warns(RuntimeWarning, match=match):
        assert cpp_core.load() is None
    ctrl = core.Controller(resolve(), "cpu")
    assert not ctrl._use_cpp
    ctrl.stop()
    # The controller made outside init seeded the process-set registry;
    # drop it, as shutdown does, so a later init re-seeds it.
    from horovod_tpu_torch import process_set
    process_set.reset()


def test_a_library_missing_a_symbol_fails_at_load(monkeypatch):
    """Every symbol the port binds is configured without a guard: a
    library that lacks one raises at load instead of half-loading."""
    import ctypes.util
    from horovod_tpu_torch import cpp_core
    monkeypatch.delenv("HOROVOD_TPU_NO_CPP", raising=False)
    monkeypatch.setattr(cpp_core, "_lib", None)
    monkeypatch.setattr(cpp_core, "_make", lambda: None)
    monkeypatch.setattr(cpp_core, "_LIB_PATH", ctypes.util.find_library("c"))
    with pytest.raises(AttributeError, match="htpu_"):
        cpp_core.load()
    assert cpp_core._lib is None


def test_synchronize_timeout_abandons_the_handle(size1):
    hm = hvd.controller().handle_manager
    h = hm.allocate(name="never")
    with pytest.raises(TimeoutError):
        hvd.synchronize(h, timeout=0.01)
    with pytest.raises(ValueError, match="unknown handle"):
        hvd.poll(h)


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_TPU_PROCESS_SETS", "a:0")])
def test_unported_modes_raise_at_init(monkeypatch, knob, value):
    """The process-set spec, once refused at init, now registers its
    sets there as the reference's does: a job of one process initializes
    with set ``a`` over rank 0 (id 1), whose collectives run, and
    shutdown drops the registry."""
    for var in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE"):
        monkeypatch.delenv("HOROVOD_TPU_" + var, raising=False)
    monkeypatch.setenv(knob, value)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        ps = hvd.process_set_by_name("a")
        assert (ps.id, ps.ranks, ps.rank()) == (1, (0,), 0)
        out = hvd.allreduce(torch.arange(3), name="spec.a", process_set=ps)
        assert torch.equal(out, torch.arange(3))
    finally:
        hvd.shutdown()
    monkeypatch.delenv(knob)
    assert hvd.process_set_by_name("a") is None


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_TPU_EVICT_THRESHOLD", "0.5"),
    ("HOROVOD_TPU_AUTOSCALE", "tick:5=2"),
    ("HOROVOD_TPU_AUTOSCALE_FILE", "target.txt")])
def test_fleet_knobs_arm_the_policy_at_init(monkeypatch, tmp_path, knob,
                                            value):
    """The fleet policy's eviction and autoscaling knobs, once refused at
    init, now arm the policy as the reference's do: a job of one process
    initializes, and the policy the native coordinator builds from the
    same environment (and its Python twin) is armed exactly as the JAX
    package's (eviction, autoscaling, re-rank, the standing target)."""
    from horovod_tpu import policy as ref_policy
    from horovod_tpu_torch import cpp_core, policy
    for var in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                "ELASTIC", "STANDBY", "EVICT_THRESHOLD", "AUTOSCALE",
                "AUTOSCALE_FILE", "POLICY_RERANK", "PRECISION"):
        monkeypatch.delenv("HOROVOD_TPU_" + var, raising=False)
    if knob == "HOROVOD_TPU_AUTOSCALE_FILE":
        (tmp_path / value).write_text("3\n")
        value = str(tmp_path / value)
    monkeypatch.setenv(knob, value)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        assert hvd.is_initialized() and hvd.size() == 1

        def arming(pol):
            return (pol.evict_enabled(), pol.autoscale_enabled(),
                    pol.active(), pol.rerank_enabled(),
                    pol.autoscale_target(10))
        got, want = arming(policy.FleetPolicy()), arming(
            ref_policy.FleetPolicy())
        assert got == want and got[2] and got[3]
        native = cpp_core.NativeFleetPolicy()
        assert native.active() and native.autoscale_target(10) == got[4]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("knob", ["HOROVOD_TPU_ELASTIC",
                                  "HOROVOD_TPU_STANDBY"])
def test_elastic_knobs_at_init(monkeypatch, knob):
    """The elastic knobs, once refused at init, now do what the
    reference's do for the same environment: a job of one process
    initializes, and ``elastic``'s queries (mode, standby, shrink floor,
    generation -1 without a control plane) equal the JAX package's."""
    import horovod_tpu as ref
    from horovod_tpu import elastic as ref_elastic
    from horovod_tpu_torch import elastic
    for var in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                "ELASTIC", "STANDBY", "ELASTIC_MIN_RANKS"):
        monkeypatch.delenv("HOROVOD_TPU_" + var, raising=False)
    monkeypatch.setenv(knob, "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    # The JAX package's runtime stays up across its own tests; one this
    # test starts under the elastic knob must not outlive it.
    ref_was_up = ref.is_initialized()
    try:
        ref.init()
        assert hvd.is_initialized() and hvd.size() == 1
        got = (elastic.enabled(), elastic.is_standby(), elastic.min_ranks(),
               elastic.generation())
        want = (ref_elastic.enabled(), ref_elastic.is_standby(),
                ref_elastic.min_ranks(), ref_elastic.generation())
        assert got == want
        assert got[0] == (knob == "HOROVOD_TPU_ELASTIC") and got[3] == -1
    finally:
        hvd.shutdown()
        if not ref_was_up:
            ref.shutdown()


def test_process_set_argument_raises(size1):
    """An unknown set raises ``resolve``'s ValueError, the reference's
    text, before anything is enqueued."""
    with pytest.raises(ValueError, match="Unknown process set 1: register"):
        hvd.allreduce(torch.ones(2), process_set=1)


def test_compression_picks_the_wire_dtype(monkeypatch):
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.core import RequestType
    monkeypatch.delenv("HOROVOD_TPU_WIRE_DTYPE", raising=False)
    pick = eager._wire_dtype_for
    assert pick(Compression.int8, torch.float32, RequestType.ALLREDUCE) \
        == "int8"
    assert pick("bfloat16", torch.float32, RequestType.ALLREDUCE) == "bf16"
    assert pick(Compression.bf16, torch.float16, RequestType.ALLREDUCE) == ""
    assert pick("int8", torch.float32, RequestType.ALLGATHER) == ""
    monkeypatch.setenv("HOROVOD_TPU_WIRE_DTYPE", "fp16")
    assert pick(None, torch.float32, RequestType.ALLREDUCE) == "fp16"
    assert pick(Compression.none, torch.float32, RequestType.ALLREDUCE) \
        == "fp16"
    with pytest.raises(ValueError, match="expected none"):
        pick("int4", torch.float32, RequestType.ALLREDUCE)
