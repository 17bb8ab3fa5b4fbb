"""The port's eager gradient route, held against the JAX package's eager
branch, on two CPU processes each.

* The JAX side: a 2-process job of the JAX package (launched as
  ``tests/test_overlap.py`` launches its ``OVERLAP_2PROC_WORKER``, over the
  native control plane) runs ``hvd_jax.allreduce_gradients`` and
  ``hvd_jax.DistributedOptimizer(optax.sgd(lr, momentum))`` outside
  ``shard_map`` -- the eager branch -- for three compressions (``none``,
  ``fp16``, ``int8`` with ``error_feedback=True``), each with overlap off
  and on, over two steps.
* The torch side: a 2-process gloo job of the port
  (``_torch_eager_opt_worker.eager_opt_cases``) does the same with
  ``eager=True`` on the same per-rank leaves (``_torch_eager_opt_worker``:
  f32 of several sizes, one fp16, one 2-D leaf over the int8 floor), its
  gradients made by backward so that the overlap hooks issue the buckets.

Both jobs turn fusion off (``HOROVOD_TPU_FUSION_THRESHOLD=0``): the int8
wire quantizes the fused buffer, whose composition depends on which
requests a tick catches.  Reduced gradients, momentum traces, residuals
and parameters are bit for bit the JAX package's: two ranks make each sum
commutative, the host ring's wire codecs are the same native code in
both, and the learning rate is a power of two, so that ``p - lr * trace``
rounds once in both.  Two exceptions, both in the fp16 leaf: its momentum
and parameter from the second step on are within 2e-3 of the largest
element (optax multiplies the fp16 trace by 0.9 rounded to fp16), and
under int8 its reduced gradient is held against the JAX package's
compressor and a true average, since the JAX executor floor-divides a
bfloat16 sum (ROADMAP Queue 3).  Overlap on equals overlap off bit
for bit wherever the bucket holds one leaf, and for every leaf under
``none`` and ``fp16`` (whose wires act per element); under int8 a
bucket of several leaves is quantized on its own block grid, as in the
reference.

The same torch job checks the sparse route over two ranks (the
negotiated allgather with ragged row counts, the SPMD all-gather with
equal ones and its error on unequal ones, both optimizer branches against
densifying first), ``MetricAverageCallback`` over the plane, and a
parameter without a gradient under overlap.
"""

import fcntl
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from _torch_eager_opt_worker import (BUCKET_BYTES, CONFIGS, EQUAL_IDS,
                                     SPARSE_IDS, STEPS, eager_opt_cases,
                                     grads)
from _torch_eager_worker import free_port, spawn

TESTS = pathlib.Path(__file__).resolve().parent
N = 2
KNOBS = ("LOCAL_RANK", "HOST_FINGERPRINT", "WIRE_DTYPE", "CACHE_CAPACITY",
         "ALLREDUCE_ALGO", "NO_CPP", "FAULT", "TIMELINE", "INTEGRITY",
         "TRANSPORT", "INJIT_INT8_FLOOR", "INJIT_WIRE_DTYPE", "OVERLAP",
         "OBSERVE")
# The job's knobs, the same on both sides.
JOB_ENV = {"HOROVOD_TPU_CONTROL_TIMEOUT_S": "60",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2",
           "HOROVOD_TPU_FUSION_THRESHOLD": "0",
           "HOROVOD_TPU_BUCKET_BYTES": str(BUCKET_BYTES)}

JAX_WORKER = textwrap.dedent("""
    import os, pickle, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import optax
    sys.path.insert(0, sys.argv[1])
    from _torch_eager_opt_worker import (CONFIGS, LR, MOMENTUM, STEPS,
                                         grads, params0)
    import horovod_tpu as hvd
    import horovod_tpu.jax as hvd_jax
    from horovod_tpu.compression import Compression

    hvd.init()
    rank = hvd.rank()
    out = {}
    for comp, overlap in CONFIGS:
        c = getattr(Compression, comp)
        ef = comp == "int8"
        red = hvd_jax.allreduce_gradients(grads(rank, 0), compression=c,
                                          overlap=overlap)
        out[("grads", comp, overlap)] = {k: np.asarray(v)
                                         for k, v in red.items()}
        opt = hvd_jax.DistributedOptimizer(
            optax.sgd(LR, momentum=MOMENTUM), compression=c,
            error_feedback=ef, overlap=overlap)
        params = params0()
        state = opt.init(params)
        steps = []
        for s in range(STEPS):
            upd, state = opt.update(grads(rank, s), state, params)
            params = optax.apply_updates(params, upd)
            trace = (state.inner if ef else state)[0].trace
            steps.append({k: (np.asarray(params[k]), np.asarray(trace[k]),
                              np.asarray(state.residual[k]) if ef else None)
                          for k in params})
        out[("dopt", comp, overlap)] = steps
    with open(sys.argv[2] + f".{rank}", "wb") as f:
        pickle.dump(out, f)
    hvd.shutdown()
""")


def _once(request, tmp_path_factory, name, fn):
    """``fn()`` computed once per test session and shared, through a file,
    by every xdist worker that needs it."""
    root = tmp_path_factory.getbasetemp()
    if hasattr(request.config, "workerinput"):
        root = root.parent                 # the session's, not the worker's
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(fn()))
        return pickle.loads(path.read_bytes())


def _jax_job(tmp):
    """The JAX package's eager branch on two processes: {rank: results}."""
    port = free_port()
    procs = []
    for r in range(N):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("HOROVOD_TPU_")}
        env.update(JOB_ENV)
        env.update({
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{port}",
            "HOROVOD_TPU_PROCESS_INDEX": str(r),
            "HOROVOD_TPU_PROCESS_COUNT": str(N),
            "HOROVOD_TPU_SIZE": str(N), "HOROVOD_TPU_RANK": str(r),
            "HOROVOD_TPU_INJIT_PALLAS": "0",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_WORKER, str(TESTS), str(tmp / "jax")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out
    return {r: pickle.loads((tmp / f"jax.{r}").read_bytes())
            for r in range(N)}


def _torch_job():
    env = dict(JOB_ENV, HOROVOD_TPU_COORD_ADDR=f"127.0.0.1:{free_port()}")
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv("HOROVOD_TPU_" + knob, raising=False)
        got = spawn(eager_opt_cases, N, env, timeout=180)
    assert got["exit"] == [0] * N, got["exit"]
    return {r: {m[:3] if m[0] in ("grads", "dopt") else m[0]:
                m[3:] if m[0] in ("grads", "dopt") else m[1:]
                for m in got[r]} for r in range(N)}


@pytest.fixture(scope="module")
def jax_run(request, tmp_path_factory):
    def run():
        from horovod_tpu_torch import cpp_core
        assert cpp_core.available()
        return _jax_job(tmp_path_factory.mktemp("jax_eager"))
    return _once(request, tmp_path_factory, "jax_eager_opt", run)


@pytest.fixture(scope="module")
def torch_run(request, tmp_path_factory):
    def run():
        from horovod_tpu_torch import cpp_core
        assert cpp_core.available()
        return _torch_job()
    return _once(request, tmp_path_factory, "torch_eager_opt", run)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16 if a.dtype == np.float16 else np.uint32)


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(_bits(a), _bits(b))


def _int8_fp16_leaf(step):
    """The reduced fp16 leaf "d" under int8, from the JAX package's own
    compressor: each rank's ``Int8Compressor.compress`` (the int8 snap,
    in bf16), their bf16 sum, halved, cast back.  The JAX package's eager
    branch floor-divides that bf16 sum instead (its host executor averages
    only dtypes numpy calls floating, ``horovod_tpu/ops/executor.py:515``,
    and numpy does not call ml_dtypes' bfloat16 one): a reference fault,
    ROADMAP Queue 3."""
    import jax.numpy as jnp
    from horovod_tpu.compression import Int8Compressor
    parts = [Int8Compressor.compress(jnp.asarray(grads(r, step)["d"]))[0]
             for r in range(N)]
    return np.asarray(((parts[0] + parts[1]) / 2).astype(jnp.float16))


def _fp16_leaf(comp, step):
    """The reduced fp16 leaf "d": its fp16 sum over both ranks, halved."""
    if comp == "int8":
        return _int8_fp16_leaf(step)
    d0, d1 = (grads(r, step)["d"] for r in range(N))
    return (d0 + d1) / np.float16(2)


@pytest.mark.parametrize("comp,overlap", CONFIGS)
def test_allreduce_gradients_bit_identical_to_jax(torch_run, jax_run, comp,
                                                  overlap):
    for r in range(N):
        got = torch_run[r][("grads", comp, overlap)][0]
        want = jax_run[r][("grads", comp, overlap)]
        assert list(got) == list(want)
        for k in want:
            if comp == "int8" and k == "d":
                assert _same(got[k], _int8_fp16_leaf(0)), r
                assert not _same(got[k], want[k])
                continue
            assert _same(got[k], want[k]), (r, k)


@pytest.mark.parametrize("comp,overlap", CONFIGS)
def test_distributed_optimizer_bit_identical_to_jax(torch_run, jax_run,
                                                    comp, overlap):
    """Momentum trace, residual and parameter after each of the two steps;
    after step 1 the trace is the reduced gradient itself."""
    for r in range(N):
        got = torch_run[r][("dopt", comp, overlap)][0]
        want = jax_run[r][("dopt", comp, overlap)]
        for step in range(STEPS):
            for k, (wp, wtrace, wres) in want[step].items():
                p, trace, res, grad = got[step][k]
                if k == "d":
                    assert _same(grad, _fp16_leaf(comp, step)), (r, step)
                    if comp == "int8":
                        continue      # the reference's floor division
                    # fp16 momentum: torch multiplies by 0.9 in f32 and
                    # rounds once, optax by 0.9 rounded to fp16
                    # (0.89990234375): from the second step on, within
                    # 2e-3 of the largest element (an fp16 step is 1e-3).
                    for a, b in ((trace, wtrace), (p, wp)):
                        np.testing.assert_allclose(
                            a, b, rtol=0, atol=2e-3 * np.abs(b).max())
                    continue
                assert _same(trace, wtrace), (r, step, k, "trace")
                assert _same(p, wp), (r, step, k, "param")
                if step == 0:
                    assert _same(grad, wtrace), (r, k, "gradient")
                if comp == "int8" and k == "c":
                    assert _same(res, wres) and np.abs(res).max() > 0
                else:
                    # Not lossy: no residual slot; the reference's is zero.
                    assert res is None and (wres is None or not wres.any())


@pytest.mark.parametrize("comp", ["none", "fp16", "int8"])
def test_overlap_on_equals_off(torch_run, comp):
    """Overlap changes when a bucket is issued, not what it holds; under
    int8 the [a, b] bucket is quantized on its own grid."""
    for r in range(N):
        off = torch_run[r][("dopt", comp, False)][0]
        on = torch_run[r][("dopt", comp, True)][0]
        for step in range(STEPS):
            for k in off[step]:
                if comp == "int8" and k in ("a", "b"):
                    continue
                for x, y in zip(off[step][k], on[step][k]):
                    assert (x is None and y is None) or _same(x, y), \
                        (r, comp, step, k)


def test_hooks_issue_buckets_during_backward(torch_run):
    """From the second step on, the hooks issue every bucket before
    step() runs; the first step learns the plan and issues from step()."""
    for r in range(N):
        for comp in ("none", "fp16", "int8"):
            assert torch_run[r][("dopt", comp, True)][1] == [0, 3]
            assert torch_run[r][("dopt", comp, False)][1] == [0, 0]


def _dense_sum(ids_by_rank):
    """The dense gradient sum of the sparse model over both ranks."""
    out = np.zeros((12, 4), np.float32)
    for r, ids in ids_by_rank.items():
        w = (np.arange(len(ids) * 4).reshape(len(ids), 4) % 5 + r)
        np.add.at(out, ids, w.astype(np.float32))
    return out


def test_sparse_eager_ragged_allgather(torch_run):
    """``allreduce_eager`` gathers each rank's rows in rank order (ragged
    counts, duplicates kept), values averaged; densified, the sum of the
    dense gradients over 2 (exact: integer rows)."""
    want_idx = np.concatenate([SPARSE_IDS[0], SPARSE_IDS[1]])
    for r in range(N):
        values, indices = torch_run[r]["sparse_eager"]
        np.testing.assert_array_equal(indices, want_idx)
        dense = np.zeros((12, 4), np.float32)
        np.add.at(dense, indices, values)
        np.testing.assert_array_equal(dense, _dense_sum(SPARSE_IDS) / 2)


def test_sparse_spmd_matches_jax_all_gather(torch_run):
    """The SPMD branch with equal row counts against the JAX package's
    ``sparse.allreduce`` (tiled ``lax.all_gather``) on a 2-device mesh fed
    the same per-rank slices: bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu import sparse as jsparse
    vals = np.stack([torch_run[r]["sparse_spmd"][0] for r in range(N)])
    idx = np.stack([torch_run[r]["sparse_spmd"][1] for r in range(N)])
    mesh = Mesh(np.array(jax.devices()[:N]), ("ranks",))

    def body(v, i):
        out = jsparse.allreduce(jsparse.IndexedSlices(v[0], i[0], (12, 4)))
        return out.values, out.indices

    wv, wi = jax.jit(jax.shard_map(body, mesh=mesh,
                                   in_specs=(P("ranks"), P("ranks")),
                                   out_specs=(P(), P()), check_vma=False))(
        jnp.asarray(vals), jnp.asarray(idx))
    for r in range(N):
        _, _, values, indices = torch_run[r]["sparse_spmd"]
        assert _same(values, np.asarray(wv))
        np.testing.assert_array_equal(indices, np.asarray(wi))


def test_sparse_spmd_unequal_rows_raise_on_every_rank(torch_run):
    msgs = [torch_run[r]["sparse_unequal"][0] for r in range(N)]
    assert msgs[0] == msgs[1]
    assert "same number of rows" in msgs[0] and "[3, 5]" in msgs[0]


def test_sparse_gradients_take_both_branches(torch_run):
    """Three SGD momentum steps of an ``nn.Embedding(sparse=True)`` on the
    eager branch (overlap off and on) and on the SPMD branch equal the
    same steps on densified gradients, bit for bit (integer rows)."""
    for r in range(N):
        f = torch_run[r]["sparse_opt"][0]
        for label in ("eager", "eager_overlap"):
            np.testing.assert_array_equal(f[label], f["dense"])
        np.testing.assert_array_equal(f["spmd"], f["spmd_dense"])
        np.testing.assert_array_equal(f["dense"], torch_run[1 - r][
            "sparse_opt"][0]["dense"])


def test_metric_average_callback_over_the_plane(torch_run):
    for r in range(N):
        logs = torch_run[r]["metric_average"][0]
        assert logs == {"loss": 1.5, "acc": 0.25, "count": 3.5,
                        "name": "not a metric"}


def test_broadcast_callback_over_gloo(torch_run):
    for r in range(N):
        params, lr = torch_run[r]["broadcast"]
        assert all(np.all(p == 1.0) for p in params)
        assert lr == 0.1


def test_parameter_without_gradient_contributes_zeros(torch_run):
    for r in range(N):
        unchanged, used = torch_run[r]["unused"]
        assert unchanged
        np.testing.assert_array_equal(used, torch_run[1 - r]["unused"][1])


# --------------------------------------------------------------------------
# One process, on the CPU.

@pytest.fixture()
def size1(monkeypatch):
    for knob in KNOBS + ("SIZE", "RANK", "COORD_ADDR", "LOCAL_SIZE",
                         "FUSION_THRESHOLD", "BUCKET_BYTES"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _train(opt, model, steps=3):
    losses = []
    x = torch.linspace(-1, 1, 64).reshape(2, 32)
    for _ in range(steps):
        opt.zero_grad()
        loss = model(x).pow(2).sum()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(32, 300), torch.nn.Tanh(),
                               torch.nn.Linear(300, 4))


@pytest.mark.parametrize("overlap", [False, True])
def test_size_one_eager_equals_the_plain_optimizer(size1, overlap):
    """At world size one the eager average divides by one and the buckets
    copy exactly: the same losses and parameters as the plain optimizer,
    bit for bit."""
    plain = _model()
    want = _train(torch.optim.SGD(plain.parameters(), lr=0.05,
                                  momentum=0.9), plain)
    model = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        eager=True, overlap=overlap)
    assert _train(opt, model) == want
    for a, b in zip(model.parameters(), plain.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [False, True])
def test_zero_grad_before_step_drops_the_reduction(size1, overlap):
    """A backward whose step never comes: ``zero_grad`` waits out what the
    hooks submitted, and the next step reuses the names."""
    model = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05), eager=True,
        overlap=overlap)
    _train(opt, model, steps=2)
    x = torch.ones(2, 32)
    model(x).sum().backward()
    assert (opt._reduction is not None) == overlap
    opt.zero_grad()
    assert opt._reduction is None
    before = [p.detach().clone() for p in model.parameters()]
    _train(opt, model, steps=1)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))


def test_size_one_overlap_records_metrics_and_observe(size1):
    from horovod_tpu_torch import observe
    observe.set_enabled(True)
    try:
        c0 = hvd.metrics()["counters"]
        model = _model()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05), eager=True,
            overlap=True)
        _train(opt, model, steps=3)
        snap = hvd.metrics()
        assert snap["counters"]["overlap.steps"] - c0.get(
            "overlap.steps", 0) == 3
        for name in ("overlap.hidden_seconds", "overlap.exposed_seconds",
                     "step.seconds", "step.compute_seconds"):
            assert snap["histograms"][name]["count"] >= 3, name
        view = hvd.observe()
        assert view["enabled"] and view["local"]
    finally:
        observe.set_enabled(False)


def test_eager_refuses_a_group():
    with pytest.raises(ValueError, match="SPMD branch"):
        hvd.DistributedOptimizer(torch.optim.SGD(_model().parameters(),
                                                 lr=0.1),
                                 eager=True, group=object())
    with pytest.raises(ValueError, match="SPMD branch"):
        hvd.allreduce_gradients([torch.ones(2)], eager=True, group=object())


def test_function_form_keeps_the_sparse_layout(size1):
    emb = torch.nn.Embedding(6, 3, sparse=True)
    emb(torch.tensor([1, 4, 4])).sum().backward()
    g = emb.weight.grad
    for eager in (False, True):
        out = hvd.allreduce_gradients({"w": g}, eager=eager)["w"]
        assert out.is_sparse
        assert torch.equal(out.to_dense(), g.to_dense())


def test_grads_of_step_zero_are_seeded_per_rank():
    a, b = grads(0, 0), grads(1, 0)
    assert all(not np.array_equal(a[k], b[k]) for k in a)
    assert a["d"].dtype == np.float16 and a["c"].nbytes >= 64 << 10
    assert EQUAL_IDS[0] != EQUAL_IDS[1]


# --------------------------------------------------------------------------
# The observatory against the JAX package's.

@pytest.fixture()
def observatories():
    """Both packages' observatories armed and zeroed for one test, then
    back to the dark default (each package loads its own native core)."""
    from horovod_tpu import cpp_core as jcpp
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu import observe as jobserve
    from horovod_tpu_torch import cpp_core as tcpp
    from horovod_tpu_torch import metrics as tmetrics
    from horovod_tpu_torch import observe as tobserve
    for obs, cpp, reg in ((jobserve, jcpp, jmetrics.registry),
                          (tobserve, tcpp, tmetrics.registry)):
        obs.set_enabled(True)
        cpp.observe_reset()
        reg.clear()
    yield jobserve, tobserve
    for obs, cpp, reg in ((jobserve, jcpp, jmetrics.registry),
                          (tobserve, tcpp, tmetrics.registry)):
        obs.set_enabled(False)
        cpp.observe_reset()
        reg.clear()


def test_observe_snapshot_as_the_reference(observatories):
    """After the same ``note_step`` calls, both snapshots have the same
    keys and local digest, and the registries the same ``step.*``
    histograms (exact: the same sums of the same floats)."""
    jobserve, tobserve = observatories
    for obs in (jobserve, tobserve):
        obs.note_step(0.25, 0.125, 0.0625, 0.03125, 0.03125)
        obs.note_step(0.5, 0.25, 0.125, 0.0625, 0.0625)
    want, got = jobserve.snapshot(), tobserve.snapshot()
    assert sorted(got) == sorted(want) and got["enabled"]
    assert got["local"] == want["local"] and got["local"]
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu_torch import metrics as tmetrics
    hist = {k: v for k, v in tmetrics.registry.snapshot()["histograms"]
            .items() if k.startswith("step.")}
    jhist = {k: v for k, v in jmetrics.registry.snapshot()["histograms"]
             .items() if k.startswith("step.")}
    assert hist == jhist and len(hist) == 5
    assert hist["step.seconds"]["count"] == 2
    assert tmetrics.registry.snapshot()["counters"]["step.count"] == 2


def test_observe_off_records_nothing(observatories):
    _, tobserve = observatories
    tobserve.set_enabled(False)
    tobserve.note_step(1.0)
    from horovod_tpu_torch import metrics as tmetrics
    assert "step.count" not in tmetrics.registry.snapshot()["counters"]
    assert not tobserve.enabled() and not hvd.observe()["enabled"]


def test_fleet_from_gauges_as_the_reference():
    from horovod_tpu import observe as jobserve
    from horovod_tpu_torch import observe as tobserve
    gauges = {"fleet.ranks": 2, "fleet.step_ewma_s#rank=0": 0.5,
              "fleet.step_ewma_s#rank=1": 0.75,
              "fleet.bandwidth_bps#rank=1,leg=shm": 1e9,
              "fleet.bad#rank=x": 1, "other.gauge": 3}
    assert tobserve.fleet_from_gauges(gauges) == \
        jobserve.fleet_from_gauges(gauges)
