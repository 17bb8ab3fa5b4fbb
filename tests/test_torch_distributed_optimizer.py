"""The port's int8 ring, ``DistributedOptimizer``, ``reduce_gradients``
under int8 and the broadcasts, held against the JAX package.

* Ring: the lockstep ring (n ranks in one process) against the JAX
  package's ``quantized_ring_allreduce`` on a CPU mesh of n devices with
  the jnp codec, bit-identical; the ``torch.distributed`` ring in a
  2-process gloo group against the lockstep ring, bit-identical.
* ``DistributedOptimizer(SGD momentum, int8, error_feedback=True)`` given
  the same gradients as the JAX package's ``DistributedOptimizer(optax.sgd)``
  in ``shard_map`` on 1- and 2-device meshes: over 2 steps the momentum
  trace (optax's update is ``-lr * trace``) and the residuals are
  bit-identical, the parameters equal to one ulp of the largest
  parameter (PyTorch applies ``p - lr * buf`` as one fused multiply-add,
  optax as a product and a sum: one rounding apart).  Overlap on and off are bit-identical.
* A small TransformerLM trained 2 steps through it against JAX's
  ``make_train_step`` over the same wrapper, within the tolerances of
  ``tests/test_torch_train_step.py`` (losses rtol 1e-5, params atol 1e-5),
  and resumed from the JAX package's mid-run state.
* ``reduce_gradients`` under int8 sends the 2-D leaf over the ring and
  keeps the 1-D leaf raw; ``broadcast_parameters`` and
  ``broadcast_optimizer_state`` over 2-process gloo.

The JAX side runs its ring with the jnp codec (``HOROVOD_TPU_INJIT_PALLAS=0``:
the Pallas codec fails under ``shard_map``'s vma check on this jax) and is
compiled without XLA's fusion pass: XLA's CPU compiler always contracts a
multiply and an add inside one fusion into a fused multiply-add, which
turns the ring's "dequantize, then add" (and the residual's
"snap, then subtract") into one rounding where the JAX source, the C++
codec and the port have two.
"""

import fcntl
import pickle
import queue
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu  # noqa: F401  (jax.shard_map on this jax)
import horovod_tpu_torch as hvd
from horovod_tpu import jax as hvd_jax
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu.jax.spmd import make_train_step as jax_make_train_step
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.ops import quantized_collectives as jqc
from horovod_tpu.ops.losses import fused_softmax_xent as jax_xent
from horovod_tpu_torch import weights
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.models import TransformerLM
from horovod_tpu_torch.ops import quantized_collectives as tqc
from horovod_tpu_torch.ops.losses import fused_softmax_xent
from horovod_tpu_torch.spmd import make_train_step

from _torch_dopt_worker import (LR, MOMENTUM, _W, _Leaves, _gloo_worker,
                                _grad_steps, _params0, _rg_inputs,
                                _ring_inputs, _torch_dopt)

UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


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


def _jax_ring(x, average):
    n = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("ranks",))
    f = jax.jit(jax.shard_map(
        lambda xs: jqc.quantized_ring_allreduce(xs[0], "ranks",
                                                average=average),
        mesh=mesh, in_specs=P("ranks"), out_specs=P()))
    return np.asarray(f.lower(x).compile(compiler_options=UNFUSED)(x))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("average", [True, False])
def test_lockstep_ring_bit_identical_to_jax(monkeypatch, n, average):
    monkeypatch.setenv("HOROVOD_TPU_INJIT_PALLAS", "0")
    x = _ring_inputs(n)
    want = _jax_ring(x, average)
    got = tqc.lockstep_ring_allreduce(
        [torch.from_numpy(x[r]) for r in range(n)], average=average)
    for r in range(n):
        assert got[r].shape == (48, 128) and got[r].dtype == torch.float32
        assert np.array_equal(_bits(got[r].numpy()), _bits(want))
    mean = x.mean(0) if average else x.sum(0)
    assert not np.array_equal(got[0].numpy(), mean)
    np.testing.assert_allclose(got[0].numpy(), mean, rtol=0.05,
                               atol=0.05 * np.abs(mean).max())


def test_ring_keeps_dtype_tail_and_identity():
    xs = [torch.randn(3, 1000, dtype=torch.float64).to(torch.bfloat16)
          for _ in range(3)]
    out = tqc.lockstep_ring_allreduce(xs)
    assert out[0].dtype == torch.bfloat16 and out[0].shape == (3, 1000)
    x = torch.randn(5, 7)
    assert tqc.lockstep_ring_allreduce([x])[0] is x
    assert tqc.quantized_ring_allreduce(x) is x      # no process group


# --------------------------------------------------------------------------
# DistributedOptimizer against the JAX package, given gradients.

def _jax_dopt(n):
    """Two steps of the JAX package's wrapper in shard_map over n devices;
    returns per step the per-rank (params, trace, residual) as numpy."""
    tx = hvd_jax.DistributedOptimizer(
        optax.sgd(LR, momentum=MOMENTUM), axis_name="ranks",
        compression=JCompression.int8, error_feedback=True)
    mesh = Mesh(np.array(jax.devices()[:n]), ("ranks",))

    def body(params, state, grads):
        params, state, grads = jax.tree.map(lambda a: a[0],
                                            (params, state, grads))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        return jax.tree.map(lambda a: a[None], (params, state))

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("ranks"),
                              out_specs=P("ranks")))
    stack = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.stack([jnp.asarray(a)] * n), t)
    params = stack(_params0())
    state = stack(tx.init(_params0()))
    out = []
    compiled = None
    for grads in _grad_steps(n):
        g = jax.tree.map(lambda *a: jnp.stack(a), *grads)
        if compiled is None:
            compiled = f.lower(params, state, g).compile(
                compiler_options=UNFUSED)
        params, state = compiled(params, state, g)
        trace = state.inner[0].trace
        out.append([{k: (np.asarray(params[k][r]), np.asarray(trace[k][r]),
                         np.asarray(state.residual[k][r]))
                     for k in ("w", "s", "b")} for r in range(n)])
    return out


def _assert_matches_jax(got, want):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("w", "s", "b"):
            p, trace, res = g[k]
            wp, wtrace, wres = w[k]
            assert np.array_equal(_bits(trace), _bits(wtrace)), (step, k)
            # One rounding apart: at most an ulp of the largest value.
            np.testing.assert_allclose(
                p, wp, rtol=0, atol=2.0 ** -23 * np.abs(wp).max(),
                err_msg=f"step {step} {k}")
            if k == "w":
                assert np.array_equal(_bits(res), _bits(wres)), (step, k)
                assert np.abs(res).max() > 0
            else:
                # Not lossy: no residual slot; the reference's stays zero.
                assert res is None and not np.any(wres)


def _jax_dopt_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TPU_INJIT_PALLAS", "0")
    mp.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    try:
        return {n: _jax_dopt(n) for n in (1, 2)}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_dopt_runs(request, tmp_path_factory):
    return _once(request, tmp_path_factory, "jax_dopt", _jax_dopt_runs)


@pytest.mark.parametrize("overlap", [False, True])
def test_distributed_optimizer_bit_identical_to_jax_one_rank(
        jax_dopt_runs, monkeypatch, overlap):
    monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    got = _torch_dopt(0, 1, overlap)
    _assert_matches_jax(got, [step[0] for step in jax_dopt_runs[1]])


def test_overlap_on_and_off_bit_identical():
    off = _torch_dopt(0, 1, False)
    on = _torch_dopt(0, 1, True)
    for a, b in zip(off, on):
        for k in a:
            for x, y in zip(a[k], b[k]):
                assert (x is None and y is None) or \
                    x.tobytes() == y.tobytes()


def test_error_feedback_state_and_errors():
    model = _Leaves()
    sgd = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    opt = hvd.DistributedOptimizer(sgd, compression=Compression.int8,
                                   error_feedback=True, overlap=True)
    assert set(k for p in model.parameters()
               for k in opt.state.get(p, {})) == {"residual"}
    res = opt.state[model.w]["residual"]
    assert res.dtype == torch.float32 and not res.any()
    assert "residual" in str(opt.state_dict()["state"])
    assert opt.param_groups is sgd.param_groups
    (model.w.sum() + model.b.sum()).backward()
    with pytest.raises(RuntimeError, match="accumulated twice"):
        model.w.sum().backward()
    # "auto" is accepted, and error feedback keeps no residual under it.
    auto = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR), compression="auto",
        error_feedback=True)
    assert auto.compression == "auto" and not auto.state
    with pytest.raises(ValueError, match="expected none"):
        hvd.DistributedOptimizer(sgd, compression="int4")


def test_adam_state_initializes_beside_the_residual():
    """The residual is held out while the wrapped optimizer steps, so an
    optimizer that initializes an empty state still does."""
    model = _Leaves()
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()),
                                   compression="int8", error_feedback=True)
    for _ in range(2):
        opt.zero_grad()
        (model.w ** 2).sum().backward()
        opt.step()
    st = opt.state[model.w]
    assert set(st) == {"step", "exp_avg", "exp_avg_sq", "residual"}
    assert float(st["step"]) == 2.0


def test_lr_scheduler_steps_the_wrapper():
    """The wrapper is an instance of the wrapped optimizer's class, so a
    torch LR scheduler takes it, and its step still reduces."""
    model = _Leaves()
    sgd = torch.optim.SGD(model.parameters(), lr=1.0)
    opt = hvd.DistributedOptimizer(sgd, compression="int8",
                                   error_feedback=True)
    assert isinstance(opt, torch.optim.SGD)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    lrs = []
    for _ in range(3):
        opt.zero_grad()
        model.w.sum().backward()
        opt.step()
        sched.step()
        lrs.append(opt.param_groups[0]["lr"])
    assert lrs == [0.5, 0.25, 0.125]
    assert opt.state[model.w]["residual"].dtype == torch.float32


def test_load_state_dict_keeps_the_residual_f32():
    """``Optimizer.load_state_dict`` casts state to the parameter's dtype;
    the wrapper keeps the residual f32, bit for bit, beside a bf16
    parameter."""
    torch.manual_seed(3)

    def make():
        w = torch.nn.Parameter(torch.randn(64, 256).bfloat16())
        return w, hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.1, momentum=MOMENTUM),
            compression="int8", error_feedback=True)

    w, opt = make()
    w.grad = torch.randn(64, 256).bfloat16() / 3
    opt.step()
    res = opt.state[w]["residual"]
    assert res.dtype == torch.float32 and res.any()
    w2, opt2 = make()
    opt2.load_state_dict(opt.state_dict())
    assert opt2.state[w2]["residual"].dtype == torch.float32
    assert torch.equal(opt2.state[w2]["residual"], res)
    assert opt2.state[w2]["momentum_buffer"].dtype == torch.bfloat16


def test_sparse_gradients():
    """A sparse gradient takes the sparse allgather route (the identity at
    world size one) and reaches the update densified; ``sparse_as_dense``
    densifies first."""
    emb = torch.nn.Embedding(10, 4, sparse=True)
    idx = torch.tensor([1, 3, 3])
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=1.0))
    before = emb.weight.detach().clone()
    emb(idx).sum().backward()
    want = emb.weight.grad.to_dense()
    opt.step()
    assert not emb.weight.grad.is_sparse
    assert torch.equal(emb.weight.grad, want)
    assert torch.equal(emb.weight.detach(), before - want)
    idx = torch.tensor([1, 3])
    dense = hvd.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=1.0), sparse_as_dense=True)
    before = emb.weight.detach().clone()
    dense.zero_grad()
    emb(idx).sum().backward()
    dense.step()
    moved = (emb.weight.detach() != before).any(dim=1)
    assert moved.tolist() == [i in (1, 3) for i in range(10)]


def test_allreduce_gradients_single_process_is_identity_or_cast():
    tree = {"a": torch.randn(4, 300), "b": [torch.randn(7)]}
    out = hvd.allreduce_gradients(tree)
    assert out["a"] is tree["a"] and out["b"][0] is tree["b"][0]
    out = hvd.allreduce_gradients(tree, compression="bf16")
    assert torch.equal(out["a"], tree["a"].bfloat16().float())
    assert hvd.allreduce_(tree)["b"][0] is tree["b"][0]


# --------------------------------------------------------------------------
# A small TransformerLM through the wrapper, against JAX.

CFG = dict(vocab=512, dim=128, depth=1, num_heads=2, max_len=64,
           attn="flash")
LM_LR = 0.01


def _tokens():
    return np.random.default_rng(0).integers(
        0, CFG["vocab"], (2, 65)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_lm_run(request, tmp_path_factory):
    return _once(request, tmp_path_factory, "jax_lm", _jax_lm_run)


def _jax_lm_run():
    """Two JAX steps through DistributedOptimizer(optax.sgd, int8, error
    feedback) on a one-device mesh: initial params, the state after step 1
    and after step 2, the losses."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TPU_INJIT_PALLAS", "0")
    mp.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    try:
        jmodel = JaxLM(**CFG, dtype=jnp.float32, head_dtype=jnp.float32,
                       ln_dtype=jnp.float32)
        tokens = _tokens()
        params = jmodel.init(jax.random.PRNGKey(0),
                             jnp.asarray(tokens[:, :-1]))["params"]
        np_params = jax.tree.map(np.asarray, params)

        def jloss(p, aux, batch):
            h = jmodel.apply({"params": p}, batch[:, :-1],
                             return_hidden=True)
            return jax_xent(h.reshape(-1, CFG["dim"]), p["head"]["kernel"],
                            batch[:, 1:].reshape(-1)).mean(), aux

        tx = hvd_jax.DistributedOptimizer(
            optax.sgd(LM_LR, momentum=MOMENTUM), compression="int8",
            error_feedback=True)
        mesh = Mesh(np.array(jax.devices()[:1]), ("ranks",))
        jstep = jax_make_train_step(jloss, tx, mesh)
        p = jax.tree.map(jnp.array, np_params)
        state = tx.init(p)
        snaps, losses = [], []
        for _ in range(2):
            p, _, state, loss = jstep(p, {}, state, jnp.asarray(tokens))
            losses.append(float(loss))
            snaps.append(jax.tree.map(np.asarray, (p, state.inner[0].trace,
                                                   state.residual)))
        return {"params0": np_params, "snaps": snaps, "losses": losses}
    finally:
        mp.undo()


def _lm_loss(model, batch):
    h = model(batch[:, :-1], return_hidden=True)
    return fused_softmax_xent(h.reshape(-1, CFG["dim"]), model.head.kernel,
                              batch[:, 1:].reshape(-1)).mean()


def _port_lm(params, trace=None, residual=None):
    model = TransformerLM(**CFG, dtype=torch.float32,
                          head_dtype=torch.float32, ln_dtype=torch.float32,
                          device="cpu")
    weights.load_flax_params(model, params)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LM_LR, momentum=MOMENTUM),
        compression=Compression.int8, error_feedback=True)
    if trace is not None:
        weights.load_optax_sgd_state(opt, model, trace, residual)
    return model, opt


def _port_lm_steps(model, opt, steps):
    tokens = torch.from_numpy(_tokens()).long()
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = _lm_loss(model, tokens)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def _assert_params(model, params):
    ref = weights.from_flax(params)
    state = model.state_dict()
    assert state.keys() == ref.keys()
    for name, value in ref.items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_small_lm_two_steps_match_jax(jax_lm_run, monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    model, opt = _port_lm(jax_lm_run["params0"])
    losses = _port_lm_steps(model, opt, 2)
    np.testing.assert_allclose(losses, jax_lm_run["losses"], rtol=1e-5)
    _assert_params(model, jax_lm_run["snaps"][1][0])
    lossy = [p for p in model.parameters() if "residual" in opt.state[p]]
    # tok_emb, head and the blocks' four kernels; pos_emb (64 x 128) is
    # under the 64 KiB floor.
    assert len(lossy) == 2 + 4 * CFG["depth"]
    assert all(opt.state[p]["residual"].abs().max() > 0 for p in lossy)


def test_small_lm_resumes_from_jax_state(jax_lm_run, monkeypatch):
    """The port resumes from the JAX package's state after step 1 (params,
    momentum trace, error-feedback residual) and takes step 2 as JAX
    did."""
    monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    params, trace, residual = jax_lm_run["snaps"][0]
    model, opt = _port_lm(params, trace, residual)
    tok = model.tok_emb.embedding
    assert torch.equal(opt.state[tok]["residual"], torch.from_numpy(
        np.asarray(residual["tok_emb"]["embedding"])))
    losses = _port_lm_steps(model, opt, 1)
    np.testing.assert_allclose(losses, jax_lm_run["losses"][1:], rtol=1e-5)
    _assert_params(model, jax_lm_run["snaps"][1][0])


def test_make_train_step_takes_wire_names():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for c in ("int8", "bf16", "none", Compression.int8):
        step = make_train_step(model, lambda m, b: m(b).sum(), opt,
                               compression=c)
        assert torch.isfinite(step(torch.ones(3, 2)))


# --------------------------------------------------------------------------
# Two processes over gloo.

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_run(request, tmp_path_factory):
    return _once(request, tmp_path_factory, "gloo", _gloo_run)


def _gloo_run():
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=90)
            assert not isinstance(out, str), f"rank {rank}:\n{out}"
            got[rank] = out
    except queue.Empty:
        pytest.fail("a gloo worker gave no result within 90 s")
    finally:
        for p in procs:
            p.join(timeout=60)
            alive = p.is_alive()
            if alive:
                p.kill()
            assert not alive, "a gloo worker did not exit within 60 s"
    for p in procs:
        assert p.exitcode == 0
    return got


def test_gloo_ring_bit_identical_to_lockstep(gloo_run):
    x = _ring_inputs(2)
    xs = [torch.from_numpy(x[r]) for r in range(2)]
    for key, average in (("ring", True), ("ring_sum", False)):
        want = tqc.lockstep_ring_allreduce(xs, average=average)
        for r in range(2):
            assert np.array_equal(_bits(gloo_run[r][key]),
                                  _bits(want[r].numpy()))


def test_distributed_optimizer_bit_identical_to_jax_two_ranks(
        gloo_run, jax_dopt_runs):
    for r in range(2):
        for overlap in (False, True):
            _assert_matches_jax(gloo_run[r]["dopt"][overlap],
                                [step[r] for step in jax_dopt_runs[2]])


def test_reduce_gradients_int8_routes_by_policy(gloo_run):
    """Under int8 the 2-D leaves ride the ring (one ring over both with
    ``fuse``, one each without), the 1-D leaf stays raw and is the exact
    mean."""
    per_rank = [_rg_inputs(r) for r in range(2)]
    mean = [np.mean(np.stack(a), axis=0) for a in zip(*per_rank)]
    fused = tqc.lockstep_ring_allreduce(
        [torch.from_numpy(np.concatenate([g[0].ravel(), g[2].ravel()]))
         for g in per_rank], average=True)[0].numpy()
    n0 = per_rank[0][0].size
    want = {True: [fused[:n0].reshape(_W), fused[n0:].reshape(16, 64)],
            False: [tqc.lockstep_ring_allreduce(
                [torch.from_numpy(g[i]) for g in per_rank],
                average=True)[0].numpy() for i in (0, 2)]}
    for r in range(2):
        out = gloo_run[r]
        for x, m in zip(out["rg_raw"], mean):
            np.testing.assert_array_equal(x, m)
        for fuse in (True, False):
            w, b, w2 = out[("rg", fuse)]
            np.testing.assert_array_equal(b, mean[1])
            assert np.array_equal(_bits(w), _bits(want[fuse][0]))
            assert np.array_equal(_bits(w2), _bits(want[fuse][1]))
            assert not np.array_equal(w, mean[0])
            np.testing.assert_allclose(w, mean[0], rtol=0.05, atol=0.05)


def test_broadcast_parameters_over_gloo(gloo_run):
    a, b = gloo_run[0]["params"], gloo_run[1]["params"]
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes()


def test_broadcast_optimizer_state_over_gloo(gloo_run):
    root, fresh = gloo_run[0], gloo_run[1]
    assert root["opt_state"].keys() == fresh["opt_state"].keys()
    assert len(root["opt_state"]) == 4
    for i, s in root["opt_state"].items():
        assert set(s) == set(fresh["opt_state"][i])
        assert "step" in s and "exp_avg" in s
        for k, v in s.items():
            assert v.tobytes() == fresh["opt_state"][i][k].tobytes(), (i, k)
    assert sum("residual" in s for s in root["opt_state"].values()) == 2
    assert root["hyper"] == fresh["hyper"]
    assert fresh["hyper"]["lr"] == ("float", 0.01)
    assert fresh["hyper"]["accum_steps"] == ("int", 3)
    assert fresh["hyper"]["weight_decay"] == ("int", 0)
    assert fresh["hyper"]["betas"] == ("tuple", (0.9, 0.999))
