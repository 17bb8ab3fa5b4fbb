"""The port's train step, gradient reduction and basics.

* Whole slice: two steps of the JAX package's ``make_train_step`` (fused
  cross-entropy, ``optax.sgd(0.01, momentum=0.9)``) and two of the port's,
  from identical params, in f32 on the CPU: losses to rtol 1e-5, every
  param after step 2 to atol 1e-5 (reassociated f32 sums); once more with
  the port's one-pass flash backward (``HOROVOD_TPU_FLASH_BWD=fullunroll``).
* Reduction: a 2-process gloo group; averages equal numpy's mean of the
  per-rank gradients exactly, the bucket plan is ``pack_buckets``' in the
  scheduler's issue order, overlap on and off are bit-identical, and two
  data-parallel steps on half batches equal one process on the whole
  batch to atol 1e-6.
* Basics: raise-before-init with the JAX package's message, and the
  topology from the launcher's environment.
"""

import os
import queue
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh

import horovod_tpu_torch as hvd
from horovod_tpu import basics as jax_basics
from horovod_tpu import scheduler as jax_sched
from horovod_tpu.jax.spmd import make_train_step as jax_make_train_step
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.ops.losses import fused_softmax_xent as jax_xent
from horovod_tpu_torch import basics, scheduler, topology, weights
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.models import TransformerLM
from horovod_tpu_torch.ops import injit
from horovod_tpu_torch.ops.losses import fused_softmax_xent
from horovod_tpu_torch.spmd import make_train_step, reduce_gradients

CFG = dict(vocab=512, dim=256, depth=2, num_heads=2, max_len=128,
           attn="flash")


def test_two_sgd_momentum_steps_match_jax():
    _two_steps_match_jax()


def test_two_sgd_momentum_steps_match_jax_one_pass(monkeypatch):
    """The slice under ``HOROVOD_TPU_FLASH_BWD=fullunroll``: the port's
    backward is the one-pass form at every layer; the JAX step runs under
    ``shard_map``, where interpret mode keeps the split pair, which
    computes the same function, so the tolerances hold unchanged."""
    from horovod_tpu_torch.ops import flash_attention as tfa
    monkeypatch.setenv("HOROVOD_TPU_FLASH_BWD", "fullunroll")
    calls = []
    fused = tfa._PLAIN["flash_bwd_fused"]

    def spy(*a, **kw):
        calls.append(1)
        return fused(*a, **kw)

    monkeypatch.setitem(tfa._PLAIN, "flash_bwd_fused", spy)
    _two_steps_match_jax()
    assert len(calls) == 2 * CFG["depth"]


def _two_steps_match_jax():
    jmodel = JaxLM(**CFG, dtype=jnp.float32, head_dtype=jnp.float32,
                   ln_dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(
        0, CFG["vocab"], (2, 129)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(tokens[:, :-1]))["params"]
    np_params = jax.tree.map(np.asarray, params)

    def jloss(p, aux, batch):
        h = jmodel.apply({"params": p}, batch[:, :-1], return_hidden=True)
        return jax_xent(h.reshape(-1, CFG["dim"]), p["head"]["kernel"],
                        batch[:, 1:].reshape(-1)).mean(), aux

    tx = optax.sgd(0.01, momentum=0.9)
    mesh = Mesh(np.array(jax.devices()[:1]), ("ranks",))
    jstep = jax_make_train_step(jloss, tx, mesh)
    # The JAX step donates its inputs: hand it fresh copies.
    p = jax.tree.map(jnp.array, np_params)
    opt_state = tx.init(p)
    want = []
    for _ in range(2):
        p, _, opt_state, loss = jstep(p, {}, opt_state, jnp.asarray(tokens))
        want.append(float(loss))

    model = TransformerLM(**CFG, dtype=torch.float32,
                          head_dtype=torch.float32, ln_dtype=torch.float32,
                          device="cpu")
    weights.load_flax_params(model, np_params)

    def loss_fn(model, batch):
        h = model(batch[:, :-1], return_hidden=True)
        return fused_softmax_xent(h.reshape(-1, CFG["dim"]),
                                  model.head.kernel,
                                  batch[:, 1:].reshape(-1)).mean()

    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt)
    got = [float(step(torch.from_numpy(tokens).long())) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = weights.from_flax(jax.tree.map(np.asarray, p))
    state = model.state_dict()
    assert state.keys() == ref.keys()
    for name, value in ref.items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_optax_sgd_momentum_is_torch_sgd():
    """optax.sgd(lr, momentum=m): trace = g + m * trace; p -= lr * trace --
    torch.optim.SGD with dampening 0 and no Nesterov, step for step."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(4)]
    tx = optax.sgd(0.01, momentum=0.9)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([tp], lr=0.01, momentum=0.9)
    assert opt.defaults["dampening"] == 0 and not opt.defaults["nesterov"]
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# Two-process reduction over gloo.

_BUCKET = 3000   # bytes: several buckets, and one leaf that rides alone


def _rank_grads(rank):
    rng = np.random.default_rng(100 + rank)
    shapes = [(7, 5), (300,), (11,), (1000,), (3, 4, 5), (2,)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _reduce_worker(rank, port, results):
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "2", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1"})
        hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{port}")
        out = {"size": hvd.size(), "rank": hvd.rank(),
               "local_rank": hvd.local_rank()}
        grads = [torch.from_numpy(g) for g in _rank_grads(rank)]
        for overlap in (False, True):
            for fuse in (True, False):
                red = reduce_gradients(grads, overlap=overlap, fuse=fuse,
                                       bucket_bytes=_BUCKET)
                out[("avg", overlap, fuse)] = [r.numpy() for r in red]
        out["sum"] = [r.numpy() for r in reduce_gradients(
            grads, average=False, bucket_bytes=_BUCKET)]
        out["bf16"] = [r.numpy() for r in reduce_gradients(
            grads, compression=Compression.bf16, bucket_bytes=_BUCKET)]
        for overlap in (False, True):
            sizes = []

            def record(flat):
                sizes.append(flat.numel())
                return injit.allreduce(flat)

            injit.staged_bucket_allreduce(grads, record,
                                          bucket_bytes=_BUCKET,
                                          overlap=overlap)
            out[("plan", overlap)] = sizes
        out["dp_params"] = _dp_step(rank)
        hvd.shutdown()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


_DP_CFG = dict(vocab=64, dim=32, depth=1, num_heads=2, max_len=16,
               attn="flash", dtype=torch.float32, head_dtype=torch.float32,
               ln_dtype=torch.float32, seed=7, device="cpu")


def _dp_loss(model, batch):
    h = model(batch[:, :-1], return_hidden=True)
    return fused_softmax_xent(h.reshape(-1, _DP_CFG["dim"]),
                              model.head.kernel,
                              batch[:, 1:].reshape(-1)).mean()


def _dp_step(rank):
    """Two steps on a model replicated over the world group, each rank
    on its half of the global batch (``rank=None``: the whole batch in
    one process).  Returns the parameters after the second step."""
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, _DP_CFG["vocab"], (4, 17)))
    batch = tokens if rank is None else tokens[2 * rank:2 * rank + 2]
    model = TransformerLM(**_DP_CFG)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = make_train_step(model, _dp_loss, opt)
    for _ in range(2):
        step(batch)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_reduction():
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_reduce_worker, args=(r, port, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=60)
            assert not isinstance(out, str), f"rank {rank}:\n{out}"
            got[rank] = out
    except queue.Empty:
        pytest.fail("a gloo worker gave no result within 60 s")
    finally:
        for p in procs:
            p.join(timeout=60)
            alive = p.is_alive()
            if alive:
                p.kill()
            assert not alive, "a gloo worker did not exit within 60 s"
    for p in procs:
        assert p.exitcode == 0

    per_rank = [_rank_grads(r) for r in range(2)]
    mean = [np.mean(np.stack([a, b]), axis=0) for a, b in zip(*per_rank)]
    total = [a + b for a, b in zip(*per_rank)]
    for r in range(2):
        out = got[r]
        assert (out["size"], out["rank"], out["local_rank"]) == (2, r, r)
        for overlap in (False, True):
            for fuse in (True, False):
                for x, m in zip(out[("avg", overlap, fuse)], mean):
                    np.testing.assert_array_equal(x, m)
        for a, b in zip(out[("avg", False, True)], out[("avg", True, True)]):
            assert a.tobytes() == b.tobytes()
        for x, t in zip(out["sum"], total):
            np.testing.assert_array_equal(x, t)
        for x, m in zip(out["bf16"], mean):
            assert x.dtype == np.float32
            np.testing.assert_allclose(x, m, rtol=2 ** -7, atol=1e-2)
        sizes = [g.size * 4 for g in per_rank[0]]
        plan = scheduler.pack_buckets(sizes, ["torch.float32"] * len(sizes),
                                      _BUCKET)
        assert len(plan) > 2 and [4000] in [[sizes[i] for i in b]
                                            for b in plan]
        for overlap in (False, True):
            want = [sum(per_rank[0][i].size for i in plan[b])
                    for b in scheduler.issue_order(len(plan), overlap)]
            assert out[("plan", overlap)] == want
    # Data parallel: two ranks on half batches step like one process on
    # the whole batch (the average of the halves' mean losses is the
    # whole batch's mean loss).
    whole = _dp_step(None)
    for r in range(2):
        for name, value in whole.items():
            np.testing.assert_allclose(got[r]["dp_params"][name], value,
                                       rtol=0, atol=1e-6, err_msg=name)


def test_pack_buckets_matches_jax_scheduler():
    rng = np.random.default_rng(2)
    for _ in range(200):
        n = int(rng.integers(0, 20))
        sizes = [int(s) for s in rng.integers(1, 300, n)]
        dtypes = [str(d) for d in rng.choice(["float32", "bfloat16"], n)]
        bucket = int(rng.integers(1, 500))
        assert scheduler.pack_buckets(sizes, dtypes, bucket) == \
            jax_sched.pack_buckets(sizes, dtypes, bucket)
    for n in (0, 1, 5):
        for overlap in (False, True):
            assert scheduler.issue_order(n, overlap) == \
                jax_sched.issue_order(n, overlap)


@pytest.mark.parametrize("raw", [None, "", "4096", "-1", "x"])
def test_knob_resolution_matches_jax(monkeypatch, raw):
    for knob in ("HOROVOD_TPU_BUCKET_BYTES", "HOROVOD_TPU_OVERLAP"):
        if raw is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, raw)
    assert scheduler.bucket_bytes_from_env() == \
        jax_sched.bucket_bytes_from_env()
    assert scheduler.overlap_enabled() == jax_sched.overlap_enabled()
    assert scheduler.overlap_enabled(True) is True


def test_single_process_step_needs_no_init():
    """Without a world group the step is backward + optimizer step."""
    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x = torch.ones(2, 4)
    step = make_train_step(model, lambda m, b: m(b).pow(2).mean(), opt)
    first = step(x)
    assert not first.requires_grad and float(step(x)) < float(first)


def test_unported_compression_raises():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for c in ("auto", object()):
        with pytest.raises(NotImplementedError):
            make_train_step(model, lambda m, b: m(b).sum(), opt,
                            compression=c)


# --------------------------------------------------------------------------
# Basics.


def test_raise_before_init_with_jax_message():
    hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError) as info:
        hvd.size()
    want = str(jax_basics.NotInitializedError()).replace(
        "horovod_tpu", "horovod_tpu_torch")
    assert str(info.value) == want
    for query in (hvd.rank, hvd.local_rank, hvd.local_size):
        with pytest.raises(hvd.NotInitializedError):
            query()


def test_init_single_rank_is_idempotent(monkeypatch):
    for var in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE"):
        monkeypatch.delenv("HOROVOD_TPU_" + var, raising=False)
    hvd.shutdown()
    try:
        hvd.init(device="cpu")
        hvd.init(device="cpu")
        assert hvd.is_initialized()
        assert (hvd.size(), hvd.rank(), hvd.local_rank(),
                hvd.local_size()) == (1, 0, 0, 1)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


def test_topology_from_launcher_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_SIZE", "4")
    monkeypatch.setenv("HOROVOD_TPU_RANK", "2")
    monkeypatch.setenv("HOROVOD_TPU_LOCAL_RANK", "1")
    monkeypatch.setenv("HOROVOD_TPU_LOCAL_SIZE", "1")
    assert topology.resolve() == topology.Topology(
        size=4, rank=2, local_rank=1, local_size=1)
    monkeypatch.setenv("HOROVOD_TPU_RANK", "4")
    with pytest.raises(RuntimeError, match="outside a job"):
        topology.resolve()


def test_init_refuses_several_ranks_per_process(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_LOCAL_SIZE", "2")
    hvd.shutdown()
    with pytest.raises(ValueError, match="one rank per process"):
        hvd.init(device="cpu")
    assert not basics.is_initialized()


def test_init_on_cuda_without_a_card_raises():
    """The default device is cuda; with no card init fails instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    hvd.shutdown()
    with pytest.raises(Exception):
        hvd.init()
    assert not hvd.is_initialized()
