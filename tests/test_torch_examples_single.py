"""The port's single-process example twins on the CPU, held against the
JAX examples in this process.

``mnist_advanced``, ``mnist_estimator``, ``imagenet_resnet50`` and
``word2vec`` (``horovod_tpu_torch/examples``) each have their JAX
example's flags and defaults, and the data their JAX example feeds its
step, bit for bit: captured from the JAX example itself, run with its
training step stubbed out (no compile), on the conftest's 8-device mesh
(global batches of 8 ranks' rows).  ``word2vec`` seeds its
pairs with ``hash("w2v")``, which Python salts per process, so both sides
run in this one.  Numerics: ``shift_scale`` equals the JAX example's pad
+ ``dynamic_slice`` + scale on offsets drawn with ``jax.random`` (within
1e-7); ``imagenet_resnet50``'s first two steps from flax-shaped weights
(``weights.load_flax_variables``) equal optax's ``add_decayed_weights`` +
``sgd(momentum)`` applied to the same gradients through the bf16 wire
(the weights within 1e-5, each update within 1e-3 of its largest
magnitude, at a decay large enough to show); ``word2vec``'s first sparse step equals the JAX
``step_body`` from the same tables on the same global batch (within
1e-6).  Each twin meets its JAX test's bar at that test's arguments
(``tests/test_examples.py:24-101``), at world size 1 with
``device="cpu"``, on one torch thread.
"""

import copy
import inspect
import re
import runpy
import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_torch
from horovod_tpu_torch import weights
from horovod_tpu_torch.examples import (imagenet_resnet50, mnist_advanced,
                                        mnist_estimator, word2vec)

TWINS = {"mnist_advanced": mnist_advanced,
         "mnist_estimator": mnist_estimator,
         "imagenet_resnet50": imagenet_resnet50, "word2vec": word2vec}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def size1(monkeypatch):
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "TIMELINE", "FUSION_THRESHOLD", "FAULT"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd_torch.shutdown()
    yield
    hvd_torch.shutdown()


def _flags(src):
    """{flag: its default's source text (None without one)}."""
    out = {}
    for m in re.finditer(r'add_argument\("(--[a-z-]+)"([^)]*)\)', src):
        d = re.search(r"default=([^,\s)]+)", m.group(2))
        out[m.group(1)] = d.group(1) if d else None
    return out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_has_the_jax_flags(name):
    """The same flags with the same defaults as the JAX example."""
    want = _flags(open(f"examples/jax_{name}.py").read())
    assert want and _flags(inspect.getsource(TWINS[name])) == want


# ------------------------------------------------------------ the data


class _Stop(Exception):
    pass


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    with pytest.raises(_Stop):
        runpy.run_path(f"examples/jax_{name}.py")["main"]()


def _stub_steps(monkeypatch, n_steps, aux=None):
    """Stub ``make_train_step`` and ``make_eval_step``: the train step
    records the global batch of each of its first ``n_steps`` calls, then
    stops the example."""
    import horovod_tpu.jax.spmd as spmd
    got = []

    def make_train_step(*a, **k):
        def step(params, aux_state, opt_state, batch):
            got.append([np.asarray(x) for x in batch])
            if len(got) == n_steps:
                raise _Stop
            return params, aux_state, opt_state, np.float32(0)
        return step
    monkeypatch.setattr(spmd, "make_train_step", make_train_step)
    monkeypatch.setattr(spmd, "make_eval_step", lambda *a, **k: None)
    return got


def test_mnist_advanced_data_is_the_jax_examples(hvd, monkeypatch):
    got = _stub_steps(monkeypatch, 3)
    _run_jax(monkeypatch, "mnist_advanced", ["--batch-size", "16"])
    train_x, train_y, _, _ = mnist_advanced.load_data()
    rows = mnist_advanced.epoch_rows(np.random.RandomState(1234),
                                     len(train_x), 16 * hvd.size(), 3)
    for idx, (x, y) in zip(rows, got):
        assert train_x[idx].dtype == x.dtype and train_y[idx].dtype == y.dtype
        np.testing.assert_array_equal(train_x[idx], x)
        np.testing.assert_array_equal(train_y[idx], y)
    jax_example = runpy.run_path("examples/jax_mnist_advanced.py")
    for mine, want in zip(mnist_advanced.load_data(),
                          jax_example["load_data"]()):
        assert mine.dtype == want.dtype
        np.testing.assert_array_equal(mine, want)


def test_mnist_estimator_data_is_the_jax_examples(hvd, monkeypatch):
    got = _stub_steps(monkeypatch, 3)
    _run_jax(monkeypatch, "mnist_estimator", ["--batch-size", "16"])
    data = mnist_estimator.load_data()
    jax_data = runpy.run_path("examples/jax_mnist_estimator.py")[
        "load_data"]()
    for mine, want in zip(data, jax_data):
        np.testing.assert_array_equal(mine, want)
    train_input_fn, eval_input_fn = mnist_estimator.input_fns(
        data, 16 * hvd.size(), 0)
    for step, batch in enumerate(got):
        for mine, want in zip(train_input_fn(step), batch):
            assert mine.dtype == want.dtype
            np.testing.assert_array_equal(mine, want)
    x, y = eval_input_fn(1)
    np.testing.assert_array_equal(x, data[2][128:256])


def test_imagenet_resnet50_data_is_the_jax_examples(hvd, monkeypatch,
                                                    tmp_path):
    import horovod_tpu.models
    import jax.numpy as jnp

    class Tiny:
        """The flax ResNet-50 stubbed out too: its variables are not the
        data under test, and its init costs half a minute here."""
        def __init__(self, **kw):
            pass

        def init(self, rng, sample, train):
            return {"params": {"w": jnp.zeros(2)},
                    "batch_stats": {"m": jnp.zeros(2)}}
    monkeypatch.setattr(horovod_tpu.models, "ResNet50", Tiny)
    got = _stub_steps(monkeypatch, 2)
    _run_jax(monkeypatch, "imagenet_resnet50",
             ["--batch-size", "2", "--steps-per-epoch", "2", "--image-size",
              "32", "--checkpoint-dir", str(tmp_path)])
    gb = 2 * hvd.size()
    for (x, y), (want_x, want_y) in zip(
            imagenet_resnet50.synthetic_batches(gb, 32, 2, seed=0), got):
        assert x.dtype == want_x.dtype and y.dtype == want_y.dtype
        np.testing.assert_array_equal(x, want_x)
        np.testing.assert_array_equal(y, want_y)


def _capture_word2vec(monkeypatch, argv):
    """The JAX example's (centers, contexts, negatives) of every step, its
    compiled step stubbed; and the first call's arguments."""
    import jax
    got = []
    real_jit = jax.jit

    def jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)

        def call(*args):
            if len(args) != 5:
                return compiled(*args)
            got.append([np.asarray(x) for x in args[2:]])
            if len(got) == 1:
                got.insert(0, (args[0], args[1], compiled))
            return args[0], args[1], np.float32(0)
        return call
    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    runpy.run_path("examples/jax_word2vec.py", run_name="__main__")
    return got[0], got[1:]


W2V_ARGS = ["--steps", "5", "--vocab", "300", "--dim", "16", "--batch-size",
            "16"]


def test_word2vec_data_is_the_jax_examples_in_this_process(hvd, monkeypatch,
                                                           capsys):
    _, batches = _capture_word2vec(monkeypatch, W2V_ARGS)
    args = types.SimpleNamespace(vocab=300, steps=5, window=2, neg=8)
    mine = list(word2vec.pair_stream(args, 16 * hvd.size()))
    assert len(mine) == len(batches) == 5
    for m, w in zip(mine, batches):
        for a, b in zip(m, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- numerics


def test_shift_scale_is_the_jax_examples_augmentation(hvd):
    """The JAX example's ``augment`` (pad + ``dynamic_slice`` + scale) on
    its own ``jax.random`` draws, against ``shift_scale`` on the same
    offsets and scales, within 1e-7."""
    import jax
    import jax.numpy as jnp
    ns = runpy.run_path("examples/jax_mnist_advanced.py")
    images = np.random.RandomState(5).randn(6, 28, 28).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(ns["augment"](key, jnp.asarray(images)))
    dy, dx, scale = [], [], []
    for k in jax.random.split(key, len(images)):
        k_shift, k_scale = jax.random.split(k)
        y, x = np.asarray(jax.random.randint(
            k_shift, (2,), 0, 2 * ns["MAX_SHIFT"] + 1))
        s = 1.0 + jax.random.uniform(k_scale, (), minval=-ns["SCALE_RANGE"],
                                     maxval=ns["SCALE_RANGE"])
        dy.append(y)
        dx.append(x)
        scale.append(np.float32(s))
    assert (mnist_advanced.MAX_SHIFT, mnist_advanced.SCALE_RANGE) == (
        ns["MAX_SHIFT"], ns["SCALE_RANGE"])
    got = mnist_advanced.shift_scale(torch.from_numpy(images),
                                     np.array(dy), np.array(dx),
                                     np.array(scale, np.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_augmentation_streams_differ_by_rank_and_step():
    a = mnist_advanced.draw_augmentation(0, 3, 64)
    for other in (mnist_advanced.draw_augmentation(1, 3, 64),
                  mnist_advanced.draw_augmentation(0, 4, 64)):
        assert not all(np.array_equal(x, y) for x, y in zip(a, other))
    for x, y in zip(a, mnist_advanced.draw_augmentation(0, 3, 64)):
        np.testing.assert_array_equal(x, y)
    dy, dx, scale = a
    assert dy.min() >= 0 and dy.max() <= 2 * mnist_advanced.MAX_SHIFT
    assert np.all(np.abs(scale - 1) <= mnist_advanced.SCALE_RANGE)


def _flax_resnet_variables(seed):
    """ResNet-50's variables as the flax tree (``params`` and
    ``batch_stats``, HWIO kernels), numpy: flax's initializer
    distributions, drawn by the port's model from ``seed``."""
    model = imagenet_resnet50.ResNet50(num_classes=1000,
                                       dtype=torch.bfloat16, seed=seed,
                                       device="cpu")

    import jax
    variables = {
        "params": weights.to_flax(dict(model.named_parameters())),
        "batch_stats": weights.to_flax(dict(model.named_buffers()))}
    return jax.tree.map(lambda t: t.detach().numpy().copy(), variables)


def test_imagenet_resnet50_first_step_is_optax(size1):
    """The twin's optimizer under its step: torch SGD's weight decay and
    momentum through ``DistributedOptimizer(bf16)``, against optax's
    ``add_decayed_weights`` + ``sgd(momentum)`` on the same weights and
    the same gradients rounded through bf16 (``Compression.bf16``), over
    two steps, so that the second carries the first's momentum.  The
    decay is 0.1, not the example's 5e-5: at lr 0.0125 that moves a unit
    weight (the BatchNorm scales) by 1.25e-3 a step, where 5e-5 would move
    it by 6e-7, under any limit on the weights.  Every parameter within
    1e-5 of optax's after each step, and each step's update of each
    parameter (new less old) within 1e-3 of that update's largest
    magnitude, plus 1e-7 of f32 rounding (a unit weight's ulp is 6e-8)."""
    import jax
    import jax.numpy as jnp
    import optax
    hvd_torch.init(device="cpu")
    variables = _flax_resnet_variables(seed=3)
    model, shadow = (imagenet_resnet50.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, device="cpu")
        for _ in range(2))
    weights.load_flax_variables(model, variables)
    batch = next(imagenet_resnet50.synthetic_batches(2, 32, 1, seed=0))
    batch = tuple(torch.from_numpy(a) for a in batch)
    lr, momentum, wd = 0.0125, 0.9, 0.1
    opt = imagenet_resnet50.make_optimizer(model, lr, momentum, wd)
    step = imagenet_resnet50.make_train_step(
        model, imagenet_resnet50.loss_fn, opt, sync_aux_state=True)

    def flat():
        return {n: p.detach().clone() for n, p in model.named_parameters()}
    got, grads = [flat()], []
    for _ in range(2):
        # The gradient at the step's weights, from a copy of the model.
        shadow.load_state_dict(model.state_dict())
        shadow.zero_grad(set_to_none=True)
        imagenet_resnet50.loss_fn(shadow, batch).backward()
        grads.append(weights.to_flax({n: p.grad for n, p
                                      in shadow.named_parameters()}))
        step(batch)
        got.append(flat())

    from horovod_tpu.compression import Compression
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.sgd(lr, momentum=momentum))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = tx.init(params)

    def wire(g):
        c, ctx = Compression.bf16.compress(jnp.asarray(g.numpy()))
        return Compression.bf16.decompress(c, ctx)
    want = [weights.from_flax(jax.tree.map(np.asarray, params))]
    for g in grads:
        updates, state = tx.update(jax.tree.map(wire, g), state, params)
        params = optax.apply_updates(params, updates)
        want.append(weights.from_flax(jax.tree.map(np.asarray, params)))
    assert got[0].keys() == want[0].keys()
    for i in (1, 2):
        worst = max(float((got[i][k] - want[i][k]).abs().max())
                    for k in want[i])
        assert worst <= 1e-5, (i, worst)
        for k in want[i]:
            moved, wanted = got[i][k] - got[i - 1][k], want[i][k] - want[
                i - 1][k]
            err = float((moved - wanted).abs().max())
            assert err <= 1e-3 * float(wanted.abs().max()) + 1e-7, (i, k,
                                                                    err)


def test_word2vec_first_step_is_the_jax_step_body(hvd, size1, monkeypatch,
                                                  capsys):
    """One sparse step of the twin (world size 1, the whole global batch)
    from the JAX example's tables equals the JAX ``step_body`` over the 8
    shards, within 1e-6."""
    (params, opt_state, compiled), batches = _capture_word2vec(
        monkeypatch, W2V_ARGS)
    tables = {k: np.asarray(v) for k, v in params.items()}
    centers, contexts, negs = batches[0]
    new_params, _, _ = compiled(params, opt_state, centers, contexts, negs)

    hvd_torch.init(device="cpu")
    emb_in, emb_out = (torch.from_numpy(tables[k].copy()).requires_grad_()
                       for k in ("emb_in", "emb_out"))
    opt = hvd_torch.DistributedOptimizer(torch.optim.SGD([emb_in, emb_out],
                                                         lr=0.5))
    loss = word2vec.skipgram_loss(emb_in, emb_out,
                                  *(torch.from_numpy(a).long()
                                    for a in (centers, contexts, negs)))
    loss.backward()
    assert emb_out.grad.is_sparse and emb_in.grad.is_sparse
    opt.step()
    for name, t in (("emb_in", emb_in), ("emb_out", emb_out)):
        np.testing.assert_allclose(t.detach().numpy(),
                                   np.asarray(new_params[name]), rtol=0,
                                   atol=1e-6)
    assert not np.array_equal(np.asarray(new_params["emb_out"]),
                              tables["emb_out"])


# --------------------------------------------- the JAX tests' bars


def test_mnist_advanced_twin_meets_its_bar(size1, tmp_path, capsys):
    acc = mnist_advanced.main(
        ["--epochs", "2", "--batch-size", "16", "--warmup-epochs", "1",
         "--checkpoint-dir", str(tmp_path)], device="cpu")
    assert acc > 0.9, capsys.readouterr().out
    assert (tmp_path / "checkpoint-1").exists()


def test_mnist_estimator_twin_resumes(size1, tmp_path, capsys):
    args = ["--batch-size", "16", "--model-dir", str(tmp_path),
            "--checkpoint-every", "3"]
    mnist_estimator.main(["--steps", "40"] + args, device="cpu")
    assert "global_step=40 " in capsys.readouterr().out
    mnist_estimator.main(["--steps", "16"] + args, device="cpu")
    assert "global_step=56 " in capsys.readouterr().out


def test_imagenet_resnet50_twin_resumes(size1, tmp_path, capsys):
    args = ["--batch-size", "2", "--steps-per-epoch", "2", "--image-size",
            "32", "--warmup-epochs", "1", "--checkpoint-dir", str(tmp_path)]
    first = imagenet_resnet50.main(["--epochs", "1"] + args, device="cpu")
    second = imagenet_resnet50.main(["--epochs", "2"] + args, device="cpu")
    out = capsys.readouterr().out
    assert "epoch 0" in out and "epoch 1" in out
    assert out.count("epoch 0:") == 1
    assert len(first) == len(second) == 1
    assert all(np.isfinite(first + second))


def test_word2vec_twin_prints_throughput(size1, capsys):
    from horovod_tpu_torch.metrics import registry
    before = registry.snapshot()["counters"]
    first, final = word2vec.main(
        ["--steps", "30", "--vocab", "300", "--dim", "16", "--batch-size",
         "16"], device="cpu")
    out = capsys.readouterr().out
    assert "pairs/sec" in out
    assert np.isfinite(first) and np.isfinite(final)
    assert "sparse route:" in out and "losses unrounded:" in out
    # Both tables' gradients took the sparse route: 2 slice sets a step,
    # emb_out's with the context and the negative rows.
    after = registry.snapshot()["counters"]
    for name, want in (("sparse.allreduces#route=spmd", 2 * 30),
                       ("sparse.rows#route=spmd", 30 * 16 * (1 + 1 + 8))):
        assert after.get(name, 0) - before.get(name, 0) == want, name
