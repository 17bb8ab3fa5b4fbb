"""The port's ResNet against the JAX package's, on the CPU.

A small ``ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10)`` is
initialised in flax; its BatchNorm scales, biases and running statistics
are then redrawn from a seeded numpy generator (flax starts the last
BatchNorm of each block at scale 0, which would leave most gradients at
zero) and the variables are carried into the port with
``weights.load_flax_variables``.  The same NHWC images (16 x 16, and 7 x 7
for the odd SAME padding) go through one ``train=True`` apply with the
integer-label cross-entropy of the bench's ResNet leg and one
``train=False`` apply.  Logits, loss, every parameter gradient and the
updated ``batch_stats`` are held to a relative Frobenius error of 1e-4 in
f32 and 1e-3 in bf16.  The bf16 limit lies between the readings of the
bf16 port against bf16 flax (about 2e-7) and those of a precision-mismatch
control, the port in f32 against bf16 flax, which must each read above it
(``test_bf16_limit_rejects_a_precision_mismatch``; its smallest reading,
the loss at 16 x 16, is about 2e-3).

The JAX side is compiled with ``xla_allow_excess_precision`` off: by
default XLA's CPU compiler keeps bf16 intermediates of a jitted program
in f32, which the reference's eager run (and the port) round to bf16 after
every op.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from horovod_tpu.models import ResNet50 as JaxResNet50
from horovod_tpu.models.resnet import ResNet as JaxResNet
from horovod_tpu_torch import weights
from horovod_tpu_torch.models import ResNet, ResNet50
from horovod_tpu_torch.models import resnet as tr

CFG = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
TOL = {jnp.float32: 1e-4, jnp.bfloat16: 1e-3}
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def small_variables(jmodel, images, seed=3):
    """flax's variables for ``jmodel`` with every BatchNorm scale, bias,
    mean and var redrawn from ``seed`` (numpy trees)."""
    init = jax.jit(functools.partial(jmodel.init, train=True))
    v = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                      jnp.asarray(images)))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        keys = [p.key for p in path]
        if "head" in keys or keys[-1] == "kernel":
            return a
        if keys[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, v)


@functools.lru_cache(maxsize=None)
def resnet_problem(batch, steps, size=16, seed=11):
    """Seeded inputs of the small f32 ResNet's train-step tests: flax
    variables (BatchNorm redrawn, numpy), images (steps, batch, size,
    size, 3) f32 and labels (steps, batch) int32.  Cached: callers must
    not write to the arrays."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (steps, batch, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (steps, batch)).astype(
        np.int32)
    jmodel = JaxResNet(**CFG, dtype=jnp.float32)
    return small_variables(jmodel, images[0]), images, labels


@functools.lru_cache(maxsize=None)
def _jax_run(size, jdtype):
    """One train apply (loss, logits, grads, new batch_stats) and one eval
    apply of the JAX model, from seeded inputs."""
    jmodel = JaxResNet(**CFG, dtype=jdtype)
    rng = np.random.default_rng(size)
    images = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    v = small_variables(jmodel, images)

    def train_then_eval(params, batch_stats):
        def loss_fn(p):
            logits, mut = jmodel.apply(
                {"params": p, "batch_stats": batch_stats},
                jnp.asarray(images), train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()
            return loss, (logits, mut["batch_stats"])
        (loss, (logits, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        # Eval on the updated statistics, as the port's model holds them.
        eval_logits = jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(images), train=False)
        return loss, logits, stats, grads, eval_logits

    args = (v["params"], v["batch_stats"])
    loss, logits, stats, grads, eval_logits = jax.jit(
        train_then_eval).lower(*args).compile(
            compiler_options=EXACT_ROUNDING)(*args)
    out = dict(loss=float(loss), logits=np.asarray(logits),
               eval_logits=np.asarray(eval_logits),
               grads=jax.tree.map(np.asarray, grads),
               stats=jax.tree.map(np.asarray, stats))
    return v, images, labels, out


@pytest.mark.parametrize("size", [16, 7])
@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_train_and_eval_apply_match_flax(size, jdtype):
    v, images, labels, want = _jax_run(size, jdtype)
    tol = TOL[jdtype]
    tdtype = torch.float32 if jdtype == jnp.float32 else torch.bfloat16
    model = ResNet(**CFG, dtype=tdtype, device="cpu")
    weights.load_flax_variables(model, v)
    model.train()
    logits = model(torch.from_numpy(images))
    assert logits.dtype == torch.float32
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    assert rel(logits.detach(), want["logits"]) <= tol
    assert rel(loss.item(), want["loss"]) <= tol
    grads = weights.from_flax(want["grads"])
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    for name, p in named.items():
        assert np.linalg.norm(grads[name]) > 0, name
        assert rel(p.grad, grads[name]) <= tol, name
    stats = weights.from_flax(want["stats"])
    buffers = dict(model.named_buffers())
    assert buffers.keys() == stats.keys()
    for name, b in buffers.items():
        assert rel(b, stats[name]) <= tol, name
    model.eval()
    with torch.no_grad():
        eval_logits = model(torch.from_numpy(images))
    assert rel(eval_logits, want["eval_logits"]) <= tol


@pytest.mark.parametrize("size", [16, 7])
def test_bf16_limit_rejects_a_precision_mismatch(size):
    """The control of the bf16 limit: the port in f32 against bf16 flax
    (a port computing at another precision) fails every check the bf16
    parity holds -- logits, loss, the worst gradient, the worst new
    statistic and the eval logits each read above the limit."""
    v, images, labels, want = _jax_run(size, jnp.bfloat16)
    model = ResNet(**CFG, dtype=torch.float32, device="cpu")
    weights.load_flax_variables(model, v)
    model.train()
    logits = model(torch.from_numpy(images))
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    grads = weights.from_flax(want["grads"])
    stats = weights.from_flax(want["stats"])
    readings = {
        "logits": rel(logits.detach(), want["logits"]),
        "loss": rel(loss.item(), want["loss"]),
        "gradients": max(rel(p.grad, grads[n])
                         for n, p in model.named_parameters()),
        "statistics": max(rel(b, stats[n])
                          for n, b in model.named_buffers())}
    model.eval()
    with torch.no_grad():
        readings["eval"] = rel(model(torch.from_numpy(images)),
                               want["eval_logits"])
    assert min(readings.values()) > TOL[jnp.bfloat16], readings


@pytest.mark.parametrize("size,kernel,stride", [
    (16, 3, 2), (7, 3, 2), (8, 1, 2), (7, 1, 2), (56, 3, 2), (56, 3, 1),
    (5, 3, 1), (4, 7, 2), (1, 3, 2), (112, 1, 1)])
def test_same_padding_matches_lax(size, kernel, stride):
    want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tr.same_padding(size, kernel, stride) == tuple(want[0])


def test_even_stride2_pads_low_0_high_1():
    """The trap: SAME on an even input pads (0, 1), not PyTorch's (1, 1);
    an odd input (7 -> 4) pads (1, 1)."""
    assert tr.same_padding(56, 3, 2) == (0, 1)
    assert tr.same_padding(7, 3, 2) == (1, 1)


def test_resnet50_names_and_shapes_map_onto_flax():
    """ResNet-50's flax variables (shapes only, ``jax.eval_shape``) map
    onto the port's parameters and buffers by name, conv kernels
    transposed HWIO -> OIHW; 25,557,032 parameters."""
    jmodel = JaxResNet50(num_classes=1000)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)), train=True))
    want = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes[col])[0]:
            keys = [p.key for p in path]
            shape = tuple(leaf.shape)
            if keys[-1] == "kernel" and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            want[".".join(keys)] = shape
    model = ResNet50(num_classes=1000, device="cpu")
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.BottleneckBlock_15.BatchNorm_2.scale.abs().sum() == 0


def test_nhwc_input_is_viewed_channels_last():
    """The NHWC batch becomes an NCHW view in channels_last memory without
    a copy, and a conv keeps that memory format."""
    x = torch.randn(2, 8, 8, 3)
    view = x.permute(0, 3, 1, 2)
    assert view.data_ptr() == x.data_ptr()
    assert view.is_contiguous(memory_format=torch.channels_last)
    conv = tr.Conv(3, 4, (3, 3), (2, 2), dtype=torch.float32, device="cpu",
                   gen=torch.Generator().manual_seed(0))
    assert conv(view).is_contiguous(memory_format=torch.channels_last)


def test_batchnorm_running_update_is_flax_momentum():
    """ra = 0.9 ra + 0.1 stat with the biased variance (PyTorch's momentum
    means the opposite and its running_var is unbiased); no counter."""
    bn = tr.BatchNorm(3, dtype=torch.float32, device="cpu")
    x = torch.randn(4, 3, 5, 5)
    bn.train()
    bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean, 0.1 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var, rtol=1e-5,
                               atol=1e-7)
    assert sorted(n for n, _ in bn.named_buffers()) == ["mean", "var"]


def test_seeded_init_is_reproducible():
    a = ResNet(**CFG, device="cpu", seed=5).state_dict()
    b = ResNet(**CFG, device="cpu", seed=5).state_dict()
    c = ResNet(**CFG, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_init.kernel"], c["conv_init.kernel"])
