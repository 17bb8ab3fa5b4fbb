"""The port's InceptionV3, VGG16, MLP and ConvNet against the JAX
package's, on the CPU, in f32.

Each flax model is initialised with ``num_classes=10``: InceptionV3 at
75 x 75 and VGG16 at 64 x 64, each on a batch of 2 (VGG16's last map is
then 2 x 2, so the order of ``fc1``'s flatten shows; 32 x 32 would give
1 x 1 and hide it), MLP on (2, 28, 28) and ConvNet on a 3-D (2, 28, 28)
batch (a 7 x 7 map before ``Dense_0``).  InceptionV3's BatchNorm scales,
biases and running statistics are redrawn from a seeded numpy generator.
The ``init`` tree is carried into the port with
``weights.load_flax_variables`` (strict).

* VGG16, MLP, ConvNet: one ``train=True`` apply with the integer-label
  cross-entropy: logits and loss within ``TOL`` = 1e-4, every gradient
  within ``TOL_GRAD`` = 1e-2 (relative Frobenius; see ``TOL_GRAD`` for
  the ReLU kinks that set it).
* InceptionV3 in train mode is held unit by unit (the 5 stem ConvBN, the
  11 blocks, the head), each on flax's own input to it with a seeded
  cotangent: output and new BatchNorm statistics within ``TOL``, the
  gradients of its input and parameters within ``TOL_GRAD``.  The whole
  chain is not compared in train mode: at batch 2 its BatchNorm
  statistics come from 2 samples at 1 x 1, and flax against itself on
  inputs moved by 1e-7 relative moved its logits by 1.8e-2.
* Every model: eval-mode logits on the variables as drawn within ``TOL``.
* One ``make_train_step(sync_aux_state=True)`` step of InceptionV3 on 2
  gloo ranks (spawned once per session) against JAX's on a 2-device mesh
  (see ``STEP_SIZE`` for its limits).
"""

import copy
import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

import horovod_tpu_torch.models as tm
from _torch_spmd_worker import LR, MOMENTUM, inception_worker, once, run_group
from horovod_tpu.jax.spmd import make_train_step as jax_make_train_step
from horovod_tpu.models import ConvNet as JaxConvNet
from horovod_tpu.models import InceptionV3 as JaxInceptionV3
from horovod_tpu.models import MLP as JaxMLP
from horovod_tpu.models import VGG16 as JaxVGG16
from horovod_tpu.models import inception as ji
from horovod_tpu_torch import weights
from horovod_tpu_torch.models import resnet as tr

TOL = 1e-4
# Gradients: a ReLU input within rounding of 0 takes the other side of the
# kink in one package, which moves every gradient below it.  flax against
# itself on inputs moved by 1e-7 relative moved VGG16's first three
# layers' gradients by up to 1.3e-3 that way (the port read 1.5e-3, every
# other gradient 2e-6), so the limit sits a few times above that and far
# below the O(1) error of a wrong gradient.
TOL_GRAD = 1e-2
# A unit's cotangent is zero where flax's output lies within KINK of the
# ReLU's kink, so that an output that rounds to the other side of 0 in one
# package does not move its gradients (InceptionA_0's b1 branch has a
# pre-activation of 4.9e-7 at this seed).
KINK = 1e-4
# The step on two ranks runs at 139 x 139, two images a rank: at 75 x 75
# the problem is chaotic (JAX's own step, on inputs moved by 1e-7
# relative, moved its loss by 4.2e-3 and stem leaves by 0.4).  At 139 x
# 139 that floor is 1.1e-5 on the loss and 1.8e-2 on the worst leaf (a
# stem convolution's; the port read 2.5e-5 and 2.6e-2), so the limits sit
# a few times above it; the ranks must agree bit for bit.
STEP_SIZE = 139
TOL_STEP_LOSS = 1e-4
TOL_STEP_LEAF = 1e-1
NAMES = ("inception_v3", "vgg16", "mlp", "convnet")
# name -> (flax model, input shape, the port's model from the CPU)
SPECS = {
    "inception_v3": (
        lambda: JaxInceptionV3(num_classes=10, dtype=jnp.float32),
        (2, 75, 75, 3),
        lambda: tm.InceptionV3(num_classes=10, dtype=torch.float32,
                               device="cpu")),
    "vgg16": (
        lambda: JaxVGG16(num_classes=10, dtype=jnp.float32),
        (2, 64, 64, 3),
        lambda: tm.VGG16(num_classes=10, dtype=torch.float32, image_size=64,
                         device="cpu")),
    "mlp": (lambda: JaxMLP(), (2, 28, 28),
            lambda: tm.MLP(28 * 28, device="cpu")),
    "convnet": (lambda: JaxConvNet(), (2, 28, 28),
                lambda: tm.ConvNet(device="cpu")),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: the test runner's workers
    share the cores, and these small ops lose more to threads waiting on
    each other than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _variables(jmodel, x, seed):
    """A variables tree of flax's ``init`` (its names and shapes from
    ``jax.eval_shape``, which costs no compile) with numpy leaves drawn
    from ``seed``: kernels at flax's lecun-normal scale (1 / fan_in), the
    other leaves redrawn as the ResNet parity redraws BatchNorm: scales
    and variances from U(0.5, 1.5), biases and means 0.1 x N(0, 1)."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            std = np.prod(shape[:-1]) ** -0.5
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_loss(jmodel, x, labels, has_bn):
    def loss_fn(params, batch_stats):
        if has_bn:
            logits, mut = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, x,
                train=True, mutable=["batch_stats"])
            batch_stats = mut["batch_stats"]
        else:
            logits = jmodel.apply({"params": params}, x, train=True)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, (logits, batch_stats)
    return loss_fn


# InceptionV3's top-level units in the order the forward runs them, each
# with the flax module that computes it alone (flax's own units, with the
# conv and norm settings of ``InceptionV3.__call__``).
_conv = functools.partial(flax_nn.Conv, use_bias=False, dtype=jnp.float32,
                          param_dtype=jnp.float32)
_norm = functools.partial(flax_nn.BatchNorm, use_running_average=False,
                          momentum=0.9, epsilon=1e-3, dtype=jnp.float32,
                          param_dtype=jnp.float32, axis_name=None)
_cb = functools.partial(ji.ConvBN, conv=_conv, norm=_norm)
UNITS = (
    ("ConvBN_0", lambda: _cb(32, (3, 3), (2, 2), padding="VALID")),
    ("ConvBN_1", lambda: _cb(32, (3, 3), padding="VALID")),
    ("ConvBN_2", lambda: _cb(64, (3, 3))),
    ("ConvBN_3", lambda: _cb(80, (1, 1), padding="VALID")),
    ("ConvBN_4", lambda: _cb(192, (3, 3), padding="VALID")),
    ("InceptionA_0", lambda: ji.InceptionA(32, cb=_cb)),
    ("InceptionA_1", lambda: ji.InceptionA(64, cb=_cb)),
    ("InceptionA_2", lambda: ji.InceptionA(64, cb=_cb)),
    ("InceptionB_0", lambda: ji.InceptionB(cb=_cb)),
    ("InceptionC_0", lambda: ji.InceptionC(128, cb=_cb)),
    ("InceptionC_1", lambda: ji.InceptionC(160, cb=_cb)),
    ("InceptionC_2", lambda: ji.InceptionC(160, cb=_cb)),
    ("InceptionC_3", lambda: ji.InceptionC(192, cb=_cb)),
    ("InceptionD_0", lambda: ji.InceptionD(cb=_cb)),
    ("InceptionE_0", lambda: ji.InceptionE(cb=_cb)),
    ("InceptionE_1", lambda: ji.InceptionE(cb=_cb)),
    ("head", lambda: flax_nn.Dense(10, dtype=jnp.float32,
                                   param_dtype=jnp.float32)),
)
# The pool between two stem units (inception.py:162, :165).
_POOLED = ("ConvBN_3", "InceptionA_0")


def _jax_units(jmodel, v, x):
    """Each unit of InceptionV3 in train mode on its input from flax's own
    forward of ``x``: input, output, a seeded cotangent, the gradients of
    the input and of the unit's parameters, and its new statistics."""
    inter = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)[1]["intermediates"])(v, jnp.asarray(x))
    rng = np.random.default_rng(17)
    out, prev = {}, jnp.asarray(x)
    for name, make in UNITS:
        xin = prev
        if name in _POOLED:
            xin = flax_nn.max_pool(xin, (3, 3), strides=(2, 2))
        if name == "head":
            xin = jnp.mean(xin, axis=(1, 2))
        prev = inter[name]["__call__"][0]
        g = rng.standard_normal(prev.shape).astype(np.float32)
        g[np.abs(np.asarray(prev)) < KINK] = 0.0
        unit = make()
        bs = v["batch_stats"].get(name)

        @jax.jit
        def run(params, xin, g, unit=unit, bs=bs):
            def f(params, xin):
                if bs is None:
                    return unit.apply({"params": params}, xin), {}
                y, mut = unit.apply({"params": params, "batch_stats": bs},
                                    xin, mutable=["batch_stats"])
                return y, mut["batch_stats"]
            y, vjp, stats = jax.vjp(f, params, xin, has_aux=True)
            return (y, stats) + vjp(g)

        y, stats, dparams, dx = run(v["params"][name], xin, g)
        assert rel(prev, y) <= 1e-5, name   # the unit alone = in the model
        out[name] = jax.tree.map(np.asarray, dict(
            x=xin, y=y, g=g, dx=dx, dparams=dparams, stats=stats))
    return out


def _jax_run(name):
    """The flax variables, inputs, one train apply (loss, logits,
    gradients, new statistics) and one eval apply on the variables as
    drawn; for InceptionV3 the train apply unit by unit instead."""
    make, shape, _ = SPECS[name]
    jmodel = make()
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 10, shape[0]).astype(np.int32)
    v = _variables(jmodel, x, seed=3)
    eval_logits = np.asarray(jax.jit(functools.partial(
        jmodel.apply, train=False))(v, jnp.asarray(x)))
    if name == "inception_v3":
        return v, x, labels, dict(eval_logits=eval_logits,
                                  units=_jax_units(jmodel, v, x))
    loss_fn = _jax_loss(jmodel, jnp.asarray(x), jnp.asarray(labels), False)
    (loss, (logits, _)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], {})
    return v, x, labels, dict(
        loss=float(loss), logits=np.asarray(logits), eval_logits=eval_logits,
        grads=jax.tree.map(np.asarray, grads))


def _jax_run_cached(name, request, tmp_path_factory):
    """``_jax_run(name)``, computed once per session."""
    return once(request, tmp_path_factory, f"zoo_{name}",
                lambda: _jax_run(name))


@pytest.fixture
def want(request, tmp_path_factory):
    return lambda name: _jax_run_cached(name, request, tmp_path_factory)


_LOADED = {}


def _port_model(name, v):
    """A copy of the port's model with the variables ``v`` loaded (built
    and loaded once per process)."""
    if name not in _LOADED:
        _LOADED[name] = SPECS[name][2]()
        weights.load_flax_variables(_LOADED[name], v)
    return copy.deepcopy(_LOADED[name])


def _port_train(name, v, x, labels):
    model = _port_model(name, v)
    model.train()
    logits = model(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return model, logits, loss


@pytest.mark.parametrize("name", NAMES)
def test_names_and_shapes_map_onto_flax(name, want):
    """The port's parameters and buffers are the flax ``init`` tree's
    leaves by name (conv kernels HWIO -> OIHW), all f32."""
    v, _, _, _ = want(name)
    expect = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                v.get(col, {}))[0]:
            keys = [p.key for p in path]
            shape = tuple(leaf.shape)
            if keys[-1] == "kernel" and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            expect[".".join(keys)] = shape
    model = _port_model(name, v)
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == expect
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())


@pytest.mark.parametrize("name", ["vgg16", "mlp", "convnet"])
def test_train_apply_matches_flax(name, want):
    v, x, labels, w = want(name)
    model, logits, loss = _port_train(name, v, x, labels)
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    assert rel(logits.detach(), w["logits"]) <= TOL
    assert rel(loss.item(), w["loss"]) <= TOL
    grads = weights.from_flax(w["grads"])
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    for n, p in named.items():
        assert np.linalg.norm(grads[n]) > 0, n
        assert rel(p.grad, grads[n]) <= TOL_GRAD, n


@pytest.mark.parametrize("unit", [n for n, _ in UNITS])
def test_inception_unit_train_matches_flax(unit, want):
    """One unit of InceptionV3 in train mode on flax's input to it: its
    output, the gradients of its input and of every parameter under a
    seeded cotangent, and its updated BatchNorm statistics (momentum 0.9,
    the biased batch variance, epsilon 1e-3)."""
    v, _, _, w = want("inception_v3")
    u = w["units"][unit]
    _port_model("inception_v3", v)
    module = copy.deepcopy(getattr(_LOADED["inception_v3"], unit))
    module.train()
    xin = torch.from_numpy(u["x"])
    if xin.dim() == 4:
        xin = xin.permute(0, 3, 1, 2)
    xin.requires_grad_()
    y = module(xin)
    g = torch.from_numpy(u["g"])
    if y.dim() == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
        y = y.permute(0, 2, 3, 1)
    assert rel(y.detach(), u["y"]) <= TOL
    y.backward(g)
    dx = xin.grad.permute(0, 2, 3, 1) if xin.dim() == 4 else xin.grad
    assert rel(dx, u["dx"]) <= TOL_GRAD
    grads = weights.from_flax(u["dparams"])
    named = dict(module.named_parameters())
    assert named.keys() == grads.keys()
    for n, p in named.items():
        assert np.linalg.norm(grads[n]) > 0, n
        assert rel(p.grad, grads[n]) <= TOL_GRAD, n
    stats = weights.from_flax(u["stats"])
    buffers = dict(module.named_buffers())
    assert buffers.keys() == stats.keys()
    for n, b in buffers.items():
        assert rel(b, stats[n]) <= TOL, n


def test_inception_units_cover_the_model():
    """The units of the parity test are the whole model: every parameter
    and buffer of InceptionV3 (94 ConvBN) lies in one of them."""
    model = SPECS["inception_v3"][2]()
    units = {n for n, _ in UNITS}
    names = list(model.state_dict())
    assert all(n.split(".")[0] in units for n in names)
    assert sum(n.endswith("BatchNorm_0.mean") for n in names) == 94


@pytest.mark.parametrize("name", NAMES)
def test_eval_apply_matches_flax(name, want):
    """Eval-mode logits on the variables as drawn (InceptionV3: the whole
    model on its redrawn running statistics)."""
    v, x, _, w = want(name)
    model = _port_model(name, v)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert rel(got, w["eval_logits"]) <= TOL


@pytest.mark.parametrize("name,layer", [("vgg16", "fc1"),
                                        ("convnet", "Dense_0")])
def test_flatten_order_is_flax_nhwc(name, layer, want):
    """The trap: flax flattens (H, W, C).  The control loads the first
    Dense kernel with its rows reordered as an NCHW flatten would read
    them; the port's logits then miss flax's by far more than ``TOL``, so
    a port flattening its NCHW view directly would fail the parity
    tests."""
    v, x, labels, w = want(name)
    params = jax.tree.map(np.asarray, v["params"])
    kernel = params[layer]["kernel"]
    model = SPECS[name][2]()
    c = 512 if name == "vgg16" else 64
    hw = kernel.shape[0] // c
    assert hw > 1                       # a map larger than 1 x 1
    # row (h, w, c) of flax's kernel feeds the NCHW flatten's (c, h, w).
    params[layer]["kernel"] = kernel.reshape(hw, c, -1).transpose(
        1, 0, 2).reshape(kernel.shape)
    weights.load_flax_variables(model, {"params": params})
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    jmodel = SPECS[name][0]()
    right = jmodel.apply({"params": v["params"]}, jnp.asarray(x),
                         train=False)
    assert rel(logits, right) > 100 * TOL


def test_batchnorm_epsilon_argument():
    """``epsilon`` reaches the normalisation; the default stays ResNet's
    1e-5."""
    x = torch.randn(4, 3, 5, 5) * 0.01
    outs = {}
    for eps in (None, 1e-3):
        kw = {} if eps is None else {"epsilon": eps}
        bn = tr.BatchNorm(3, dtype=torch.float32, device="cpu", **kw)
        bn.train()
        outs[eps] = bn(x)
        var = x.var(dim=(0, 2, 3), unbiased=False)
        mean = x.mean(dim=(0, 2, 3))
        want = ((x - mean[:, None, None])
                / torch.sqrt(var + (eps or 1e-5))[:, None, None])
        torch.testing.assert_close(outs[eps], want, rtol=1e-4, atol=1e-5)
    assert tr.BatchNorm(3, dtype=torch.float32, device="cpu").epsilon == 1e-5
    assert not torch.allclose(outs[None], outs[1e-3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_bias_is_added_after_the_product(dtype):
    """flax adds the bias in ``dtype`` after the product: in bf16 the
    product is rounded, then the sum; in f32 that equals ``F.conv2d``'s
    fused bias."""
    gen = torch.Generator().manual_seed(0)
    conv = tr.Conv(3, 8, (3, 3), dtype=dtype, device="cpu", gen=gen,
                   use_bias=True)
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
    x = torch.randn(2, 3, 9, 9, generator=gen)
    got = conv(x)
    assert got.dtype == dtype
    k, b = conv.kernel.to(dtype), conv.bias.to(dtype)
    product = F.conv2d(x.to(dtype), k, padding=1)
    assert torch.equal(got, product + b[:, None, None])
    if dtype == torch.float32:
        torch.testing.assert_close(got, F.conv2d(x, k, b, padding=1),
                                   rtol=1e-6, atol=1e-6)
    assert tr.Conv(3, 8, (3, 3), dtype=dtype, device="cpu",
                   gen=gen).bias is None


@pytest.mark.parametrize("size", [7, 8, 17])
@pytest.mark.parametrize("window,strides", [((3, 3), (1, 1)),
                                            ((3, 3), (2, 2)),
                                            ((2, 2), (2, 2)),
                                            ((2, 2), (1, 1))])
def test_pools_match_flax(size, window, strides):
    """``avg_pool`` is flax's ``avg_pool(padding="SAME")`` (zero padding
    counted, asymmetric on even inputs at stride 2 and for even windows),
    ``max_pool`` flax's ``max_pool`` (VALID); outputs and the gradients of
    a seeded cotangent (``avg_pool``'s own backward: the same pool of the
    cotangent at stride 1 with a symmetric pad, PyTorch's on NCHW copies
    otherwise) to 1e-6."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    for port, flax_pool in (
            (tr.avg_pool, functools.partial(flax_nn.avg_pool,
                                            padding="SAME")),
            (tr.max_pool, flax_nn.max_pool)):
        t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        got = port(t, window, strides).permute(0, 2, 3, 1)
        want, vjp = jax.vjp(lambda a: flax_pool(a, window, strides=strides),
                            jnp.asarray(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        g = rng.standard_normal(want.shape).astype(np.float32)
        got.backward(torch.from_numpy(g))
        assert t.grad.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["inception_v3", "vgg16", "convnet"])
def test_layers_keep_channels_last(name):
    """Every 4-D output of every module (convolutions, BatchNorm,
    concatenated blocks, pools through the block outputs) stays in
    ``channels_last`` memory, so cuDNN needs no layout conversion."""
    model = SPECS[name][2]()
    shape = SPECS[name][1]
    seen = []

    def hook(module, args, out):
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            seen.append((type(module).__name__, out.is_contiguous(
                memory_format=torch.channels_last)))

    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.randn(shape))
    assert seen and all(ok for _, ok in seen), [n for n, ok in seen
                                                if not ok]


def test_models_exports_the_zoo():
    import horovod_tpu.models as jm
    for name in ("InceptionV3", "VGG16", "MLP", "ConvNet", "ResNet50",
                 "TransformerLM"):
        assert hasattr(jm, name) and hasattr(tm, name), name


def test_seeded_init_is_reproducible():
    a = tm.ConvNet(device="cpu", seed=5).state_dict()
    b = tm.ConvNet(device="cpu", seed=5).state_dict()
    c = tm.ConvNet(device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv_0.kernel"], c["Conv_0.kernel"])


# ----------------------------------------- one step on two gloo ranks


def _jax_inception_step(variables, images, labels):
    """JAX's ``make_train_step(sync_aux_state=True)`` over a 2-device
    mesh, one step on the global batch."""
    jmodel = JaxInceptionV3(num_classes=10, dtype=jnp.float32)

    def loss_fn(params, batch_stats, batch):
        x, y = batch
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), mut["batch_stats"]

    tx = optax.sgd(LR, momentum=MOMENTUM)
    mesh = Mesh(np.array(jax.devices()[:2]), ("ranks",))
    step = jax_make_train_step(loss_fn, tx, mesh, sync_aux_state=True,
                               donate=False)
    params, bs = variables["params"], variables["batch_stats"]
    params, bs, _, loss = step(params, bs, tx.init(params),
                               (jnp.asarray(images), jnp.asarray(labels)))
    state = weights.from_flax(jax.tree.map(np.asarray, params))
    state.update(weights.from_flax(jax.tree.map(np.asarray, bs)))
    return float(loss), {k: t.numpy() for k, t in state.items()}


@pytest.fixture(scope="module")
def two_ranks(request, tmp_path_factory):
    def run():
        v, _, _, _ = _jax_run_cached("inception_v3", request,
                                     tmp_path_factory)
        rng = np.random.default_rng(21)
        images = rng.standard_normal(
            (4, STEP_SIZE, STEP_SIZE, 3)).astype(np.float32)
        labels = rng.integers(0, 10, 4).astype(np.int32)
        return (run_group(inception_worker, 2, v, images, labels),
                _jax_inception_step(v, images, labels))
    return once(request, tmp_path_factory, "zoo_two_ranks", run)


def test_inception_train_step_two_ranks_matches_jax(two_ranks):
    got, (want_loss, want_state) = two_ranks
    for r in range(2):
        assert abs(got[r]["loss"] - want_loss) <= (TOL_STEP_LOSS
                                                    * abs(want_loss))
        assert got[r]["state"].keys() == want_state.keys()
        for n, value in want_state.items():
            assert rel(got[r]["state"][n], value) <= TOL_STEP_LEAF, n
    for n, value in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][n], value)
