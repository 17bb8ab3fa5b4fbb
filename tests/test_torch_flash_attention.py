"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through ``horovod_tpu.ops.flash_attention`` (Pallas
in interpret mode) and ``horovod_tpu_torch.ops.flash_attention``, whose CPU
path is the plain PyTorch version of each kernel; the CUDA kernels are held
against those plain versions on the card by ``chip_smoke.py``.  The
backward forms (the split pair, the one-pass kernel under
``bwd_impl="pallas_fused"`` or ``HOROVOD_TPU_FLASH_BWD=fullunroll``, and
the chunked ``"xla"`` backward) are each held against the JAX package's,
and the port's choice between them against what JAX traces for the same
call.  Everything is f32 unless a test says otherwise.  Tolerances: 2e-5
on o and lse (the two sum the same terms in another order); 1e-4
absolute and relative on gradients, which add one more reassociated
product.
"""

import ast
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops import flash_attention as tfa

B, H, D, T = 2, 2, 128, 128
C = H * D
FWD_ATOL = 2e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _blocks(blk):
    return {} if blk is None else dict(block_q=blk, block_k=blk)


@pytest.mark.parametrize("entry,causal,blk,seq_len", [
    ("proj", True, None, None),
    ("proj", False, 32, None),
    ("qkv", True, 32, 100),
    ("qkv", False, None, 100),
    ("packed", True, None, None),
    ("packed", False, 32, 100),
])
def test_forward_matches_jax(entry, causal, blk, seq_len):
    rng = _rng(1)
    kw = dict(causal=causal, seq_len=seq_len, **_blocks(blk))
    if entry == "proj":
        x = _normal(rng, (B, T, C))
        w = _normal(rng, (C, 3 * C), C ** -0.5)
        want = jfa.flash_qkv_proj(jnp.asarray(x), jnp.asarray(w), H,
                                  interpret=True, **kw)
        got = tfa.flash_qkv_proj(torch.from_numpy(x), torch.from_numpy(w),
                                 H, **kw)
    elif entry == "qkv":
        qkv = _normal(rng, (B, T, 3 * C))
        want = jfa.flash_attention_qkv(jnp.asarray(qkv), H, interpret=True,
                                       **kw)
        got = tfa.flash_attention_qkv(torch.from_numpy(qkv), H, **kw)
    else:
        q, k, v = (_normal(rng, (B, T, H, D)) for _ in range(3))
        want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   interpret=True, **kw)
        got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("causal,seq_len", [(True, None), (False, 100),
                                            (True, 72)])
def test_lse_matches_jax(causal, seq_len):
    """The forward's (B, H, T) lse, padding rows included."""
    qkv = _normal(_rng(2), (B, T, 3 * C))
    _, want = jfa._fwd_packed(
        jnp.asarray(qkv), jnp.asarray(qkv), jnp.asarray(qkv), H, D,
        scale=D ** -0.5, causal=causal, block_q=32, block_k=32,
        interpret=True, seq_len=seq_len, head_base=(0, H, 2 * H))
    t = torch.from_numpy(qkv)
    o, got = tfa._flash_fwd_plain(t[..., :C], t[..., C:2 * C], t[..., 2 * C:],
                                  H, scale=D ** -0.5, causal=causal,
                                  seq_len=seq_len)
    assert got.shape == (B, H, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    if seq_len is not None:
        assert np.all(o[:, seq_len:].numpy() == 0.0)


def test_qkv_proj_grads_match_jax():
    rng = _rng(3)
    x = _normal(rng, (B, T, C))
    w = _normal(rng, (C, 3 * C), C ** -0.5)
    g = _normal(rng, (B, T, C))
    kw = dict(causal=True, seq_len=100, block_q=32, block_k=32)

    def jloss(x, w):
        return (jfa.flash_qkv_proj(x, w, H, interpret=True, **kw)
                * jnp.asarray(g)).sum()

    want_dx, want_dw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (tfa.flash_qkv_proj(xt, wt, H, **kw) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               **GRAD_TOL)


@pytest.mark.parametrize("entry,causal,seq_len", [
    ("packed", False, None), ("packed", True, 72), ("qkv", True, None)])
def test_qkv_grads_match_jax(entry, causal, seq_len):
    rng = _rng(4)
    kw = dict(causal=causal, seq_len=seq_len)
    if entry == "qkv":
        ins = [_normal(rng, (B, T, 3 * C))]
        jfn = lambda a: jfa.flash_attention_qkv(a, H, interpret=True, **kw)
        tfn = lambda a: tfa.flash_attention_qkv(a, H, **kw)
        g = _normal(rng, (B, T, C))
    else:
        ins = [_normal(rng, (B, T, H, D)) for _ in range(3)]
        jfn = lambda *a: jfa.flash_attention(*a, interpret=True, **kw)
        tfn = lambda *a: tfa.flash_attention(*a, **kw)
        g = _normal(rng, (B, T, H, D))
    want = jax.grad(lambda *a: (jfn(*a) * jnp.asarray(g)).sum(),
                    argnums=tuple(range(len(ins))))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    (tfn(*ts) * torch.from_numpy(g)).sum().backward()
    for t, w_ in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                   **GRAD_TOL)


def test_auto_pads_ragged_length_like_jax():
    """T = 100 has no multiple-of-8 block: both pad to 104 and mask
    through seq_len.  D = 32 takes the JAX package's merged layout."""
    rng = _rng(5)
    Tr, Dr = 100, 32
    q, k, v, g = (_normal(rng, (B, Tr, H, Dr)) for _ in range(4))

    def jloss(q, k, v):
        return (jfa.flash_attention_auto(q, k, v) * jnp.asarray(g)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    want_o = jfa.flash_attention_auto(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_auto(*ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               rtol=0, atol=FWD_ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    for t, w_ in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                   **GRAD_TOL)


@pytest.mark.parametrize("T_", [8, 100, 128, 1024, 1032, 2048, 2176, 3000,
                                4096, 12288])
def test_block_helpers_match_jax(T_):
    assert tfa.auto_block(T_) == jfa.auto_block(T_)
    for bq in (8, 64, 512, 1024):
        assert tfa.bwd_kv_block(T_, bq) == jfa.bwd_kv_block(T_, bq)


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("T_,blocks,seq_len", [
    (100, (None, None, None, None), None),
    (128, (24, None, None, None), None),
    (128, (32, 32, 48, None), None),
    (128, (32, 32, None, None), 200),
    (128, (32, 32, None, None), 0),
])
def test_resolve_blocks_errors_match_jax(T_, blocks, seq_len):
    args = (T_, "flash_attention", *blocks, seq_len, "hint")
    assert _error(tfa._resolve_blocks, *args) == \
        _error(jfa._resolve_blocks, *args)


def test_resolve_blocks_values_match_jax():
    for args in [(128, "f", None, None, None, None, None, "h"),
                 (128, "f", 32, 64, None, 16, 128, "h"),
                 (2048, "f", None, None, None, None, 1000, "h")]:
        assert tfa._resolve_blocks(*args) == jfa._resolve_blocks(*args)


def test_entry_point_errors_match_jax():
    x = np.zeros((B, T, C), np.float32)
    bad_w = np.zeros((C, 3 * C + 3), np.float32)
    narrow_w = np.zeros((C, 3 * 2 * 64), np.float32)
    narrow_qkv = np.zeros((B, T, 3 * 2 * 64), np.float32)
    q = np.zeros((B, T, H, D), np.float32)
    cases = [
        (jfa.flash_qkv_proj, tfa.flash_qkv_proj, (x, bad_w, H), {}),
        (jfa.flash_qkv_proj, tfa.flash_qkv_proj, (x, narrow_w, 2), {}),
        (jfa.flash_attention_qkv, tfa.flash_attention_qkv,
         (narrow_qkv, 2), {}),
        (jfa.flash_attention_qkv, tfa.flash_attention_qkv,
         (narrow_qkv, 5), {}),
        (jfa.flash_attention, tfa.flash_attention, (q, q, q),
         dict(bwd_impl="bogus")),
        (jfa.flash_attention, tfa.flash_attention, (q, q, q),
         dict(block_q=24)),
        (jfa.flash_qkv_proj, tfa.flash_qkv_proj,
         (x, np.zeros((C, 3 * C), np.float32), H), dict(seq_len=300)),
    ]
    def conv(args, to):
        return [to(a) if isinstance(a, np.ndarray) else a for a in args]

    for jf, tf, args, kw in cases:
        want = _error(jf, *conv(args, jnp.asarray), interpret=True, **kw)
        got = _error(tf, *conv(args, torch.from_numpy), **kw)
        assert got == want


def test_unported_backward_forms_raise():
    """Every ``bwd_impl`` of the JAX package has a backward in the port;
    only a name that neither package has raises, as in the JAX package."""
    q = torch.zeros((B, T, H, D), requires_grad=True)
    for impl in ("pallas", "pallas_fused", "pallas_split", "xla"):
        q.grad = None
        tfa.flash_attention(q, q, q, bwd_impl=impl).sum().backward()
        assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="bwd_impl must be"):
        tfa.flash_attention(q, q, q, bwd_impl="pallas_grouped")


def _attention_grads(impl, D_, causal, seq_len, blocks, rng):
    """Gradients of ``flash_attention(bwd_impl=impl)`` from both packages
    on the same inputs and cotangent."""
    q, k, v, g = (_normal(rng, (B, T, H, D_)) for _ in range(4))
    kw = dict(causal=causal, seq_len=seq_len, bwd_impl=impl, **blocks)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, interpret=True, **kw)
                * jnp.asarray(g)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_attention(*ts, **kw) * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in ts], [np.asarray(w) for w in want]


@pytest.mark.parametrize("impl,D_,causal,seq_len,blocks", [
    ("pallas_fused", 128, True, None, dict(block_q=32, block_k=32)),
    ("pallas_fused", 64, False, 100, dict(bwd_block_q=32, bwd_block_k=64)),
    ("pallas_fused", 128, True, 72, dict(bwd_block_q=64, bwd_block_k=16)),
    ("xla", 128, True, None, dict(block_q=32, block_k=32)),
    ("xla", 64, True, 100, dict(bwd_block_q=64, bwd_block_k=32)),
    ("xla", 128, False, 72, dict(bwd_block_q=16, bwd_block_k=64)),
])
def test_bwd_impl_grads_match_jax(impl, D_, causal, seq_len, blocks):
    """``bwd_impl="pallas_fused"`` (JAX: ``_bwd_fused_kernel`` in
    interpret mode; the port: the one-pass plain version) and ``"xla"``
    (the chunked backward in both), with ``seq_len`` padding and uneven
    backward blocks."""
    got, want = _attention_grads(impl, D_, causal, seq_len, blocks,
                                 _rng(7))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def _spy_kernels(monkeypatch, module, names):
    """Record which of ``module``'s functions ``names`` run."""
    seen = []
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, spy)
    return seen


def _spy_plain(monkeypatch):
    calls = []
    for name, fn in list(tfa._PLAIN.items()):
        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setitem(tfa._PLAIN, name, spy)
    return calls


@pytest.mark.parametrize("entry,causal,seq_len", [
    ("proj", True, None), ("proj", True, 100),
    ("packed", False, None), ("packed", True, 72)])
def test_fullunroll_grads_match_jax(monkeypatch, entry, causal, seq_len):
    """Under ``HOROVOD_TPU_FLASH_BWD=fullunroll`` with blocks of 32 at
    T 128, JAX runs ``_bwd_kernel_fullunroll`` with n = 4 (called outside
    ``shard_map``, where interpret mode would take the split pair) and the
    port its one-pass backward; the gradients agree."""
    monkeypatch.setenv("HOROVOD_TPU_FLASH_BWD", "fullunroll")
    ran = _spy_kernels(monkeypatch, jfa, ["_bwd_kernel_fullunroll"])
    calls = _spy_plain(monkeypatch)
    rng = _rng(8)
    kw = dict(causal=causal, seq_len=seq_len, block_q=32, block_k=32)
    if entry == "proj":
        ins = [_normal(rng, (B, T, C)), _normal(rng, (C, 3 * C), C ** -0.5)]
        jfn = lambda x, w: jfa.flash_qkv_proj(x, w, H, interpret=True, **kw)
        tfn = lambda x, w: tfa.flash_qkv_proj(x, w, H, **kw)
        g = _normal(rng, (B, T, C))
    else:
        ins = [_normal(rng, (B, T, H, D)) for _ in range(3)]
        jfn = lambda *a: jfa.flash_attention(*a, interpret=True, **kw)
        tfn = lambda *a: tfa.flash_attention(*a, **kw)
        g = _normal(rng, (B, T, H, D))
    want = jax.grad(lambda *a: (jfn(*a) * jnp.asarray(g)).sum(),
                    argnums=tuple(range(len(ins))))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    (tfn(*ts) * torch.from_numpy(g)).sum().backward()
    assert ran and calls == ["flash_fwd", "flash_bwd_fused"]
    for t, w_ in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                   **GRAD_TOL)


# The backward kernel each JAX route traces first, by the form it is.
_JAX_FORMS = {"_bwd_kernel_fullunroll": "fused", "_bwd_fused_kernel": "fused",
              "_dkdv_kernel": "split", "_dkdv_kernel_grouped": "split",
              "_bwd_xla": "xla"}


@pytest.mark.parametrize("dtype,T_,D_,impl,env,bwd", [
    # bwd_impl="pallas_fused": the f32 dq scratch T * D * 4 <= 4 MiB.
    ("float32", 8192, 128, "pallas_fused", {}, None),
    ("float32", 16384, 128, "pallas_fused", {}, None),
    ("bfloat16", 16384, 64, "pallas_fused", {}, None),
    ("bfloat16", 32768, 64, "pallas_fused", {}, None),
    # The knob on the packed route: T * D * itemsize <= 512 KiB ...
    ("float32", 1024, 128, "pallas", {"FLASH_BWD": "fullunroll"}, None),
    ("float32", 2048, 128, "pallas", {"FLASH_BWD": "fullunroll"}, None),
    ("bfloat16", 2048, 128, "pallas", {"FLASH_BWD": "fullunroll"}, None),
    ("bfloat16", 4096, 128, "pallas", {"FLASH_BWD": "fullunroll"}, None),
    # ... T <= 4096, T // fbb <= 8 and T % fbb == 0 (fbb <= 512) ...
    ("bfloat16", 8192, 128, "pallas_split", {"FLASH_BWD": "fullunroll"},
     None),
    ("float32", 1024, 128, "pallas", {"FLASH_BWD": "fullunroll"}, 128),
    ("float32", 1024, 128, "pallas", {"FLASH_BWD": "fullunroll"}, 64),
    ("bfloat16", 1280, 128, "pallas", {"FLASH_BWD": "fullunroll"}, None),
    # ... D % 128 == 0, no head group, no merged layout, and the knob.
    ("float32", 1024, 64, "pallas", {"FLASH_BWD": "fullunroll"}, None),
    ("float32", 1024, 128, "pallas", {"FLASH_BWD_GROUP": "2",
                                      "FLASH_BWD": "fullunroll"}, None),
    ("float32", 1024, 128, "pallas", {"FLASH_PACKED_BWD": "0",
                                      "FLASH_BWD": "fullunroll"}, None),
    ("float32", 1024, 128, "pallas", {"FLASH_BWD": "split"}, None),
    ("float32", 1024, 128, "xla", {"FLASH_BWD": "fullunroll"}, None),
])
def test_bwd_form_matches_jax(monkeypatch, dtype, T_, D_, impl, env, bwd):
    """The port's routing function names the backward that the JAX
    package traces for the same call, at each of its size limits.  JAX
    is only traced (``jax.eval_shape``), never run, at these lengths."""
    for knob in ("FLASH_BWD", "FLASH_BWD_GROUP", "FLASH_PACKED_BWD"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    for knob, value in env.items():
        monkeypatch.setenv("HOROVOD_TPU_" + knob, value)
    seen = _spy_kernels(monkeypatch, jfa, list(_JAX_FORMS))
    H_ = 2
    blocks = {} if bwd is None else dict(bwd_block_q=bwd, bwd_block_k=bwd)
    x = jax.ShapeDtypeStruct((1, T_, H_, D_), jnp.dtype(dtype))

    def loss(q, k, v):
        return jfa.flash_attention(q, k, v, interpret=True, bwd_impl=impl,
                                   **blocks).astype(jnp.float32).sum()

    jax.eval_shape(jax.grad(loss, argnums=(0, 1, 2)), x, x, x)
    _, _, bq, bk, _ = tfa._resolve_blocks(T_, "f", None, None, bwd, bwd,
                                          None, "")
    itemsize = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    assert seen and tfa._bwd_form(impl, T_, D_, itemsize, bq, bk, H_) == \
        _JAX_FORMS[seen[0]]


@pytest.mark.parametrize("dtype,causal,seq_len", [
    (torch.float32, True, None), (torch.float32, False, 40),
    (torch.bfloat16, True, 50)])
def test_fused_plain_equals_split_plain(dtype, causal, seq_len):
    """The one-pass plain version computes the split pair's arithmetic in
    the same order: bit for bit the same dq, dk and dv."""
    rng = _rng(9)
    qkv = torch.from_numpy(_normal(rng, (2, 64, 3 * C))).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    do = torch.from_numpy(_normal(rng, (2, 64, C))).to(dtype)
    kw = dict(scale=D ** -0.5, causal=causal, seq_len=seq_len)
    o, lse = tfa._flash_fwd_plain(q, k, v, H, **kw)
    delta = tfa._delta(do, o, H)
    dq, dk, dv = tfa._flash_bwd_fused_plain(q, k, v, do, lse, delta, H,
                                            **kw)
    dk2, dv2 = tfa._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, H, **kw)
    dq2 = tfa._flash_bwd_dq_plain(q, k, v, do, lse, delta, H, **kw)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert a.dtype == dtype and torch.equal(a, b)


def test_dispatch_sends_cpu_tensors_to_plain_versions(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_FLASH_BWD", raising=False)
    calls = _spy_plain(monkeypatch)

    def fail(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    for name in tfa._PLAIN:
        monkeypatch.setattr(_cuda, name, fail)
    x = torch.randn(1, 64, 3 * C, requires_grad=True)
    tfa.flash_attention_qkv(x, H).sum().backward()
    assert calls == ["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"]


def test_fullunroll_knob_sends_cpu_backward_to_fused(monkeypatch):
    """Under the knob the CPU backward takes the one-pass plain version,
    and no CUDA wrapper; read at backward time, as in the JAX package."""
    calls = _spy_plain(monkeypatch)

    def fail(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    for name in tfa._PLAIN:
        monkeypatch.setattr(_cuda, name, fail)
    x = torch.randn(1, 64, 3 * C, requires_grad=True)
    out = tfa.flash_attention_qkv(x, H)
    monkeypatch.setenv("HOROVOD_TPU_FLASH_BWD", "fullunroll")
    out.sum().backward()
    assert calls == ["flash_fwd", "flash_bwd_fused"]


def test_dispatch_has_no_fallback():
    """No ``try`` around the kernel path: the dispatcher, the kernel
    wrappers of both families and the rule that picks the family contain
    no exception handler at all."""
    for fn in (tfa._dispatch, _cuda.flash_fwd, _cuda.flash_bwd_dkdv,
               _cuda.flash_bwd_dq, _cuda.flash_bwd_fused, _cuda._lib,
               _cuda.flash_family, _cuda._inputs, _cuda._view,
               _cuda._launch, _cuda._general_bwd):
        tree = ast.parse(inspect.getsource(fn).strip())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], \
            fn.__name__


@pytest.mark.parametrize("dtype,D_", [(torch.float32, 8),
                                      (torch.float16, 128),
                                      (torch.bfloat16, 200)])
@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq", "flash_bwd_fused"])
def test_general_wrappers_refuse_cpu_tensors(name, dtype, D_):
    """Inputs of the general family reach the same wrappers, which raise
    on a CPU tensor before they build anything."""
    x = torch.zeros((1, 64, H * D_), dtype=dtype)
    assert _cuda.flash_family(dtype, D_, x.stride(), x.data_ptr()) == \
        "general"
    rows = torch.zeros((1, H, 64))
    args = (x, x, x) if name == "flash_fwd" else (x, x, x, x, rows, rows)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(_cuda, name)(*args, H, scale=1.0, causal=True)


@pytest.mark.parametrize("D_,causal,seq_len", [(8, True, None),
                                               (8, False, 50),
                                               (200, True, 40),
                                               (300, True, 40),
                                               (384, True, None)])
def test_general_head_sizes_match_jax(D_, causal, seq_len):
    """Head sizes the Hopper kernels do not take (8, 200; 300 and 384 on
    the wide route): the plain versions, which the general family G1-G3
    (W1-W3) computes on the card, against
    the JAX kernels in interpret mode, forward and gradients."""
    rng = _rng(11)
    Tg = 64
    q, k, v, g = (_normal(rng, (B, Tg, H, D_)) for _ in range(4))
    kw = dict(causal=causal, seq_len=seq_len, block_q=32, block_k=32)

    def jfn(q, k, v):
        return jfa.flash_attention(q, k, v, interpret=True, **kw)

    want_o = jfn(*map(jnp.asarray, (q, k, v)))
    want = jax.grad(lambda *a: (jfn(*a) * jnp.asarray(g)).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               rtol=0, atol=FWD_ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    for t, w_ in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                   **GRAD_TOL)


_GROUP_WARNING = ("HOROVOD_TPU_FLASH_BWD_GROUP={!r} is not a positive "
                  "integer; using the per-head default (1)")


def _jax_bwd_warnings(D_):
    """The warnings the JAX package raises while it traces the backward
    of ``flash_attention`` at head size ``D_`` (T 128, two heads)."""
    x = jax.ShapeDtypeStruct((1, 128, H, D_), jnp.float32)

    def loss(q, k, v):
        return jfa.flash_attention(q, k, v, interpret=True).sum()

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        jax.eval_shape(jax.grad(loss, argnums=(0, 1, 2)), x, x, x)
    return [str(w.message) for w in seen
            if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("value", ["x", "0", "-2", "1.5"])
def test_malformed_bwd_group_warns_like_jax(monkeypatch, value):
    """A value of ``HOROVOD_TPU_FLASH_BWD_GROUP`` that is not an integer
    >= 1 warns on the head-packed backward, with the JAX package's text,
    and the backward runs per head."""
    monkeypatch.delenv("HOROVOD_TPU_FLASH_BWD", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_FLASH_PACKED_BWD", raising=False)
    monkeypatch.setenv("HOROVOD_TPU_FLASH_BWD_GROUP", value)
    text = _GROUP_WARNING.format(value)
    with pytest.warns(RuntimeWarning) as seen:
        form = tfa._bwd_form("pallas", 128, 128, 4, 128, 128, H)
    assert form == "split"
    assert [str(w.message) for w in seen] == [text]
    assert _jax_bwd_warnings(128) == [text]


@pytest.mark.parametrize("value,D_,packed", [("2", 128, None),
                                             ("x", 64, None),
                                             ("x", 128, "0")])
def test_bwd_group_is_silent_where_jax_is(monkeypatch, value, D_, packed):
    """No warning for a well-formed group, off the head-packed route
    (D % 128 != 0), or with ``HOROVOD_TPU_FLASH_PACKED_BWD=0``, in
    either package."""
    monkeypatch.delenv("HOROVOD_TPU_FLASH_BWD", raising=False)
    monkeypatch.setenv("HOROVOD_TPU_FLASH_BWD_GROUP", value)
    if packed is None:
        monkeypatch.delenv("HOROVOD_TPU_FLASH_PACKED_BWD", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_FLASH_PACKED_BWD", packed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tfa._bwd_form("pallas", 128, D_, 4, 128, 128, H)
    assert _jax_bwd_warnings(D_) == []


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq", "flash_bwd_fused"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper never computes on the CPU: it raises before it
    builds anything."""
    x = torch.zeros((1, 64, C), dtype=torch.bfloat16)
    rows = torch.zeros((1, H, 64))
    args = (x, x, x) if name == "flash_fwd" else (x, x, x, x, rows, rows)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(_cuda, name)(*args, H, scale=1.0, causal=True)


def test_plain_versions_keep_kernel_cast_points():
    """In bf16 the plain versions round p (and ds) to bf16 before their
    products, as the kernels do: they differ from the f32 result by
    more than rounding the output alone would."""
    rng = _rng(6)
    qkv = torch.from_numpy(_normal(rng, (1, 64, 3 * C)))
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    kw = dict(scale=D ** -0.5, causal=True)
    o32, _ = tfa._flash_fwd_plain(q, k, v, H, **kw)
    bf = qkv.to(torch.bfloat16)
    o16, lse16 = tfa._flash_fwd_plain(bf[..., :C], bf[..., C:2 * C],
                                      bf[..., 2 * C:], H, **kw)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    # Same bf16 inputs in f32: only the cast of p separates the two.
    o_ref, _ = tfa._flash_fwd_plain(*(t.float() for t in (
        bf[..., :C], bf[..., C:2 * C], bf[..., 2 * C:])), H, **kw)
    assert not torch.equal(o16, o_ref.to(torch.bfloat16))
    assert (o16.float() - o_ref).abs().max() < 2e-2
    assert (o16.float() - o32).abs().max() < 5e-2
