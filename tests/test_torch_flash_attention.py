"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through ``horovod_tpu.ops.flash_attention`` (Pallas
in interpret mode) and ``horovod_tpu_torch.ops.flash_attention``, whose CPU
path is the plain PyTorch version of each kernel; the CUDA kernels are held
against those plain versions on the card by ``chip_smoke.py``.  Everything
is f32.  Tolerances: 2e-5 on o and lse (the two sum the same terms in
another order); 1e-4 absolute and relative on gradients, which add one
more reassociated product.
"""

import ast
import inspect

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
    q = torch.zeros((B, T, H, D))
    for impl in ("pallas_fused", "xla"):
        with pytest.raises(NotImplementedError):
            tfa.flash_attention(q, q, q, bwd_impl=impl)


def test_dispatch_sends_cpu_tensors_to_plain_versions(monkeypatch):
    calls = []
    for name, fn in list(tfa._PLAIN.items()):
        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setitem(tfa._PLAIN, name, spy)

    def fail(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    for name in tfa._PLAIN:
        monkeypatch.setattr(_cuda, name, fail)
    x = torch.randn(1, 64, 3 * C, requires_grad=True)
    tfa.flash_attention_qkv(x, H).sum().backward()
    assert calls == ["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"]


def test_dispatch_has_no_fallback():
    """No ``try`` around the kernel path: the dispatcher and the kernel
    wrappers contain no exception handler at all."""
    for fn in (tfa._dispatch, _cuda.flash_fwd, _cuda.flash_bwd_dkdv,
               _cuda.flash_bwd_dq, _cuda._lib):
        tree = ast.parse(inspect.getsource(fn).strip())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], \
            fn.__name__


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq"])
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
