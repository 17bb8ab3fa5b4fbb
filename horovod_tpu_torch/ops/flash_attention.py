"""Flash attention on hand-written Hopper kernels.

Port of ``horovod_tpu/ops/flash_attention.py:1406-1812``: the entry points
``flash_qkv_proj``, ``flash_attention_qkv``, ``flash_attention`` and
``flash_attention_auto``, the block helpers ``auto_block``,
``bwd_kv_block`` and ``_resolve_blocks``, and the custom-vjp wrappers,
here the autograd Functions ``_FlashQKVProj``, ``_FlashQKV`` and
``_FlashPacked``.

Two families of kernels carry it (``csrc/``, built by :mod:`._cuda`).
The Hopper kernels (wgmma and TMA, bfloat16 at a head size that is a
multiple of 16 up to 128):

* ``flash_fwd`` (P1) replaces the three Pallas forward forms
  (``_fwd_kernel``, ``_fwd_kernel_unrollkv``, ``_fwd_kernel_fullunroll``);
* ``flash_bwd_dkdv`` (P2) replaces ``_dkdv_kernel`` and its head-grouped
  form;
* ``flash_bwd_dq`` (P3) replaces ``_dq_kernel`` and its head-grouped form;
* ``flash_bwd_fused`` (P6) replaces the one-pass backwards
  ``_bwd_fused_kernel`` and ``_bwd_kernel_fullunroll``.

The general family G1-G3 (``csrc/flash_general.cu``: TF32 ``mma.sync``,
three products a term for float32) computes what P1, P2 and P3 compute for everything else
the JAX package runs: float32 and float16 at any head size up to 256,
bfloat16 at the other head sizes up to 256.  Its wide route W1-W3
(``csrc/flash_wide.cu``: W1 and W2 on the same TF32 ``mma.sync`` with D
in column steps, W3 FFMA, one row a block) takes every dtype at head
sizes above 256, up to ``_cuda.WIDE_MAX_D``.
``_cuda.flash_family`` picks the family from the dtype and the head size;
each wrapper of :mod:`._cuda` obeys it, and the one-pass wrapper runs
G2 + G3 (W2 + W3) for the general family.

Which backward runs is :func:`_bwd_form`'s choice, made at backward time
with the JAX package's conditions: the split pair P2 + P3, the one-pass
P6, or the chunked ``"xla"`` backward :func:`_bwd_xla`, which is plain
PyTorch on every device as it is plain XLA in the JAX package.

Every kernel reads q, k and v from (B, T, H*D) views with unit column
stride and any row stride, so the three may be column regions of ONE fused
(B, T, 3C) projection (the ``head_base = (0, H, 2H)`` design of
``_fwd_packed``): the projection is never split or transposed in memory,
and the backward writes dq, dk and dv straight into the three column
regions of one (B, T, 3C) gradient.  lse is a contiguous (B, H, T) f32
tensor.

Beside each kernel is a plain PyTorch version of the same signature
(``_flash_fwd_plain``, ``_flash_bwd_dkdv_plain``, ``_flash_bwd_dq_plain``,
``_flash_bwd_fused_plain``) that computes in f32 with the same masking,
cast points and clamps, and materialises the (T, T) scores one batch
element at a time.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

The TPU block sizes mean nothing to the Hopper kernels, which choose their
own 64-row tiles; ``block_q``/``block_k`` and their backward twins are
still validated by ``_resolve_blocks`` so that callers get the JAX
package's errors.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops.matmul import mm_f32
from horovod_tpu_torch.parallel.ring_attention import _NEG_BIG


# --------------------------------------------------------------------------
# Plain versions of the four kernels.


def _visible(T: int, causal: bool, seq_len: Optional[int], device):
    """(T, T) mask of ``_block_mask``: causal, plus ``seq_len`` on rows and
    columns."""
    pos = torch.arange(T, device=device)
    ok = torch.ones((T, T), dtype=torch.bool, device=device)
    if causal:
        ok = pos[None, :] <= pos[:, None]
    if seq_len is not None:
        real = pos < seq_len
        ok = ok & real[:, None] & real[None, :]
    return ok


def _heads(x: torch.Tensor, b: int, num_heads: int) -> torch.Tensor:
    """Batch element ``b`` of a (B, T, H*D) view as (H, T, D) f32."""
    return x[b].unflatten(-1, (num_heads, -1)).transpose(0, 1).float()


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(H, T, D) -> (T, H*D)."""
    return x.transpose(0, 1).flatten(1)


def _flash_fwd_plain(q, k, v, num_heads: int, *, scale: float,
                     causal: bool, seq_len: Optional[int] = None):
    """Plain version of ``flash_fwd``: returns o (B, T, H*D) in q's dtype
    and lse (B, H, T) f32."""
    B, T, C = q.shape
    H = num_heads
    ok = _visible(T, causal, seq_len, q.device)
    o = torch.empty((B, T, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    for b in range(B):
        s = _heads(q, b, H) @ _heads(k, b, H).transpose(1, 2) * scale
        s = torch.where(ok, s, _NEG_BIG)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = p.to(v.dtype).float() @ _heads(v, b, H)
        o[b] = _merge(acc / l).to(o.dtype)
        lse[b] = (m + torch.log(l))[..., 0]
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, b, num_heads, scale, ok):
    """One batch element's p = exp(s - lse) (0 where masked) and
    ds = p * (dO V^T - delta) * scale, all (H, T, T) f32."""
    H = num_heads
    qf, kf, vf, dof = (_heads(x, b, H) for x in (q, k, v, do))
    s = qf @ kf.transpose(1, 2) * scale
    p = torch.where(ok, torch.exp(s - lse[b][..., None]), 0.0)
    dp = dof @ vf.transpose(1, 2)
    ds = p * (dp - delta[b][..., None]) * scale
    return qf, kf, dof, p, ds


def _flash_bwd_dkdv_plain(q, k, v, do, lse, delta, num_heads: int, *,
                          scale: float, causal: bool,
                          seq_len: Optional[int] = None, dk=None, dv=None):
    """Plain version of ``flash_bwd_dkdv``: dv = bf16(p)^T dO and
    dk = bf16(ds)^T q, written into ``dk``/``dv`` (new tensors when
    None)."""
    B, T, C = q.shape
    ok = _visible(T, causal, seq_len, q.device)
    dk = torch.empty((B, T, C), dtype=k.dtype, device=k.device) \
        if dk is None else dk
    dv = torch.empty((B, T, C), dtype=v.dtype, device=v.device) \
        if dv is None else dv
    for b in range(B):
        qf, _, dof, p, ds = _probs_and_ds(q, k, v, do, lse, delta, b,
                                          num_heads, scale, ok)
        dv[b] = _merge(p.to(do.dtype).float().transpose(1, 2) @ dof
                       ).to(dv.dtype)
        dk[b] = _merge(ds.to(q.dtype).float().transpose(1, 2) @ qf
                       ).to(dk.dtype)
    return dk, dv


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, num_heads: int, *,
                        scale: float, causal: bool,
                        seq_len: Optional[int] = None, dq=None):
    """Plain version of ``flash_bwd_dq``: dq = bf16(ds) k, written into
    ``dq`` (a new tensor when None)."""
    B, T, C = q.shape
    ok = _visible(T, causal, seq_len, q.device)
    dq = torch.empty((B, T, C), dtype=q.dtype, device=q.device) \
        if dq is None else dq
    for b in range(B):
        _, kf, _, _, ds = _probs_and_ds(q, k, v, do, lse, delta, b,
                                        num_heads, scale, ok)
        dq[b] = _merge(ds.to(k.dtype).float() @ kf).to(dq.dtype)
    return dq


def _flash_bwd_fused_plain(q, k, v, do, lse, delta, num_heads: int, *,
                           scale: float, causal: bool,
                           seq_len: Optional[int] = None, dq=None, dk=None,
                           dv=None):
    """Plain version of ``flash_bwd_fused``: dq, dk and dv from one
    computation of p and ds per batch element, with the cast points of the
    split pair, written into ``dq``/``dk``/``dv`` (new tensors when
    None)."""
    B, T, C = q.shape
    ok = _visible(T, causal, seq_len, q.device)
    dq = torch.empty((B, T, C), dtype=q.dtype, device=q.device) \
        if dq is None else dq
    dk = torch.empty((B, T, C), dtype=k.dtype, device=k.device) \
        if dk is None else dk
    dv = torch.empty((B, T, C), dtype=v.dtype, device=v.device) \
        if dv is None else dv
    for b in range(B):
        qf, kf, dof, p, ds = _probs_and_ds(q, k, v, do, lse, delta, b,
                                           num_heads, scale, ok)
        dv[b] = _merge(p.to(do.dtype).float().transpose(1, 2) @ dof
                       ).to(dv.dtype)
        dk[b] = _merge(ds.to(q.dtype).float().transpose(1, 2) @ qf
                       ).to(dk.dtype)
        dq[b] = _merge(ds.to(k.dtype).float() @ kf).to(dq.dtype)
    return dq, dk, dv


_PLAIN = {
    "flash_fwd": _flash_fwd_plain,
    "flash_bwd_dkdv": _flash_bwd_dkdv_plain,
    "flash_bwd_dq": _flash_bwd_dq_plain,
    "flash_bwd_fused": _flash_bwd_fused_plain,
}


def _dispatch(name: str, q: torch.Tensor, *args, **kwargs):
    """Run flash kernel ``name`` on the device of ``q``: a CUDA tensor
    launches the kernel (which raises on anything it does not take), a CPU
    tensor takes the plain version, any other device raises."""
    if q.device.type == "cuda":
        return getattr(_cuda, name)(q, *args, **kwargs)
    if q.device.type == "cpu":
        return _PLAIN[name](q, *args, **kwargs)
    raise ValueError(f"{name}: no flash kernel for device {q.device}")


# --------------------------------------------------------------------------
# Autograd Functions.


def _delta(do: torch.Tensor, o: torch.Tensor, num_heads: int):
    """Per-head rowsum(dO * O) as a contiguous (B, H, T) f32 tensor."""
    return ((do.float() * o.float()).unflatten(-1, (num_heads, -1))
            .sum(-1).transpose(1, 2).contiguous())


# The JAX package's limits on its one-pass backwards
# (horovod_tpu/ops/flash_attention.py:477, :486-488, :855).  They bound
# TPU VMEM there; here they only decide which backward runs, so that both
# packages take the same form for the same call.
_FUSED_DQ_SCRATCH_BYTES = 4 << 20
_FULL_UNROLL_BWD_MAX_BYTES = 512 << 10
_FULL_UNROLL_MAX_T = 4096
_FULL_UNROLL_BLOCK = 512
_FULL_UNROLL_MAX_NQ = 8


class _Cfg(NamedTuple):
    """What a backward needs besides the saved tensors."""
    num_heads: int
    scale: float
    causal: bool
    seq_len: Optional[int]
    bwd_impl: str
    bwd_block_q: int
    bwd_block_k: int


def _bwd_group(num_heads: int) -> int:
    """The head group of ``_bwd_pallas_packed`` when
    ``HOROVOD_TPU_FLASH_BWD_GROUP`` is set.  A value that is not an
    integer >= 1 warns as the JAX package does
    (``flash_attention.py:1266-1277``) and means 1.  Its automatic group
    stands down whenever ``HOROVOD_TPU_FLASH_BWD`` is set, so only the
    knob can shadow the one-pass form."""
    group_env = os.environ.get("HOROVOD_TPU_FLASH_BWD_GROUP")
    if group_env is None:
        return 1
    try:
        group = int(group_env)
        if group < 1:
            raise ValueError
    except ValueError:
        warnings.warn(
            f"HOROVOD_TPU_FLASH_BWD_GROUP={group_env!r} is not a "
            "positive integer; using the per-head default (1)",
            RuntimeWarning, stacklevel=2)
        return 1
    return group if group > 1 and num_heads % group == 0 else 1


def _bwd_form(bwd_impl: str, T: int, D: int, itemsize: int,
              bwd_block_q: int, bwd_block_k: int, num_heads: int) -> str:
    """The backward the JAX package runs for this call: ``"fused"`` (the
    one-pass P6), ``"split"`` (P2 + P3) or ``"xla"``.  The knobs are read
    now, at backward time, as the JAX package reads them.

    ``bwd_impl="pallas_fused"`` takes the merged ``_flash`` route there
    and runs ``_bwd_fused_kernel`` while the f32 dq scratch fits
    (``_flash_bwd`` :1592-1597); ``"pallas"``/``"pallas_split"`` with
    D % 128 != 0 take the merged split pair, which never reads a knob.
    The head-packed route (D % 128 == 0: ``flash_attention``,
    ``flash_attention_qkv``, ``flash_qkv_proj``) runs
    ``_bwd_kernel_fullunroll`` only under
    ``HOROVOD_TPU_FLASH_BWD=fullunroll`` within its size limits
    (``_bwd_pallas_packed`` :1231-1318)."""
    if bwd_impl == "xla":
        return "xla"
    if bwd_impl == "pallas_fused":
        return "fused" if T * D * 4 <= _FUSED_DQ_SCRATCH_BYTES else "split"
    if D % 128:
        return "split"
    if os.environ.get("HOROVOD_TPU_FLASH_PACKED_BWD", "1") == "0" \
            or _bwd_group(num_heads) > 1:
        return "split"
    fbb = min(_FULL_UNROLL_BLOCK, bwd_block_q, bwd_block_k, T)
    if (os.environ.get("HOROVOD_TPU_FLASH_BWD") == "fullunroll"
            and T <= _FULL_UNROLL_MAX_T and T % fbb == 0
            and T // fbb <= _FULL_UNROLL_MAX_NQ
            and T * D * itemsize <= _FULL_UNROLL_BWD_MAX_BYTES):
        return "fused"
    return "split"


def _bwd_xla(q, k, v, o, lse, do, num_heads: int, *, scale: float,
             causal: bool, chunk: int, seq_len: Optional[int] = None,
             dq=None, dk=None, dv=None):
    """Port of ``_bwd_xla`` (``flash_attention.py:629``): the flash
    backward as f32 products over KV chunks of width ``chunk``, from the
    saved lse.  dq accumulates across the chunks; dk and dv are computed
    per chunk.  Plain PyTorch on every device, as it is plain XLA in the
    JAX package.  Results in the dtypes of q, k and v, written into
    ``dq``/``dk``/``dv`` when given."""
    T = q.shape[1]

    def heads(x):   # (B, T, H*D) -> (B, H, T, D) f32
        return x.unflatten(-1, (num_heads, -1)).transpose(1, 2).float()

    qf, kf, vf, dof = (heads(x) for x in (q, k, v, do))
    delta = _delta(do, o, num_heads)[..., None]              # (B, H, T, 1)
    lse = lse[..., None]
    rows = torch.arange(T, device=q.device)
    dqf = torch.zeros_like(qf)
    dks, dvs = [], []
    for start in range(0, T, chunk):
        ks = kf[:, :, start:start + chunk]
        vs = vf[:, :, start:start + chunk]
        cols = rows[start:start + chunk]
        s = qf @ ks.transpose(-1, -2) * scale
        mask = None
        if causal:
            mask = cols[None, :] <= rows[:, None]
        if seq_len is not None:
            lim = (rows[:, None] < seq_len) & (cols[None, :] < seq_len)
            mask = lim if mask is None else mask & lim
        if mask is not None:
            s = torch.where(mask, s, _NEG_BIG)
        p = torch.exp(s - lse)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dp = dof @ vs.transpose(-1, -2)
        ds = p * (dp - delta) * scale
        dqf = dqf + ds @ ks
        dks.append(ds.transpose(-1, -2) @ qf)
        dvs.append(p.transpose(-1, -2) @ dof)
    outs = []
    for g, like, out in ((dqf, q, dq), (torch.cat(dks, 2), k, dk),
                         (torch.cat(dvs, 2), v, dv)):
        g = g.transpose(1, 2).flatten(2).to(like.dtype)
        outs.append(g if out is None else out.copy_(g))
    return tuple(outs)


def _flash_bwd(q, k, v, o, lse, do, cfg: _Cfg, dq=None, dk=None, dv=None):
    do = do.contiguous()
    H = cfg.num_heads
    T, D = q.shape[1], q.shape[2] // H
    form = _bwd_form(cfg.bwd_impl, T, D, q.element_size(), cfg.bwd_block_q,
                     cfg.bwd_block_k, H)
    kw = dict(scale=cfg.scale, causal=cfg.causal, seq_len=cfg.seq_len)
    if form == "xla":
        return _bwd_xla(q, k, v, o, lse, do, H, chunk=cfg.bwd_block_k,
                        dq=dq, dk=dk, dv=dv, **kw)
    delta = _delta(do, o, H)
    if form == "fused":
        return _dispatch("flash_bwd_fused", q, k, v, do, lse, delta, H,
                         dq=dq, dk=dk, dv=dv, **kw)
    dk, dv = _dispatch("flash_bwd_dkdv", q, k, v, do, lse, delta, H,
                       dk=dk, dv=dv, **kw)
    dq = _dispatch("flash_bwd_dq", q, k, v, do, lse, delta, H, dq=dq, **kw)
    return dq, dk, dv


def _split3(x: torch.Tensor):
    """The q | k | v column regions of a (B, T, 3C) tensor, as views."""
    C = x.shape[-1] // 3
    return x[..., :C], x[..., C:2 * C], x[..., 2 * C:]


def _forward(q, k, v, cfg: _Cfg):
    return _dispatch("flash_fwd", q, k, v, cfg.num_heads, scale=cfg.scale,
                     causal=cfg.causal, seq_len=cfg.seq_len)


class _FlashPacked(torch.autograd.Function):
    """Flash attention on three (B, T, H*D) tensors (``_flash_packed``,
    and ``_flash`` for the backwards that the JAX package runs on merged
    views)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        o, lse = _forward(q, k, v, cfg)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, ctx.cfg)
        return dq, dk, dv, None


class _FlashQKV(torch.autograd.Function):
    """Flash attention off one fused (B, T, 3C) projection
    (``_flash_qkv``); the gradient is one (B, T, 3C) tensor written by the
    kernels in place of the JAX package's concatenate."""

    @staticmethod
    def forward(ctx, qkv, cfg):
        o, lse = _forward(*_split3(qkv), cfg)
        ctx.save_for_backward(qkv, o, lse)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        _flash_bwd(*_split3(qkv), o, lse, do, ctx.cfg, *_split3(dqkv))
        return dqkv, None


class _FlashQKVProj(torch.autograd.Function):
    """``x @ w`` followed by flash attention (``_flash_qkv_proj``).  The
    (B, T, 3C) projection is not saved: the backward recomputes it from
    (x, w), one extra product in exchange for never holding it."""

    @staticmethod
    def forward(ctx, x, w, cfg):
        o, lse = _forward(*_split3(x @ w.to(x.dtype)), cfg)
        ctx.save_for_backward(x, w, o, lse)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        x, w, o, lse = ctx.saved_tensors
        wc = w.to(x.dtype)
        qkv = x @ wc
        dqkv = torch.empty_like(qkv)
        _flash_bwd(*_split3(qkv), o, lse, do, ctx.cfg, *_split3(dqkv))
        del qkv
        dx = (dqkv @ wc.t()).to(x.dtype)
        dw = mm_f32(x.reshape(-1, x.shape[-1]).t(),
                    dqkv.reshape(-1, dqkv.shape[-1])).to(w.dtype)
        return dx, dw, None


# --------------------------------------------------------------------------
# Block helpers (kept for their signatures and errors).


def auto_block(T: int) -> int:
    """The JAX package's TPU flash block for sequence length ``T``: ``T``
    itself when one multiple-of-8 block covers it, else the largest
    multiple-of-128 divisor up to 1024 unless that halves the block, else
    the largest multiple-of-8 divisor.  0 = cannot tile.  The Hopper
    kernels use their own tiles; this decides padding and the model's
    fused-projection path exactly as in the JAX package."""
    if T <= 1024:
        return T if T % 8 == 0 else 0
    aligned = max((d for d in range(128, 1025, 128) if T % d == 0),
                  default=0)
    any8 = max((d for d in range(8, 1025, 8) if T % d == 0), default=0)
    if aligned and aligned * 2 >= any8:
        return aligned
    return any8


def _resolve_blocks(T: int, fn_name: str, block_q, block_k, bwd_block_q,
                    bwd_block_k, seq_len, pad_hint: str):
    """Block defaulting and validation shared by the entry points, with the
    JAX package's rules and error messages.  Returns the four resolved
    blocks and the normalised seq_len (None when it equals T)."""
    if block_q is None or block_k is None:
        blk = auto_block(T)
        if blk == 0:
            raise ValueError(
                f"{fn_name}: sequence length {T} has no multiple-of-8 "
                f"block divisor; {pad_hint}")
        block_q = blk if block_q is None else block_q
        block_k = blk if block_k is None else block_k
    block_q = min(block_q, T)
    block_k = min(block_k, T)
    bwd_block_q = block_q if bwd_block_q is None else min(bwd_block_q, T)
    bwd_block_k = block_k if bwd_block_k is None else min(bwd_block_k, T)
    for name, b in (("block_q", block_q), ("block_k", block_k),
                    ("bwd_block_q", bwd_block_q),
                    ("bwd_block_k", bwd_block_k)):
        if T % b or b % 8:
            raise ValueError(
                f"{fn_name}: {name}={b} must divide T={T} and be a "
                f"multiple of 8 (Mosaic sublane tiling); {pad_hint}")
    if seq_len is not None and not 0 < seq_len <= T:
        raise ValueError(f"{fn_name}: seq_len {seq_len} out of range "
                         f"for T={T}")
    if seq_len == T:
        seq_len = None
    return (int(block_q), int(block_k), int(bwd_block_q),
            int(bwd_block_k), seq_len)


def bwd_kv_block(T: int, block_q: int) -> int:
    """Widest backward KV block within the JAX package's f32 scores-tile
    budget ``block_q * block_k <= 2**20`` (a tuning helper kept for its
    signature)."""
    budget = (1 << 20) // max(block_q, 1)
    return max((d for d in range(8, min(budget, T) + 1, 8) if T % d == 0),
               default=block_q)


# --------------------------------------------------------------------------
# Entry points.


def flash_qkv_proj(x, w, num_heads: int, *, causal: bool = True,
                   scale: Optional[float] = None,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None,
                   bwd_block_q: Optional[int] = None,
                   bwd_block_k: Optional[int] = None,
                   seq_len: Optional[int] = None):
    """Fused qkv projection and flash attention: ``x @ w`` -> causal flash
    -> head-merged (B, T, C) output, with the projection recomputed in the
    backward instead of saved.  ``w`` is the (C, 3C) no-bias qkv kernel
    (q | k | v, head-major); the products run in ``x.dtype``, and dw comes
    back in ``w.dtype`` from an f32 product."""
    B, T, _ = x.shape
    C3 = w.shape[1]
    if w.shape[0] != x.shape[2] or C3 % (3 * num_heads):
        raise ValueError(
            f"flash_qkv_proj: w must be (C, 3*num_heads*D), got "
            f"{tuple(w.shape)} for x {tuple(x.shape)}, "
            f"num_heads={num_heads}")
    D = C3 // (3 * num_heads)
    if D % 128:
        raise ValueError(
            f"flash_qkv_proj needs lane-aligned heads (D % 128 == 0), "
            f"got D={D}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    _, _, bwd_block_q, bwd_block_k, seq_len = _resolve_blocks(
        T, "flash_qkv_proj", block_q, block_k, bwd_block_q, bwd_block_k,
        seq_len, "pad the sequence to a tileable length")
    return _FlashQKVProj.apply(x, w, _Cfg(
        int(num_heads), float(scale), bool(causal), seq_len, "pallas",
        bwd_block_q, bwd_block_k))


def flash_attention_qkv(qkv, num_heads: int, *, causal: bool = True,
                        scale: Optional[float] = None,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        bwd_block_q: Optional[int] = None,
                        bwd_block_k: Optional[int] = None,
                        seq_len: Optional[int] = None):
    """Flash attention straight off a fused (B, T, 3C) qkv projection
    (q | k | v, each head-major); returns the head-merged (B, T, C)
    output.  The kernels read q/k/v as column regions of the same tensor."""
    B, T, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(
            f"flash_attention_qkv: last dim {C3} must be 3*num_heads*D, "
            f"got num_heads={num_heads}")
    D = C3 // (3 * num_heads)
    if D % 128:
        raise ValueError(
            f"flash_attention_qkv needs lane-aligned heads (D % 128 == "
            f"0), got D={D}; split the projection and use "
            f"flash_attention instead")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    _, _, bwd_block_q, bwd_block_k, seq_len = _resolve_blocks(
        T, "flash_attention_qkv", block_q, block_k, bwd_block_q,
        bwd_block_k, seq_len, "pad, or split and use flash_attention_auto")
    return _FlashQKV.apply(qkv, _Cfg(
        int(num_heads), float(scale), bool(causal), seq_len, "pallas",
        bwd_block_q, bwd_block_k))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    bwd_block_q: Optional[int] = None,
                    bwd_block_k: Optional[int] = None,
                    bwd_impl: str = "pallas",
                    seq_len: Optional[int] = None):
    """Flash attention for (B, T, H, D) inputs, the contract of
    :func:`~horovod_tpu_torch.parallel.ring_attention.full_attention`.

    ``seq_len``: real length when the inputs are zero-padded to ``T``;
    positions past it are masked on rows and columns.  ``bwd_impl``:
    ``"pallas"``/``"pallas_split"`` is the split dk/dv + dq kernel pair
    (the one-pass kernel under ``HOROVOD_TPU_FLASH_BWD=fullunroll``, as in
    the JAX package), ``"pallas_fused"`` the one-pass kernel while the
    JAX package's 4 MiB f32 dq bound (T * D * 4 bytes) holds and the
    split pair past it, ``"xla"`` the chunked backward over KV chunks of
    ``bwd_block_k`` (:func:`_bwd_xla`)."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if bwd_impl not in ("pallas", "pallas_fused", "pallas_split", "xla"):
        raise ValueError(f"bwd_impl must be 'pallas' (auto fused/split), "
                         f"'pallas_fused', 'pallas_split' or 'xla', got "
                         f"{bwd_impl!r}")
    _, _, bwd_block_q, bwd_block_k, seq_len = _resolve_blocks(
        T, "flash_attention", block_q, block_k, bwd_block_q, bwd_block_k,
        seq_len, "T divisible by the blocks is required — use "
        "flash_attention_auto (pads and masks) or full_attention for "
        "ragged lengths")
    out = _FlashPacked.apply(
        q.reshape(B, T, H * D), k.reshape(B, T, H * D),
        v.reshape(B, T, H * D), _Cfg(int(H), float(scale), bool(causal),
                                     seq_len, bwd_impl, bwd_block_q,
                                     bwd_block_k))
    return out.reshape(B, T, H, D)


def flash_attention_auto(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None):
    """:func:`flash_attention` with the JAX package's automatic blocks and
    padding: a sequence that cannot tile (or would tile with a block under
    64) is zero-padded to the next multiple of 256 (of 8 below 256) and
    masked through ``seq_len``, so results and gradients are exact."""
    T = q.shape[1]
    blk = auto_block(T)
    if blk >= 64 or blk == T:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=blk, block_k=blk)
    unit = 256 if T > 256 else 8
    T_pad = -(-T // unit) * unit
    pad = (0, 0, 0, 0, 0, T_pad - T)
    blk = auto_block(T_pad)
    out = flash_attention(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad),
                          causal=causal, scale=scale, block_q=blk,
                          block_k=blk, seq_len=T)
    return out[:, :T]
