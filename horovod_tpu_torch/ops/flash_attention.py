"""Flash attention on hand-written Hopper kernels.

Port of ``horovod_tpu/ops/flash_attention.py:1406-1812``: the entry points
``flash_qkv_proj``, ``flash_attention_qkv``, ``flash_attention`` and
``flash_attention_auto``, the block helpers ``auto_block``,
``bwd_kv_block`` and ``_resolve_blocks``, and the custom-vjp wrappers,
here the autograd Functions ``_FlashQKVProj``, ``_FlashQKV`` and
``_FlashPacked``.

Three kernels carry it (``csrc/``, built by :mod:`._cuda`):

* ``flash_fwd`` (P1) replaces the three Pallas forward forms
  (``_fwd_kernel``, ``_fwd_kernel_unrollkv``, ``_fwd_kernel_fullunroll``);
* ``flash_bwd_dkdv`` (P2) replaces ``_dkdv_kernel`` and its head-grouped
  form;
* ``flash_bwd_dq`` (P3) replaces ``_dq_kernel`` and its head-grouped form.

Every kernel reads q, k and v from (B, T, H*D) views with unit column
stride and any row stride, so the three may be column regions of ONE fused
(B, T, 3C) projection (the ``head_base = (0, H, 2H)`` design of
``_fwd_packed``): the projection is never split or transposed in memory,
and the backward writes dq, dk and dv straight into the three column
regions of one (B, T, 3C) gradient.  lse is a contiguous (B, H, T) f32
tensor.

Beside each kernel is a plain PyTorch version of the same signature
(``_flash_fwd_plain``, ``_flash_bwd_dkdv_plain``, ``_flash_bwd_dq_plain``)
that computes in f32 with the same masking, cast points and clamps, and
materialises the (T, T) scores one batch element at a time.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

The TPU block sizes mean nothing to the Hopper kernels, which choose their
own 64-row tiles; ``block_q``/``block_k`` and their backward twins are
still validated by ``_resolve_blocks`` so that callers get the JAX
package's errors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops.matmul import mm_f32
from horovod_tpu_torch.parallel.ring_attention import _NEG_BIG


# --------------------------------------------------------------------------
# Plain versions of the three kernels.


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


_PLAIN = {
    "flash_fwd": _flash_fwd_plain,
    "flash_bwd_dkdv": _flash_bwd_dkdv_plain,
    "flash_bwd_dq": _flash_bwd_dq_plain,
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


def _flash_bwd(q, k, v, o, lse, do, num_heads, scale, causal, seq_len,
               dq=None, dk=None, dv=None):
    do = do.contiguous()
    delta = _delta(do, o, num_heads)
    kw = dict(scale=scale, causal=causal, seq_len=seq_len)
    dk, dv = _dispatch("flash_bwd_dkdv", q, k, v, do, lse, delta,
                       num_heads, dk=dk, dv=dv, **kw)
    dq = _dispatch("flash_bwd_dq", q, k, v, do, lse, delta, num_heads,
                   dq=dq, **kw)
    return dq, dk, dv


def _split3(x: torch.Tensor):
    """The q | k | v column regions of a (B, T, 3C) tensor, as views."""
    C = x.shape[-1] // 3
    return x[..., :C], x[..., C:2 * C], x[..., 2 * C:]


class _FlashPacked(torch.autograd.Function):
    """Flash attention on three (B, T, H*D) tensors (``_flash_packed``)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale, causal, seq_len):
        o, lse = _dispatch("flash_fwd", q, k, v, num_heads, scale=scale,
                           causal=causal, seq_len=seq_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (num_heads, scale, causal, seq_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None


class _FlashQKV(torch.autograd.Function):
    """Flash attention off one fused (B, T, 3C) projection
    (``_flash_qkv``); the gradient is one (B, T, 3C) tensor written by the
    kernels in place of the JAX package's concatenate."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, causal, seq_len):
        o, lse = _dispatch("flash_fwd", *_split3(qkv), num_heads,
                           scale=scale, causal=causal, seq_len=seq_len)
        ctx.save_for_backward(qkv, o, lse)
        ctx.cfg = (num_heads, scale, causal, seq_len)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        _flash_bwd(*_split3(qkv), o, lse, do, *ctx.cfg, *_split3(dqkv))
        return dqkv, None, None, None, None


class _FlashQKVProj(torch.autograd.Function):
    """``x @ w`` followed by flash attention (``_flash_qkv_proj``).  The
    (B, T, 3C) projection is not saved: the backward recomputes it from
    (x, w), one extra product in exchange for never holding it."""

    @staticmethod
    def forward(ctx, x, w, num_heads, scale, causal, seq_len):
        qkv = x @ w.to(x.dtype)
        o, lse = _dispatch("flash_fwd", *_split3(qkv), num_heads,
                           scale=scale, causal=causal, seq_len=seq_len)
        ctx.save_for_backward(x, w, o, lse)
        ctx.cfg = (num_heads, scale, causal, seq_len)
        return o

    @staticmethod
    def backward(ctx, do):
        x, w, o, lse = ctx.saved_tensors
        wc = w.to(x.dtype)
        qkv = x @ wc
        dqkv = torch.empty_like(qkv)
        _flash_bwd(*_split3(qkv), o, lse, do, *ctx.cfg, *_split3(dqkv))
        del qkv
        dx = (dqkv @ wc.t()).to(x.dtype)
        dw = mm_f32(x.reshape(-1, x.shape[-1]).t(),
                    dqkv.reshape(-1, dqkv.shape[-1])).to(w.dtype)
        return dx, dw, None, None, None, None


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
    *_, seq_len = _resolve_blocks(
        T, "flash_qkv_proj", block_q, block_k, bwd_block_q, bwd_block_k,
        seq_len, "pad the sequence to a tileable length")
    return _FlashQKVProj.apply(x, w, int(num_heads), float(scale),
                               bool(causal), seq_len)


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
    *_, seq_len = _resolve_blocks(
        T, "flash_attention_qkv", block_q, block_k, bwd_block_q,
        bwd_block_k, seq_len, "pad, or split and use flash_attention_auto")
    return _FlashQKV.apply(qkv, int(num_heads), float(scale), bool(causal),
                           seq_len)


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
    positions past it are masked on rows and columns.  ``bwd_impl``
    ``"pallas"``/``"pallas_split"`` is the split dk/dv + dq kernel pair;
    the one-pass ``"pallas_fused"`` and the chunked ``"xla"`` backwards are
    not ported yet and raise ``NotImplementedError``."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if bwd_impl not in ("pallas", "pallas_fused", "pallas_split", "xla"):
        raise ValueError(f"bwd_impl must be 'pallas' (auto fused/split), "
                         f"'pallas_fused', 'pallas_split' or 'xla', got "
                         f"{bwd_impl!r}")
    if bwd_impl in ("pallas_fused", "xla"):
        raise NotImplementedError(
            f"flash_attention: bwd_impl={bwd_impl!r} is not ported yet; "
            f"use 'pallas' (the split dk/dv + dq kernels)")
    *_, seq_len = _resolve_blocks(
        T, "flash_attention", block_q, block_k, bwd_block_q, bwd_block_k,
        seq_len, "T divisible by the blocks is required — use "
        "flash_attention_auto (pads and masks) or full_attention for "
        "ragged lengths")
    out = _FlashPacked.apply(
        q.reshape(B, T, H * D), k.reshape(B, T, H * D),
        v.reshape(B, T, H * D), int(H), float(scale), bool(causal),
        seq_len)
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
