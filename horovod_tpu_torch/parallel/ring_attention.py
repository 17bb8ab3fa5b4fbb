"""Ring attention: sequence parallelism for long contexts.

Port of ``horovod_tpu/parallel/ring_attention.py``: ``_NEG_BIG`` (:48),
``_block_attend`` (:51), the zigzag layout helpers (:73-110),
``ring_attention`` (:112), ``_ring_scan`` (:147),
``_ring_attention_zigzag`` (:190) and the oracle ``full_attention``
(:246).

The sequence dimension is sharded over a mesh axis; each rank attends its
query shard to every K/V shard while the K/V shards rotate around the
ring, one :func:`.collectives.ppermute` hop at a time (K and V of a hop
travel in one batch of sends and receives), and an online softmax merges
the blocks in f32.  The JAX package rotates n times and drops the last
rotation, which brings K/V back home; the port rotates n - 1 times.

``layout="zigzag"`` balances the causal work: the global sequence is
split into 2n chunks and rank r holds chunks (r, 2n-1-r).  On each hop
the causal structure is known per rank pair, so only the visible region
is computed: the diagonal with its mask, the early half of a shard from
the causal past, or the late queries against a shard from the causal
future.  The JAX package picks the branch with ``lax.switch`` on the
traced ranks; here it is a Python branch on known ranks, and every rank
still posts the same exchange on every hop.  Permute host-side sequences
with :func:`zigzag_indices` / :func:`inverse_zigzag_indices`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from horovod_tpu_torch.parallel.collectives import ppermute
from horovod_tpu_torch.parallel.mesh import RANKS_AXIS, AxisGroup, resolve

# Masked logits get this finite value instead of -inf, so a fully masked
# row never produces inf - inf = NaN.  Shared by every attention path.
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def _block_attend(q, k, v, pos_q, pos_k, causal, scale):
    """One (Q-local x K-block) contribution with an explicit allowed-mask:
    the block's row max, row sum of exp and unnormalised output, in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = None
    if causal:
        allowed = pos_k[None, :] <= pos_q[:, None]          # (Tq, Tk)
        logits = torch.where(allowed, logits, _NEG_BIG)
    block_max = logits.amax(dim=-1)                         # (B, H, Tq)
    p = torch.exp(logits - block_max[..., None])
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    block_sum = p.sum(dim=-1)                               # (B, H, Tq)
    block_out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return block_max, block_sum, block_out


def zigzag_indices(n: int, seq_len: int):
    """Permutation taking a contiguous global sequence to zigzag layout:
    after ``x = x[:, zigzag_indices(n, T)]`` a contiguous shard over ``n``
    ranks gives rank r the chunk pair ``(r, 2n-1-r)``."""
    if seq_len % (2 * n):
        raise ValueError(
            f"zigzag layout needs seq_len % (2*ranks) == 0, got "
            f"{seq_len} % {2 * n}")
    c = seq_len // (2 * n)
    idx = []
    for r in range(n):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * n - 1 - r) * c, (2 * n - r) * c))
    return np.asarray(idx)


def inverse_zigzag_indices(n: int, seq_len: int):
    """Permutation taking zigzag layout back to the contiguous sequence."""
    return np.argsort(zigzag_indices(n, seq_len))


def zigzag_shard_positions(rank: int, n: int, local_len: int,
                           device=None) -> torch.Tensor:
    """Global positions of rank ``rank``'s zigzag shard of ``local_len``
    tokens (chunks ``rank`` and ``2n-1-rank``, each ``local_len // 2``);
    models use them for position embeddings under the zigzag layout."""
    c = local_len // 2
    ar = torch.arange(c, device=device)
    return torch.cat([rank * c + ar, (2 * n - 1 - rank) * c + ar])


def _zigzag_pos(rank, n, c, device=None):
    return zigzag_shard_positions(rank, n, 2 * c, device)


def ring_attention(q, k, v, *, axis_name=RANKS_AXIS, causal: bool = True,
                   scale: Optional[float] = None,
                   layout: str = "contiguous", mesh=None):
    """Blockwise self-attention over a sequence sharded on ``axis_name``
    of ``mesh`` (the world's ``('ranks',)`` mesh by default).

    ``q``/``k``/``v``: (batch, seq_local, heads, head_dim), this rank's
    shard in ``layout`` ("contiguous" rank-major or "zigzag").  Returns
    the attention output in the same layout and ``q.dtype``."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring-attention layout {layout!r}")
    ax = resolve(mesh, axis_name)
    if layout == "zigzag":
        if causal:
            return _ring_attention_zigzag(q, k, v, ax=ax, scale=scale)
        # Without a causal mask every hop is fully visible: zigzag has
        # nothing to balance, and contiguous computes the same.
    n, my = ax.size, ax.index
    T = q.shape[1]
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    ar = torch.arange(T, device=q.device)
    pos_q = my * T + ar

    def hop(s, k_blk, v_blk):
        src = (my - s) % n
        return _block_attend(q, k_blk, v_blk, pos_q, src * T + ar, causal,
                             scale)

    return _ring_scan(q, k, v, ax, hop)


def _ring_scan(q, k, v, ax: AxisGroup, hop):
    """The n-hop K/V ring with the online-softmax merge, shared by both
    layouts.  ``hop(s, k_blk, v_blk) -> (block_max, block_sum,
    block_out)`` is hop ``s``'s contribution for all local query rows
    (-big/0/0 for rows it does not touch)."""
    n = ax.size
    B, T, H, D = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    kv = (k, v)
    for s in range(n):
        bm, bs, bo = hop(s, *kv)
        new_m = torch.maximum(m, bm)
        alpha = torch.exp(m - new_m)        # rescale old accumulators
        beta = torch.exp(bm - new_m)        # rescale this block
        l = l * alpha + bs * beta
        o = (o * alpha.transpose(1, 2)[..., None]
             + bo * beta.transpose(1, 2)[..., None])
        m = new_m
        if s < n - 1:
            kv = ppermute(kv, ax, perm)
    l = l.clamp_min(1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _ring_attention_zigzag(q, k, v, *, ax: AxisGroup, scale):
    """Causal ring attention over zigzag shards: on each hop the diagonal
    (``src == my``) is dense with the causal mask; a shard from the causal
    past (``src < my``) has its early chunk fully visible to every local
    query and its late chunk fully masked; a shard from the causal future
    is fully visible to the late local chunk only."""
    n, my = ax.size, ax.index
    B, T, H, D = q.shape
    if T % 2:
        raise ValueError(f"zigzag layout needs an even local length, got {T}")
    C = T // 2
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    pos_q = _zigzag_pos(my, n, C, q.device)

    def hop(s, k_blk, v_blk):
        src = (my - s) % n
        pos_k = _zigzag_pos(src, n, C, q.device)
        if src == my:
            return _block_attend(q, k_blk, v_blk, pos_q, pos_k, True, scale)
        if src < my:
            return _block_attend(q, k_blk[:, :C], v_blk[:, :C], pos_q,
                                 pos_k[:C], False, scale)
        bm, bs, bo = _block_attend(q[:, C:], k_blk, v_blk, pos_q[C:], pos_k,
                                   False, scale)
        # Early local queries see nothing of this shard: identity elements
        # of the online-softmax merge.
        pad_m = torch.full((B, H, C), _NEG_BIG, dtype=torch.float32,
                           device=q.device)
        pad_s = torch.zeros((B, H, C), dtype=torch.float32, device=q.device)
        pad_o = torch.zeros((B, C, H, D), dtype=torch.float32,
                            device=q.device)
        return (torch.cat([pad_m, bm], dim=2), torch.cat([pad_s, bs], dim=2),
                torch.cat([pad_o, bo], dim=1))

    return _ring_scan(q, k, v, ax, hop)


def full_attention(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None, q_offset: int = 0,
                   k_offset: int = 0):
    """Single-device reference attention over (B, T, H, D) inputs: the
    (T, T) logits are materialised in f32, masked with ``_NEG_BIG`` and
    softmaxed; the output comes back in ``q.dtype``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos_q = q_offset + torch.arange(Tq, device=q.device)
        pos_k = k_offset + torch.arange(Tk, device=q.device)
        allowed = pos_k[None, :] <= pos_q[:, None]
        logits = torch.where(allowed, logits, _NEG_BIG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
