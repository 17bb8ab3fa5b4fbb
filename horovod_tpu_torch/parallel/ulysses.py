"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding.

Port of ``horovod_tpu/parallel/ulysses.py``: ``seq_to_heads`` (:25),
``heads_to_seq`` (:32) and ``ulysses_attention`` (:38).  One all-to-all
re-shards activations from sequence-sharded to head-sharded, attention
runs locally over the FULL sequence for this rank's 1/n of the heads,
and a second all-to-all restores sequence sharding.  The exchanges are
:func:`.collectives.all_to_all`, whose backward is the inverse exchange;
q, k and v travel in one exchange (the JAX package sends three, with the
same result bit for bit).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from horovod_tpu_torch.parallel.collectives import all_to_all
from horovod_tpu_torch.parallel.mesh import RANKS_AXIS
from horovod_tpu_torch.parallel.ring_attention import full_attention


def seq_to_heads(x, *, axis_name=RANKS_AXIS, mesh=None):
    """(B, T_local, H, D) -> (B, T_global, H/n, D): gather the sequence,
    split the heads across ranks."""
    return all_to_all(x, axis_name, split_axis=2, concat_axis=1, mesh=mesh)


def heads_to_seq(x, *, axis_name=RANKS_AXIS, mesh=None):
    """(B, T_global, H/n, D) -> (B, T_local, H, D): the inverse re-shard."""
    return all_to_all(x, axis_name, split_axis=1, concat_axis=2, mesh=mesh)


def ulysses_attention(q, k, v, *, axis_name=RANKS_AXIS, causal: bool = True,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None, mesh=None):
    """Self-attention over a sequence sharded on ``axis_name`` of ``mesh``
    by the all-to-all strategy.  Heads must divide by the axis size.
    ``attn_fn(q, k, v, causal=..., scale=...)`` is the local attention
    (:func:`.ring_attention.full_attention` by default, or
    ``flash_attention_auto``, which reaches the flash kernels)."""
    qkv = torch.stack((q, k, v), dim=2)                # (B, T, 3, H, D)
    return _ulysses_packed(qkv, axis_name=axis_name, causal=causal,
                           scale=scale, attn_fn=attn_fn, mesh=mesh)


def _ulysses_packed(qkv, *, axis_name, causal, scale, attn_fn, mesh):
    """:func:`ulysses_attention` on q, k and v packed as (B, T, 3, H, D),
    e.g. a view of the (B, T, 3C) projection: one exchange for the three,
    which then arrive as strided views of one (B, T_global, 3, H/n, D)
    tensor (each row of H/n * D columns contiguous, as the flash kernels
    read them)."""
    if attn_fn is None:
        attn_fn = full_attention
    qkv = all_to_all(qkv, axis_name, split_axis=3, concat_axis=1,
                     mesh=mesh)
    q, k, v = qkv.unbind(2)
    out = attn_fn(q, k, v, causal=causal, scale=scale)
    return heads_to_seq(out, axis_name=axis_name, mesh=mesh)
