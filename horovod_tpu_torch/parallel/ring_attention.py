"""Oracle attention and the shared mask constant.

Port of ``horovod_tpu/parallel/ring_attention.py``: ``_NEG_BIG`` (:48) and
``full_attention`` (:246).  The ring itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

# Masked logits get this finite value instead of -inf, so a fully masked
# row never produces inf - inf = NaN.  Shared by every attention path.
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


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
