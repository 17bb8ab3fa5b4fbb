"""Memory-efficient fused softmax cross-entropy for large-vocab LM heads.

Port of ``horovod_tpu/ops/losses.py:138-284`` with its default ``unroll2``
schedule (and the other ``unrollK``): the rows are split into K chunks;
the forward computes each chunk's logits tile, reduces it to ``lse`` and
the label logit, and drops the tile, so the residuals are just
``(hidden, W, labels, lse)``; the backward recomputes each tile, forms
``softmax - onehot`` in place and contracts it at once into ``d hidden``
and ``dW``.  The (N, vocab) logits never live past one chunk.

All products run in ``hidden.dtype`` with f32 results (the JAX package's
``preferred_element_type=float32``), through :func:`..matmul.mm_f32`.  The
``recompute`` and ``save`` schedules of ``HOROVOD_TPU_XENT_MODE`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import re
import warnings

import torch

from horovod_tpu_torch.ops.matmul import mm_f32

_DEFAULT_MODE = "unroll2"


def _xent_mode() -> str:
    """The CE schedule from ``HOROVOD_TPU_XENT_MODE``; an unrecognised
    value warns and takes the default, as in the JAX package."""
    raw = os.environ.get("HOROVOD_TPU_XENT_MODE", _DEFAULT_MODE)
    if not re.fullmatch(r"recompute|save\d*|unroll\d+", raw):
        warnings.warn(
            f"HOROVOD_TPU_XENT_MODE={raw!r} is not one of 'recompute', "
            f"'saveK', 'unrollK'; using the default {_DEFAULT_MODE!r}",
            RuntimeWarning, stacklevel=3)
        return _DEFAULT_MODE
    if not raw.startswith("unroll"):
        raise NotImplementedError(
            f"HOROVOD_TPU_XENT_MODE={raw!r}: only the unrollK schedules "
            f"are ported")
    return raw


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= target."""
    if n <= target:
        return n
    chunk = max(d for d in range(1, target + 1) if n % d == 0)
    if chunk < max(1, target // 8):
        warnings.warn(
            f"fused cross-entropy: token count {n} has no divisor near the "
            f"target chunk {target} (best is {chunk}); the scan degenerates "
            f"to {n // chunk} tiny (chunk={chunk}, vocab) tiles. Pad or "
            f"flatten the batch to a composite token count.", stacklevel=3)
    return chunk


def _chunk_rows(mode: str, n: int, chunk: int) -> int:
    """Rows per logits tile: ``n / K`` for ``unrollK`` with K clamped to a
    divisor of ``n``, raised as the JAX package raises it when a tile would
    exceed ``chunk`` rows.  (Where the JAX package switches from unrolled
    bodies to ``lax.scan``, the tile is the same; here both are a loop.)"""
    k = max(1, int(mode[len("unroll"):]))
    while n % k:
        k -= 1
    if n // k > chunk:
        k = n // _pick_chunk(n, chunk)
    return n // k


def _chunk_fwd(h_c, w, labels_c):
    """One chunk's (loss, lse) from its f32 logits tile."""
    logits = mm_f32(h_c, w)                              # (c, V) f32
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    correct = logits.gather(1, labels_c[:, None])[:, 0]
    return lse - correct, lse


def _chunk_bwd(h_c, w, labels_c, lse_c, g_c):
    """Contract one chunk's ``softmax - onehot`` into (dh_c, dw_c), both
    f32; the logits tile is recomputed and turned into the gradient in
    place."""
    p = mm_f32(h_c, w)                                   # (c, V) f32
    p.sub_(lse_c[:, None]).exp_()
    p[torch.arange(p.shape[0], device=p.device), labels_c] -= 1.0
    dlogits = p.mul_(g_c[:, None]).to(h_c.dtype)
    del p
    return mm_f32(dlogits, w.t()), mm_f32(h_c.t(), dlogits)


class _FusedSoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, w, labels, chunk):
        n = hidden.shape[0]
        c = _chunk_rows(_xent_mode(), n, chunk)
        wc = w.to(hidden.dtype)
        labels = labels.long()
        loss = torch.empty(n, dtype=torch.float32, device=hidden.device)
        lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
        for i in range(0, n, c):
            loss[i:i + c], lse[i:i + c] = _chunk_fwd(
                hidden[i:i + c], wc, labels[i:i + c])
        ctx.save_for_backward(hidden, w, labels, lse)
        ctx.rows = c
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, w, labels, lse = ctx.saved_tensors
        c = ctx.rows
        wc = w.to(hidden.dtype)
        g = g.float()
        dh = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(0, hidden.shape[0], c):
            s = slice(i, i + c)
            dh_c, dw_c = _chunk_bwd(hidden[s], wc, labels[s], lse[s], g[s])
            dh[s] = dh_c.to(hidden.dtype)
            dw += dw_c
        return dh, dw.to(w.dtype), None, None


def fused_softmax_xent(hidden, w, labels, chunk: int = 16384):
    """Per-token softmax cross-entropy of a linear head, never holding the
    full logits as a residual.

    Args:
      hidden: (N, d) activations; the products run in this dtype with f32
        results.
      w: (d, V) head weight (cast to ``hidden.dtype`` for the products).
      labels: (N,) integer target ids in [0, V).
      chunk: most rows per logits tile; the default schedule is 2-way
        (``unroll2``), and a smaller ``chunk`` raises the number of tiles.

    Returns: (N,) f32 per-token losses (``lse - logit[label]``); take
    ``.mean()`` for the usual reduction.
    """
    return _FusedSoftmaxXent.apply(hidden, w, labels, int(chunk))
