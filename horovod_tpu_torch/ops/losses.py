"""Memory-efficient fused softmax cross-entropy for large-vocab LM heads.

Port of ``horovod_tpu/ops/losses.py:49-284`` with every schedule of
``HOROVOD_TPU_XENT_MODE`` (:func:`_xent_mode`, laid out by
:func:`_mode_layout`):

* ``unrollK`` (the default ``unroll2``): the rows are split into K chunks;
  the forward computes each chunk's logits tile, reduces it to ``lse``
  and the label logit, and drops the tile, so the residuals are just
  ``(hidden, W, labels, lse)``; the backward recomputes each tile, forms
  ``softmax - onehot`` in place and contracts it at once into ``d hidden``
  and ``dW``.  The (N, vocab) logits never live past one chunk.
* ``recompute``: the same with one tile, or tiles of ``_pick_chunk(N,
  chunk)`` rows when ``chunk < N`` (where the JAX package runs
  ``lax.scan``; here both are a loop).
* ``save`` / ``saveK``: the forward keeps each tile's logits as a bf16
  residual and the backward reads it instead of recomputing the head
  product.  Past ``_MAX_UNROLL_CHUNKS`` tiles a save mode warns with the
  reference's text and takes the recompute schedule; a call that needs no
  gradient keeps no residual; the backward takes its tiles from the
  environment at backward time and whether to recompute from what the
  forward saved, as the reference's ``_xent_bwd`` does.

All products run in ``hidden.dtype`` with f32 results (the JAX package's
``preferred_element_type=float32``), through :func:`..matmul.mm_f32`.
"""

from __future__ import annotations

import os
import re
import warnings

import torch

from horovod_tpu_torch.ops.matmul import mm_f32

_DEFAULT_MODE = "unroll2"
# Beyond this many chunks a save mode drops its residual and the recompute
# schedule takes over (horovod_tpu/ops/losses.py:46).
_MAX_UNROLL_CHUNKS = 8


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
    return raw


def _mode_layout(mode: str, n: int, chunk: int):
    """(save_logits, n_chunks, scan_chunk) for a validated mode string, as
    the JAX package lays it out: ``n_chunks`` is None for the recompute
    schedule, tiled by ``scan_chunk`` rows; otherwise it is the chunk
    count, clamped to a divisor of ``n`` and raised where a tile would
    exceed ``chunk`` rows.  Past ``_MAX_UNROLL_CHUNKS`` chunks the
    recompute schedule takes over at the same tile bound, and a save mode
    warns that its residual is dropped."""
    if mode == "recompute":
        return False, None, chunk
    save = mode.startswith("save")
    k = int((mode[len("save"):] if save else mode[len("unroll"):]) or 1)
    k = max(1, k)
    while n % k:
        k -= 1
    if n // k > chunk:
        k = n // _pick_chunk(n, chunk)
    if k > _MAX_UNROLL_CHUNKS:
        if save:
            warnings.warn(
                f"HOROVOD_TPU_XENT_MODE={mode!r}: the chunk bound "
                f"({chunk} rows over n={n} tokens) needs {k} unrolled "
                f"bodies, past the limit of {_MAX_UNROLL_CHUNKS}; "
                "falling back to the scan recompute schedule — the "
                "save-logits residual is dropped and the backward "
                "recomputes the head matmul. Raise the chunk bound or "
                "use fewer chunks to keep the residual.",
                RuntimeWarning, stacklevel=3)
        return False, None, min(chunk, n // k)
    return save, k, chunk


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


def _chunk_fwd(h_c, w, labels_c, want_logits=False):
    """One chunk's (loss, lse) from its f32 logits tile, and the tile as a
    bf16 residual when ``want_logits`` (the save schedule)."""
    logits = mm_f32(h_c, w)                              # (c, V) f32
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    correct = logits.gather(1, labels_c[:, None])[:, 0]
    if want_logits:
        return lse - correct, lse, logits.to(torch.bfloat16)
    return lse - correct, lse


def _chunk_bwd(h_c, w, labels_c, lse_c, g_c, logits_c=None):
    """Contract one chunk's ``softmax - onehot`` into (dh_c, dw_c), both
    f32; the logits tile is recomputed unless a saved bf16 tile
    (``logits_c``) is given, and turned into the gradient in place."""
    p = mm_f32(h_c, w) if logits_c is None else logits_c.float()
    p.sub_(lse_c[:, None]).exp_()
    p[torch.arange(p.shape[0], device=p.device), labels_c] -= 1.0
    dlogits = p.mul_(g_c[:, None]).to(h_c.dtype)
    del p
    return mm_f32(dlogits, w.t()), mm_f32(h_c.t(), dlogits)


class _FusedSoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, w, labels, chunk, save_ok):
        n = hidden.shape[0]
        save, k, scan_chunk = _mode_layout(_xent_mode(), n, chunk)
        c = n // k if k is not None else _pick_chunk(n, scan_chunk)
        save = save and save_ok
        wc = w.to(hidden.dtype)
        labels = labels.long()
        loss = torch.empty(n, dtype=torch.float32, device=hidden.device)
        lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
        logits = (torch.empty((n, w.shape[1]), dtype=torch.bfloat16,
                              device=hidden.device) if save else None)
        for i in range(0, n, c):
            s = slice(i, i + c)
            out = _chunk_fwd(hidden[s], wc, labels[s], want_logits=save)
            loss[s], lse[s] = out[0], out[1]
            if save:
                logits[s] = out[2]
        ctx.save_for_backward(hidden, w, labels, lse, logits)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        # Whether to recompute is read off the residual, not the
        # environment, as in the JAX package's ``_xent_bwd``.
        hidden, w, labels, lse, logits = ctx.saved_tensors
        n = hidden.shape[0]
        _, k, scan_chunk = _mode_layout(_xent_mode(), n, ctx.chunk)
        if k is not None or logits is not None:
            c = n // (k or 1)
        else:
            c = _pick_chunk(n, scan_chunk)
        wc = w.to(hidden.dtype)
        g = g.float()
        dh = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(0, n, c):
            s = slice(i, i + c)
            dh_c, dw_c = _chunk_bwd(hidden[s], wc, labels[s], lse[s], g[s],
                                    None if logits is None else logits[s])
            dh[s] = dh_c.to(hidden.dtype)
            dw += dw_c
        return dh, dw.to(w.dtype), None, None, None


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
    ``.mean()`` for the usual reduction.  A call that needs no gradient
    (``torch.no_grad()``, or neither ``hidden`` nor ``w`` requiring one)
    keeps no save-mode residual, as the reference's primal call does.
    """
    save_ok = torch.is_grad_enabled() and (hidden.requires_grad
                                           or w.requires_grad)
    return _FusedSoftmaxXent.apply(hidden, w, labels, int(chunk), save_ok)
