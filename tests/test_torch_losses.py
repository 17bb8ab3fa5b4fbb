"""The port's fused softmax cross-entropy against the JAX package's.

Same numpy inputs through ``horovod_tpu.ops.losses.fused_softmax_xent`` and
``horovod_tpu_torch.ops.losses.fused_softmax_xent`` on the CPU, in f32,
under every schedule of ``HOROVOD_TPU_XENT_MODE`` (``unrollK``,
``recompute`` with one tile and with scan tiles, ``save`` and ``saveK``).
Tolerance 1e-5 absolute: both compute the same tiles, reduced in another
order (the save schedules' bf16 residual is rounded the same way in both).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import losses as jl
from horovod_tpu_torch.ops import losses as tl

N, DIM, V = 256, 64, 512
ATOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, DIM)).astype(np.float32)
    w = (rng.standard_normal((DIM, V)) * DIM ** -0.5).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    g = rng.standard_normal((N,)).astype(np.float32)
    return h, w, labels, g


# (mode, chunk): the default 2-way schedule, 4-way, a chunk bound that
# raises the tile count (4 tiles), and one past the JAX package's unroll
# limit, where it switches to lax.scan (16 tiles); recompute with one tile
# and with scan tiles of 64 rows; save (one tile), save2, save raised to 4
# tiles by the bound, and save2 past the unroll limit (16 tiles), which
# warns and takes the recompute schedule.
@pytest.mark.parametrize("mode,chunk", [
    (None, 16384), ("unroll4", 16384), (None, 64), (None, 16),
    ("recompute", 16384), ("recompute", 64), ("save", 16384),
    ("save2", 16384), ("save", 64), ("save2", 16)])
def test_loss_and_grads_match_jax(monkeypatch, mode, chunk):
    if mode is not None:
        monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", mode)
    # Only save2 past the unroll limit warns (in both packages).
    warnings.filterwarnings("ignore", "HOROVOD_TPU_XENT_MODE='save2'",
                            RuntimeWarning)
    h, w, labels, g = _inputs()

    def jloss(h, w):
        return (jl.fused_softmax_xent(h, w, jnp.asarray(labels), chunk)
                * jnp.asarray(g)).sum()

    want_loss = jl.fused_softmax_xent(jnp.asarray(h), jnp.asarray(w),
                                      jnp.asarray(labels), chunk)
    want_dh, want_dw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                       jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tl.fused_softmax_xent(ht, wt, torch.from_numpy(labels), chunk)
    assert loss.shape == (N,) and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=0, atol=ATOL)
    (loss * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=0, atol=ATOL)


def test_matches_materialized_reference():
    """Against the plain (N, V) logits softmax cross-entropy."""
    h, w, labels, _ = _inputs(1)
    logits = torch.from_numpy(h) @ torch.from_numpy(w)
    want = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long(), reduction="none")
    got = tl.fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL)


def _warnings_of(fn):
    """The RuntimeWarning messages that ``fn()`` emits."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(c.message) for c in caught
            if issubclass(c.category, RuntimeWarning)]


def test_save_past_unroll_limit_warns_the_reference_text(monkeypatch):
    """save2 with a 16-row bound over 256 rows needs 16 bodies: both
    packages warn with the same text and keep no residual."""
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", "save2")
    h, w, labels, _ = _inputs()
    want = _warnings_of(lambda: jax.grad(lambda h: jl.fused_softmax_xent(
        h, jnp.asarray(w), jnp.asarray(labels), 16).sum())(jnp.asarray(h)))
    saved = []
    real = tl._chunk_fwd
    monkeypatch.setattr(tl, "_chunk_fwd", lambda *a, **k: saved.append(
        k.get("want_logits", False)) or real(*a, **k))
    ht = torch.from_numpy(h).requires_grad_()
    got = _warnings_of(lambda: tl.fused_softmax_xent(
        ht, torch.from_numpy(w), torch.from_numpy(labels), 16).sum()
        .backward())
    assert want and set(got) == set(want)
    assert "past the limit of 8" in got[0]
    assert len(saved) == 16 and not any(saved)


@pytest.mark.parametrize("how", ["no_grad", "no_requires_grad"])
@pytest.mark.parametrize("mode", ["save", "save2"])
def test_call_without_gradient_keeps_no_residual(monkeypatch, mode, how):
    """The reference's primal-only call (``_save_ok=False``): no tile is
    kept when no gradient is wanted; the losses are the same."""
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", mode)
    h, w, labels, _ = _inputs()
    saved = []
    real = tl._chunk_fwd
    monkeypatch.setattr(tl, "_chunk_fwd", lambda *a, **k: saved.append(
        k.get("want_logits", False)) or real(*a, **k))
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    if how == "no_grad":
        ht.requires_grad_()
        with torch.no_grad():
            loss = tl.fused_softmax_xent(ht, wt, torch.from_numpy(labels))
    else:
        loss = tl.fused_softmax_xent(ht, wt, torch.from_numpy(labels))
    assert saved and not any(saved)
    want = jl.fused_softmax_xent(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    saved.clear()
    ht = torch.from_numpy(h).requires_grad_()
    tl.fused_softmax_xent(ht, wt, torch.from_numpy(labels))
    assert saved and all(saved)


def test_save_backward_reads_the_residual(monkeypatch):
    """Under save2 the backward takes the saved bf16 tiles and runs no
    head product: two products a tile (dh and dW), none for the
    logits."""
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", "save2")
    h, w, labels, g = _inputs()
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tl.fused_softmax_xent(ht, wt, torch.from_numpy(labels))
    products = []
    real = tl.mm_f32
    monkeypatch.setattr(tl, "mm_f32", lambda a, b: products.append(
        (tuple(a.shape), tuple(b.shape))) or real(a, b))
    (loss * torch.from_numpy(g)).sum().backward()
    assert products == [((N // 2, V), (V, DIM)), ((DIM, N // 2), (N // 2, V))
                        ] * 2


@pytest.mark.parametrize("fwd_mode,bwd_mode", [("save2", "recompute"),
                                               ("recompute", "save2")])
def test_mode_changed_between_forward_and_backward(monkeypatch, fwd_mode,
                                                   bwd_mode):
    """The mode is set again between the forward and the backward: the
    backward uses the residual the forward saved (or recomputes when it
    saved none), tiled by the mode at backward time, as the reference's
    ``_xent_bwd`` does under ``jax.vjp``."""
    h, w, labels, g = _inputs()
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", fwd_mode)
    want_loss, vjp = jax.vjp(
        lambda h, w: jl.fused_softmax_xent(h, w, jnp.asarray(labels)),
        jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = tl.fused_softmax_xent(ht, wt, torch.from_numpy(labels))
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", bwd_mode)
    want_dh, want_dw = vjp(jnp.asarray(g))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=0, atol=ATOL)


def test_unknown_mode_warns_and_uses_default(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", "bogus")
    h, w, labels, _ = _inputs()
    with pytest.warns(RuntimeWarning, match="bogus"):
        got = tl.fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                    torch.from_numpy(labels))
    monkeypatch.delenv("HOROVOD_TPU_XENT_MODE")
    want = tl.fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(labels))
    assert torch.equal(got, want)


def test_bf16_hidden_keeps_f32_logits():
    """bf16 operands: the logits stay f32 (no bf16 rounding of the
    product), so the loss matches the f32 computation on the same bf16
    values closely."""
    h, w, labels, _ = _inputs(2)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = tl.fused_softmax_xent(hb, wb.float(), torch.from_numpy(labels))
    want = tl.fused_softmax_xent(hb.float(), wb.float(),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
