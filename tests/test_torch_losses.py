"""The port's fused softmax cross-entropy against the JAX package's.

Same numpy inputs through ``horovod_tpu.ops.losses.fused_softmax_xent`` and
``horovod_tpu_torch.ops.losses.fused_softmax_xent`` on the CPU, in f32.
Tolerance 1e-5 absolute: both compute the same tiles, reduced in another
order.
"""

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
# limit, where it switches to lax.scan (16 tiles).
@pytest.mark.parametrize("mode,chunk", [(None, 16384), ("unroll4", 16384),
                                        (None, 64), (None, 16)])
def test_loss_and_grads_match_jax(monkeypatch, mode, chunk):
    if mode is not None:
        monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", mode)
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


@pytest.mark.parametrize("mode", ["recompute", "save", "save2"])
def test_unported_schedules_raise(monkeypatch, mode):
    monkeypatch.setenv("HOROVOD_TPU_XENT_MODE", mode)
    h, w, labels, _ = _inputs()
    with pytest.raises(NotImplementedError):
        tl.fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(labels))


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
