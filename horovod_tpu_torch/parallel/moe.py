"""Expert parallelism: a Switch/GShard mixture-of-experts over a mesh axis.

Port of ``horovod_tpu/parallel/moe.py``: ``MoELayer`` (:45).  The MLP is
E experts, one per rank of the ``ep`` axis, and tokens are sharded over
``ep`` (data parallel within the expert group):

* the router is a replicated f32 dense: top-1 (Switch, raw gate
  weighting) or top-k (GShard, gates renormalised over the chosen k) by
  iterated argmax (the first index on ties, as ``jnp.argmax``), with an
  optional ST-MoE router z-loss;
* dispatch is matmuls against a ``(tokens, E, capacity)`` one-hot tensor
  built from cumulative-sum positions, with choice priority: every first
  choice claims its slot before any second choice, so under capacity
  pressure second choices drop first;
* one :func:`.collectives.all_to_all` ships each rank's per-expert
  buffers to the experts' ranks, the local expert FFN runs on its
  ``(E * capacity, d)`` tokens, and a second ships the results home,
  where the same tensor combines them, weighted by the gates.

Expert weights (``w1``, ``w2``) are per rank, drawn from the seed folded
with the rank's ``ep`` index; the router is replicated, and passes
:func:`.collectives.pvary`, so its gradient is summed over ``ep`` (the
transpose JAX applies to an invariant parameter used by varying tokens).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense, _trunc_normal
from horovod_tpu_torch.parallel.collectives import all_to_all, pvary
from horovod_tpu_torch.parallel.mesh import resolve, shard_generator

EP_AXIS = "ep"


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(index, n)`` in f32: an index outside [0, n) gives
    a row of zeros."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def route(x, router_kernel, num_experts: int, top_k: int,
          capacity: int):
    """The router of :class:`MoELayer` on this rank's tokens ``x`` (T, d):
    ``(dispatch, combine, logits, probs, first_choices)``, the first two
    (T, E, C) f32 with the gate weighting folded into ``combine``."""
    T = x.shape[0]
    E, C = num_experts, capacity
    logits = x.float() @ router_kernel.float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    remaining = probs
    onehots, gates = [], []
    for _ in range(top_k):
        oh = _one_hot(remaining.argmax(dim=-1), E)             # (T, E)
        onehots.append(oh)
        gates.append((remaining * oh).sum(dim=-1))             # (T,)
        remaining = remaining * (1.0 - oh)
    if top_k == 1:
        weights = gates                    # Switch: raw gate probability
    else:
        denom = torch.clamp_min(sum(gates), 1e-9)
        weights = [g / denom for g in gates]   # GShard: renormalised
    # Capacity slots with choice priority: each choice's tokens go after
    # every earlier choice's claims on that expert.
    claimed = torch.zeros(E, device=x.device)
    disp = torch.zeros((T, E, C), device=x.device)
    comb = torch.zeros((T, E, C), device=x.device)
    for oh, w in zip(onehots, weights):
        pos = (torch.cumsum(oh, dim=0) - 1.0) * oh             # (T, E)
        pos_t = (pos.sum(-1) + (oh * claimed).sum(-1)).to(torch.int32)
        keep = (pos_t < C).float()
        slot = (oh[:, :, None] * _one_hot(pos_t, C)[:, None, :]
                * keep[:, None, None])                         # (T, E, C)
        disp = disp + slot
        comb = comb + w[:, None, None] * slot
        claimed = claimed + oh.sum(dim=0)
    return disp, comb, logits, probs, onehots[0]


def expert_ffn(h, w1, w2, dtype):
    """The expert MLP on (tokens, d) rows: ``gelu(h @ w1) @ w2`` in
    ``dtype``."""
    h = h.to(dtype) @ w1.to(dtype)
    return F.gelu(h, approximate="tanh") @ w2.to(dtype)


def aux_losses(logits, probs, first_choices, num_experts: int):
    """``(aux_load_balance, aux_router_z)``: the Switch load-balancing
    term ``E * sum_e f_e p_e`` on first choices, and the router z-loss
    ``mean(logsumexp(logits)^2)``."""
    f = first_choices.mean(dim=0)
    p = probs.mean(dim=0)
    balance = num_experts * torch.sum(f * p)
    z = torch.logsumexp(logits, dim=-1)
    return balance, torch.mean(z ** 2)


class MoELayer(nn.Module):
    """Top-k MoE feed-forward, one expert per rank of ``axis``.

    ``forward(x)`` takes this rank's tokens ``(tokens_local, d)`` and
    returns ``(output, aux)``: output ``(tokens_local, d)`` in ``x.dtype``
    (zero rows for fully dropped tokens; callers keep the residual), aux
    this rank's scalar auxiliary loss, the Switch load-balancing term plus
    ``router_z_weight`` times the router z-loss.  The two components are
    also kept, as the JAX package sows them, in ``aux_load_balance`` and
    ``aux_router_z``; ``dropped`` is the share of this rank's k·T token
    choices that found no slot.  Capacity ``C = max(1, int(cf · k · T /
    E))``.  Parameters: ``router.kernel`` (d, E), replicated, drawn from
    ``seed``; ``w1`` (d, hidden) and ``w2`` (hidden, d), this rank's
    expert."""

    def __init__(self, dim: int, hidden: int, capacity_factor: float = 1.25,
                 axis=EP_AXIS, top_k: int = 1, router_z_weight: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, *, mesh=None,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.capacity_factor = capacity_factor
        self.axis = axis
        self.top_k = top_k
        self.router_z_weight = router_z_weight
        self.dtype = dtype
        self.mesh = mesh
        device = torch.device(device)
        ax = resolve(mesh, axis)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.router = Dense(dim, ax.size, use_bias=False,
                            dtype=torch.float32, device=device, gen=gen)
        egen = shard_generator(device, seed, ax)
        self.w1 = nn.Parameter(_trunc_normal((dim, hidden), dim, device,
                                             egen))
        self.w2 = nn.Parameter(_trunc_normal((hidden, dim), hidden, device,
                                             egen))
        self.aux_load_balance = self.aux_router_z = self.dropped = None

    def capacity(self, tokens: int) -> int:
        E = resolve(self.mesh, self.axis).size
        return max(1, int(self.capacity_factor * self.top_k * tokens / E))

    def forward(self, x):
        E = resolve(self.mesh, self.axis).size
        T, d = x.shape
        if not 1 <= self.top_k <= E:
            raise ValueError(f"top_k={self.top_k} out of range for {E} "
                             "experts")
        C = self.capacity(T)
        router = pvary(self.router.kernel, self.axis, mesh=self.mesh)
        disp, comb, logits, probs, first = route(x, router, E, self.top_k, C)
        # Local buffers -> owning experts -> FFN -> back home.
        buffers = torch.einsum("td,tec->ecd", x.to(self.dtype),
                               disp.to(self.dtype))             # (E, C, d)
        recv = all_to_all(buffers, self.axis, 0, 0, mesh=self.mesh)
        h = expert_ffn(recv.reshape(E * C, d), self.w1, self.w2, self.dtype)
        sent = all_to_all(h.reshape(E, C, d), self.axis, 0, 0,
                          mesh=self.mesh)
        # Dropped slots are exactly zero in comb, which already holds the
        # gate weighting.
        out = torch.einsum("ecd,tec->td", sent.float(), comb)
        balance, z_loss = aux_losses(logits, probs, first, E)
        self.aux_load_balance, self.aux_router_z = balance, z_loss
        self.dropped = 1.0 - disp.sum() / (self.top_k * T)
        aux = balance + self.router_z_weight * z_loss
        return out.to(x.dtype), aux
