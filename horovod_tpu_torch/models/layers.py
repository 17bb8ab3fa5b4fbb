"""flax's layers as the port's models use them.

``Dense``, ``Embed`` and ``LayerNorm`` keep flax's parameter names,
shapes and numerics (``horovod_tpu/models/transformer.py`` builds on
``flax.linen``); ``_trunc_normal`` is flax's variance-scaling truncated
normal initializer.  Shared by :mod:`.transformer`, :mod:`.resnet` and
the model-parallel modules of :mod:`horovod_tpu_torch.parallel`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's truncated-normal initializers divide the wanted standard deviation
# by the std of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(shape, fan_in: int, device, gen) -> torch.Tensor:
    """flax's variance-scaling(1, fan_in, truncated normal) draw."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=gen)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel (+ bias)`` with kernel (in, out),
    inputs and parameters cast to ``dtype`` for the product."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool,
                 dtype: torch.dtype, device, gen):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            _trunc_normal((in_features, features), in_features, device,
                          gen))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of an f32 table, returned in ``dtype``.
    (flax casts the table before the lookup; the port looks up and then
    casts, which gives the same values, and accumulates the table's
    gradient in f32.)"""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype, device, gen):
        super().__init__()
        self.dtype = dtype
        # flax's embed init is variance scaling over the feature axis.
        self.embedding = nn.Parameter(
            _trunc_normal((num_embeddings, features), features, device,
                          gen))

    def forward(self, ids):
        return F.embedding(ids, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics with the fast variance
    ``max(0, E[x^2] - E[x]^2)``, epsilon 1e-6, f32 scale and bias, output
    in ``dtype``."""

    def __init__(self, features: int, *, dtype: torch.dtype, device,
                 epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)
