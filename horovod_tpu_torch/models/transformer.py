"""Decoder-only transformer LM.

Port of ``horovod_tpu/models/transformer.py:47-254``: ``Attention``,
``Block`` and ``TransformerLM`` with ``attn="full"`` (oracle attention)
and ``attn="flash"`` (the hand-written flash kernels), bf16 compute over
f32 parameters, and ``return_hidden``.  The sequence- and
tensor-parallel attentions (``ring``, ``ring_zigzag``, ``ulysses``,
``ulysses_flash``, ``tp_axis``) and ``BlockStack`` are not ported yet.

The parameters keep flax's names, shapes and layout, so a flax
``params`` tree loads as it is (:mod:`horovod_tpu_torch.weights`):
Dense kernels are (in, out), ``qkv`` is the raw (C, 3C) kernel laid out
q | k | v, head-major, and only ``fc1``/``fc2`` carry biases.  The
modules follow flax's numerics: LayerNorm with epsilon 1e-6 and f32 fast
variance E[x^2] - E[x]^2, tanh GELU, products in ``dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.flash_attention import (
    auto_block, flash_attention_auto, flash_qkv_proj)
from horovod_tpu_torch.parallel.ring_attention import full_attention

_ATTNS = ("full", "flash")
_NOT_PORTED = ("ring", "ring_zigzag", "ulysses", "ulysses_flash")
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


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn: str, *,
                 dtype: torch.dtype, device, gen):
        super().__init__()
        self.num_heads = num_heads
        self.attn = attn
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, use_bias=False, dtype=dtype,
                         device=device, gen=gen)
        self.proj = Dense(dim, dim, use_bias=False, dtype=dtype,
                          device=device, gen=gen)

    def forward(self, x):
        B, T, C = x.shape
        H = self.num_heads
        D = C // H
        blk = auto_block(T)
        if (self.attn == "flash" and D % 128 == 0
                and (blk == T or blk >= 64)):
            # Fused-projection path: one op computes qkv and runs the
            # kernels straight off it, and the (B, T, 3C) projection is
            # recomputed in the backward rather than held.
            out = flash_qkv_proj(x.to(self.dtype), self.qkv.kernel, H,
                                 causal=True)
            return self.proj(out)
        q, k, v = (t.reshape(B, T, H, D)
                   for t in self.qkv(x).chunk(3, dim=-1))
        if self.attn == "full":
            out = full_attention(q, k, v, causal=True)
        else:
            out = flash_attention_auto(q, k, v, causal=True)
        return self.proj(out.reshape(B, T, C))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: int,
                 attn: str, dtype: torch.dtype, ln_dtype: torch.dtype,
                 device, gen):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype=ln_dtype, device=device)
        self.attn = Attention(dim, num_heads, attn, dtype=dtype,
                              device=device, gen=gen)
        self.ln2 = LayerNorm(dim, dtype=ln_dtype, device=device)
        self.fc1 = Dense(dim, mlp_ratio * dim, use_bias=True, dtype=dtype,
                         device=device, gen=gen)
        self.fc2 = Dense(mlp_ratio * dim, dim, use_bias=True, dtype=dtype,
                         device=device, gen=gen)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class TransformerLM(nn.Module):
    """Causal LM over (B, T) token ids.

    Parameters are f32, drawn from ``seed`` with flax's initializer
    distributions on ``device`` ("cuda" unless the caller asks for the
    CPU).  ``dtype`` is the compute dtype of the blocks, ``head_dtype``
    that of the LM head and ``ln_dtype`` that of the LayerNorm outputs.
    ``forward(tokens, return_hidden=True)`` skips the head and returns the
    final-LN hidden states, to pair with
    :func:`horovod_tpu_torch.ops.losses.fused_softmax_xent` on
    ``model.head.kernel``.
    """

    def __init__(self, vocab: int, dim: int = 256, depth: int = 4,
                 num_heads: int = 8, max_len: int = 2048,
                 attn: str = "full", tp_axis: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 head_dtype: torch.dtype = torch.float32,
                 ln_dtype: torch.dtype = torch.float32, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        if attn in _NOT_PORTED or tp_axis is not None:
            raise NotImplementedError(
                f"TransformerLM: attn={attn!r}, tp_axis={tp_axis!r} -- "
                f"the sequence- and tensor-parallel attentions are not "
                f"ported yet")
        if attn not in _ATTNS:
            raise ValueError(f"unknown attention impl: {attn!r}")
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.tok_emb = Embed(vocab, dim, dtype=dtype, device=device,
                             gen=gen)
        self.pos_emb = Embed(max_len, dim, dtype=dtype, device=device,
                             gen=gen)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", Block(
                dim, num_heads, mlp_ratio=4, attn=attn, dtype=dtype,
                ln_dtype=ln_dtype, device=device, gen=gen))
        self.ln_f = LayerNorm(dim, dtype=ln_dtype, device=device)
        self.head = Dense(dim, vocab, use_bias=False, dtype=head_dtype,
                          device=device, gen=gen)

    def forward(self, tokens, return_hidden: bool = False):
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(pos)[None]
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.head(x)
