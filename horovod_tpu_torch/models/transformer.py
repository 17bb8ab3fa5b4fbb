"""Decoder-only transformer LM.

Port of ``horovod_tpu/models/transformer.py:47-254``: ``Attention``,
``Block``, ``_apply_block_stack``, ``BlockStack`` and ``TransformerLM``,
bf16 compute over f32 parameters, and ``return_hidden``.  Attention
implementations:

* ``attn="full"`` -- the oracle attention;
* ``attn="flash"`` -- the hand-written flash kernels (the fused
  projection ``flash_qkv_proj`` at head sizes that are multiples of 128);
* ``attn="ring"`` / ``"ring_zigzag"`` -- :func:`..parallel.ring_attention`
  over ``sp_axis`` (zigzag: tokens pre-permuted with
  :func:`..parallel.ring_attention.zigzag_indices`);
* ``attn="ulysses"`` / ``"ulysses_flash"`` -- :func:`..parallel.ulysses`
  over ``sp_axis``, with the oracle or ``flash_attention_auto`` (the flash
  kernels over all of the global sequence and H/n heads) as the local
  attention;
* ``tp_axis`` -- the Megatron block of :mod:`..parallel.tensor_parallel`
  (heads and MLP hidden sharded), with ``attn="full"`` only.

With a sequence-parallel ``attn``, each rank feeds its shard of the
sequence and the position embeddings take each token's global position
(the rank offset, or the zigzag chunk positions).  ``mesh`` (a
:func:`..parallel.mesh.build_mesh`) binds ``sp_axis`` and ``tp_axis``;
without it the world's ``('ranks',)`` mesh does.

The parameters keep flax's names, shapes and layout, so a flax
``params`` tree loads as it is (:mod:`horovod_tpu_torch.weights`):
Dense kernels are (in, out), ``qkv`` is the raw (C, 3C) kernel laid out
q | k | v, head-major, and only ``fc1``/``fc2`` carry biases.  The
sequence-parallel modes share ``attn="full"``'s tree, and draw the same
parameters from the same seed; a ``tp_axis`` block holds ``attn.col_qkv``,
``attn.row_proj``, ``mlp.col`` and ``mlp.row`` slices instead.  The
modules follow flax's numerics: LayerNorm with epsilon 1e-6 and f32 fast
variance E[x^2] - E[x]^2, tanh GELU, products in ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense, Embed, LayerNorm
from horovod_tpu_torch.ops.flash_attention import (
    auto_block, flash_attention_auto, flash_qkv_proj)
from horovod_tpu_torch.parallel.mesh import (
    RANKS_AXIS, ranks_mesh, shard_generator)
from horovod_tpu_torch.parallel.ring_attention import (
    full_attention, ring_attention, zigzag_shard_positions)
from horovod_tpu_torch.parallel.ulysses import _ulysses_packed

_ATTNS = ("full", "flash", "ring", "ring_zigzag", "ulysses",
          "ulysses_flash")


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn: str, *,
                 sp_axis=RANKS_AXIS, mesh=None, dtype: torch.dtype, device,
                 gen):
        super().__init__()
        self.num_heads = num_heads
        self.attn = attn
        self.sp_axis = sp_axis
        self.mesh = mesh
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
        qkv = self.qkv(x)
        if self.attn in ("ulysses", "ulysses_flash"):
            # q | k | v of the projection as (B, T, 3, H, D): one
            # all-to-all re-shards the three.
            attn_fn = (flash_attention_auto if self.attn == "ulysses_flash"
                       else None)
            out = _ulysses_packed(qkv.view(B, T, 3, H, D),
                                  axis_name=self.sp_axis, causal=True,
                                  scale=None, attn_fn=attn_fn,
                                  mesh=self.mesh)
            return self.proj(out.reshape(B, T, C))
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.chunk(3, dim=-1))
        if self.attn == "full":
            out = full_attention(q, k, v, causal=True)
        elif self.attn == "flash":
            out = flash_attention_auto(q, k, v, causal=True)
        else:
            out = ring_attention(
                q, k, v, axis_name=self.sp_axis, causal=True,
                layout="zigzag" if self.attn == "ring_zigzag"
                else "contiguous", mesh=self.mesh)
        return self.proj(out.reshape(B, T, C))


class Block(nn.Module):
    """Pre-norm block.  With ``tp_axis`` it is the Megatron layout (heads
    and MLP hidden sharded over ``tp_axis``, one psum a sub-block) and
    ``gen`` draws this rank's slices; ``attn`` is then not used."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: int,
                 attn: str, dtype: torch.dtype, ln_dtype: torch.dtype,
                 device, gen, sp_axis=RANKS_AXIS, tp_axis=None, mesh=None):
        super().__init__()
        self.tp = tp_axis is not None
        self.ln1 = LayerNorm(dim, dtype=ln_dtype, device=device)
        if self.tp:
            from horovod_tpu_torch.parallel.tensor_parallel import (
                TPMlp, TPSelfAttention)
            self.attn = TPSelfAttention(dim, num_heads, tp_axis, dtype=dtype,
                                        mesh=mesh, device=device, gen=gen)
            self.ln2 = LayerNorm(dim, dtype=ln_dtype, device=device)
            self.mlp = TPMlp(dim, mlp_ratio * dim, dim, tp_axis, dtype=dtype,
                             mesh=mesh, device=device, gen=gen)
            return
        self.attn = Attention(dim, num_heads, attn, sp_axis=sp_axis,
                              mesh=mesh, dtype=dtype, device=device, gen=gen)
        self.ln2 = LayerNorm(dim, dtype=ln_dtype, device=device)
        self.fc1 = Dense(dim, mlp_ratio * dim, use_bias=True, dtype=dtype,
                         device=device, gen=gen)
        self.fc2 = Dense(mlp_ratio * dim, dim, use_bias=True, dtype=dtype,
                         device=device, gen=gen)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        if self.tp:
            return x + self.mlp(self.ln2(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


def _add_block_stack(module: nn.Module, dim: int, *, num_heads, depth,
                     mlp_ratio, attn, sp_axis, tp_axis, mesh, dtype,
                     ln_dtype, device, gen, tp_gen=None) -> None:
    """Add ``depth`` Blocks named ``block_{i}`` to ``module`` (shared by
    TransformerLM and BlockStack so that their parameter names agree; the
    JAX package's ``_apply_block_stack``).  ``tp_gen`` draws the slices
    of ``tp_axis`` blocks."""
    module.depth = depth
    for i in range(depth):
        module.add_module(f"block_{i}", Block(
            dim, num_heads, mlp_ratio=mlp_ratio, attn=attn, dtype=dtype,
            ln_dtype=ln_dtype, device=device,
            gen=tp_gen if tp_axis is not None else gen, sp_axis=sp_axis,
            tp_axis=tp_axis, mesh=mesh))


def _apply_block_stack(module: nn.Module, x):
    for i in range(module.depth):
        x = getattr(module, f"block_{i}")(x)
    return x


def _tp_gen(device, seed, tp_axis, mesh):
    if tp_axis is None:
        return None
    mesh = mesh if mesh is not None else ranks_mesh()
    return shard_generator(device, seed, mesh.axis(tp_axis))


class BlockStack(nn.Module):
    """``depth`` consecutive blocks of width ``dim``: ONE pipeline stage.

    Activation-shape preserving, so it is ``pipeline_apply``'s stage:
    build each stage's with :func:`..parallel.pipeline.stage_params_init`
    and keep the embeddings and the head outside the pipeline,
    replicated.  Parameters are drawn from ``seed`` on ``device``."""

    def __init__(self, dim: int, num_heads: int, depth: int,
                 mlp_ratio: int = 4, attn: str = "full", *,
                 sp_axis=RANKS_AXIS, tp_axis=None, mesh=None,
                 dtype: torch.dtype = torch.bfloat16,
                 ln_dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        _add_block_stack(self, dim, num_heads=num_heads, depth=depth,
                         mlp_ratio=mlp_ratio, attn=attn, sp_axis=sp_axis,
                         tp_axis=tp_axis, mesh=mesh, dtype=dtype,
                         ln_dtype=ln_dtype, device=device, gen=gen,
                         tp_gen=_tp_gen(device, seed, tp_axis, mesh))

    def forward(self, x):
        return _apply_block_stack(self, x)


class TransformerLM(nn.Module):
    """Causal LM over (B, T) token ids: the whole sequence under
    ``attn="full"``/``"flash"`` (and ``tp_axis``), this rank's shard of
    it under a sequence-parallel ``attn``.

    Parameters are f32, drawn from ``seed`` with flax's initializer
    distributions on ``device`` ("cuda" unless the caller asks for the
    CPU); ``tp_axis`` slices from ``seed`` folded with the rank's ``tp``
    index.  ``dtype`` is the compute dtype of the blocks, ``head_dtype``
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
                 sp_axis=RANKS_AXIS, mesh=None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if tp_axis and attn != "full":
            raise ValueError(
                "tp_axis composes with attn='full' only (TP attention "
                f"computes the full sequence locally); got {attn!r}")
        if attn not in _ATTNS:
            raise ValueError(f"unknown attention impl: {attn!r}")
        self.attn = attn if not tp_axis else "full"
        self.sp_axis = sp_axis
        self.mesh = mesh
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.tok_emb = Embed(vocab, dim, dtype=dtype, device=device,
                             gen=gen)
        self.pos_emb = Embed(max_len, dim, dtype=dtype, device=device,
                             gen=gen)
        _add_block_stack(self, dim, num_heads=num_heads, depth=depth,
                         mlp_ratio=4, attn=attn, sp_axis=sp_axis,
                         tp_axis=tp_axis, mesh=mesh, dtype=dtype,
                         ln_dtype=ln_dtype, device=device, gen=gen,
                         tp_gen=_tp_gen(device, seed, tp_axis, mesh))
        self.ln_f = LayerNorm(dim, dtype=ln_dtype, device=device)
        self.head = Dense(dim, vocab, use_bias=False, dtype=head_dtype,
                          device=device, gen=gen)

    def positions(self, T: int, device) -> torch.Tensor:
        """Global positions of this rank's ``T`` tokens."""
        if self.attn in ("full", "flash"):
            return torch.arange(T, device=device)
        ax = (self.mesh if self.mesh is not None
              else ranks_mesh()).axis(self.sp_axis)
        if self.attn == "ring_zigzag":
            return zigzag_shard_positions(ax.index, ax.size, T, device)
        return ax.index * T + torch.arange(T, device=device)

    def forward(self, tokens, return_hidden: bool = False):
        pos = self.positions(tokens.shape[1], tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(pos)[None]
        x = _apply_block_stack(self, x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.head(x)
