"""Gradient compression: cast the gradient to a narrower wire dtype around
the collective and back after it.

Port of ``horovod_tpu/compression.py``: ``Compressor``, ``NoneCompressor``,
the FP16 and BF16 cast compressors, ``Int8Compressor`` (snap onto the int8
block grid of :mod:`.ops.quantized_collectives`, returned in bf16), the
``Compression`` namespace and the wire-dtype names shared with the eager
plane (``WIRE_DTYPE_ALIASES``, ``canonical_wire_dtype``,
``compressor_for_wire``).
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: ``compress`` returns (compressed, ctx); ``decompress``
    restores."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """Per-block absmax int8 quantization (1024-element blocks, f32
    scales).  Where a true int8 wire exists -- the quantized ring that
    ``reduce_gradients`` and ``DistributedOptimizer`` route eligible leaves
    through -- selecting this compressor engages it.  Everywhere else
    ``compress`` snaps the tensor onto the int8 grid and returns it
    dequantized in bfloat16; non-float tensors pass through."""

    block_elems = 1024

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        from horovod_tpu_torch.ops.quantized_collectives import snap_to_grid
        return snap_to_grid(tensor).to(torch.bfloat16), tensor.dtype

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """Namespace parity with ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor


# Canonical wire-compression names ("" = raw fp32), shared with the JAX
# package's eager and in-jit planes: the same names are accepted with the
# same meaning and rejected with the same message.
WIRE_DTYPE_ALIASES = {
    "": "", "fp32": "", "float32": "", "none": "",
    "bf16": "bf16", "bfloat16": "bf16",
    "fp16": "fp16", "float16": "fp16",
    "int8": "int8",
}


def canonical_wire_dtype(name, source: str = "wire dtype") -> str:
    """Canonicalize a wire-compression name to ""/"bf16"/"fp16"/"int8";
    ``source`` names the knob being parsed in the error message."""
    key = (name or "").strip().lower()
    if key not in WIRE_DTYPE_ALIASES:
        raise ValueError(
            f"{source}={name!r}: expected none|fp32|bf16|fp16|int8")
    return WIRE_DTYPE_ALIASES[key]


def compressor_for_wire(wire: str):
    """The Compressor implementing a canonical wire name."""
    try:
        return {
            "": NoneCompressor,
            "bf16": BF16Compressor,
            "fp16": FP16Compressor,
            "int8": Int8Compressor,
        }[wire]
    except KeyError:
        raise ValueError(
            f"compressor_for_wire({wire!r}): not a canonical wire dtype "
            "(expected ''|bf16|fp16|int8)") from None
