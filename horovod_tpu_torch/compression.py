"""Gradient compression: cast the gradient to a narrower wire dtype around
the collective and back after it.

Port of ``horovod_tpu/compression.py:16-60`` (``Compressor``,
``NoneCompressor``, the FP16 and BF16 cast compressors).  The int8
compressor waits for the port of the int8 codec kernels.
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


class Compression:
    """Namespace parity with ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
