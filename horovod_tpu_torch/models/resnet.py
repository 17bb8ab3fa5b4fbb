"""ResNet family (v1.5).

Port of ``horovod_tpu/models/resnet.py``: ``BottleneckBlock`` (:30),
``ResNet`` (:63) and ``ResNet50/101/152`` (:111-113), with flax's module
names (``conv_init``, ``bn_init``, ``BottleneckBlock_<i>`` holding
``Conv_0..2``, ``BatchNorm_0..2``, ``conv_proj``, ``norm_proj``, and
``head``), so a flax ``{"params", "batch_stats"}`` pair loads with
:func:`horovod_tpu_torch.weights.load_flax_variables`.  ``remat`` is not
ported.

* **Layout.**  The model takes the reference's NHWC images and views them
  as NCHW in ``channels_last`` memory (``permute`` copies nothing), so the
  convolutions run channels-last in cuDNN through ``F.conv2d``.  They
  stand where XLA's convolutions stand in the JAX package, which has no
  Pallas kernel on this path.  Conv kernels are OIHW here, HWIO in flax.
* **Padding.**  flax's ``padding="SAME"`` pads ``total = max((ceil(in/s)
  - 1) * s + k - in, 0)``, ``total // 2`` low and the rest high: (0, 1)
  for the 3x3 stride-2 convolution on an even input, where PyTorch's
  ``padding=1`` would shift every output pixel.  ``conv_init`` pads
  (3, 3) explicitly, ``max_pool`` (1, 1) with -inf.
* **BatchNorm** with flax's semantics (``flax/linen/normalization.py``),
  which neither ``nn.BatchNorm2d`` nor ``F.batch_norm`` has: f32
  statistics with the fast biased variance ``max(0, E[x^2] - E[x]^2)``;
  running averages ``ra = 0.9 * ra + 0.1 * stat`` for the mean and the
  variance alike, in the ``mean`` and ``var`` buffers (no counter); the
  output ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias`` in f32, cast
  to ``dtype``.  ``model.train()`` normalises with the batch's statistics
  and updates the buffers, ``model.eval()`` uses the buffers.
* **Head.**  The spatial mean reduces in f32 and returns ``dtype``, as
  ``jnp.mean`` of a bf16 tensor does; the ``head`` Dense runs in f32, so
  the logits are f32.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense, _trunc_normal

# The reference's BatchNorm settings (``horovod_tpu/models/resnet.py:82``).
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def same_padding(size: int, kernel: int, stride: int):
    """flax's ``padding="SAME"`` for one spatial dimension: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` on NCHW views: ``kernel`` (O, I,
    kh, kw) in f32, input and kernel cast to ``dtype`` for the product.
    ``padding`` is ``"SAME"`` or an explicit (ph, pw)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1), padding="SAME", *, dtype: torch.dtype,
                 device, gen):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        # flax's lecun_normal: fan_in = kh * kw * in_features.
        self.kernel = nn.Parameter(_trunc_normal(
            (features, in_features, kh, kw), kh * kw * in_features, device,
            gen))

    def forward(self, x):
        x = x.to(self.dtype)
        kh, kw = self.kernel.shape[2:]
        if self.padding == "SAME":
            (lh, hh), (lw, hw) = (
                same_padding(x.shape[2], kh, self.strides[0]),
                same_padding(x.shape[3], kw, self.strides[1]))
            if lh or hh or lw or hw:
                x = F.pad(x, (lw, hw, lh, hh))
            pad = 0
        else:
            pad = self.padding
        return F.conv2d(x, self.kernel.to(self.dtype), stride=self.strides,
                        padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NCHW view (see the module docstring)."""

    def __init__(self, features: int, *, dtype: torch.dtype, device,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x):
        # Two casts of x, as flax has (one for the statistics, one for the
        # normalisation): the backward then rounds each branch's gradient
        # to ``dtype`` before summing them, as the reference does.
        if self.training:
            xs = x.float()
            mean = xs.mean(dim=(0, 2, 3))
            var = ((xs * xs).mean(dim=(0, 2, 3))
                   - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                keep = 1.0 - BN_MOMENTUM
                self.mean.mul_(BN_MOMENTUM).add_(keep * mean)
                self.var.mul_(BN_MOMENTUM).add_(keep * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        y = ((x.float() - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut where the
    shape changes (ResNet v1.5: the stride lives on the 3x3)."""

    def __init__(self, in_features: int, filters: int, strides, *,
                 dtype: torch.dtype, device, gen):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device, gen=gen)
        norm = functools.partial(BatchNorm, dtype=dtype, device=device)
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, (1, 1))
        # Zero-init the last BN scale: identity-at-init residual branches.
        self.BatchNorm_2 = norm(filters * 4, zero_scale=True)
        self.project = (in_features != filters * 4
                        or tuple(strides) != (1, 1))
        if self.project:
            self.conv_proj = conv(in_features, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 for NHWC images (N, H, W, 3); returns f32 logits.

    Parameters are f32, drawn from ``seed`` with flax's initializer
    distributions on ``device`` ("cuda" unless the caller asks for the
    CPU); ``dtype`` is the compute dtype of the convolutions and the
    BatchNorm outputs.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), padding=(3, 3),
                              dtype=dtype, device=device, gen=gen)
        self.bn_init = BatchNorm(num_filters, dtype=dtype, device=device)
        self.num_blocks = 0
        features = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                self.add_module(
                    f"BottleneckBlock_{self.num_blocks}",
                    BottleneckBlock(features, filters, strides, dtype=dtype,
                                    device=device, gen=gen))
                features = filters * 4
                self.num_blocks += 1
        self.head = Dense(features, num_classes, use_bias=True,
                          dtype=torch.float32, device=device, gen=gen)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x)


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])
