"""Inception V3 and VGG-16, the reference Horovod's scaling anchors.

Port of ``horovod_tpu/models/inception.py``: ``ConvBN`` (:26),
``InceptionA``-``E`` (:50-139), ``InceptionV3`` (:142) and ``VGG16``
(:182), with flax's module names, so a flax ``{"params",
"batch_stats"}`` pair loads with
:func:`horovod_tpu_torch.weights.load_flax_variables`.  flax numbers the
submodules of a block in the order it creates them: ``InceptionE_0``
holds ``ConvBN_0..8`` for b1, the b3 1x1, 1x3 and 3x1, the bd 1x1, 3x3,
1x3 and 3x1, and the pool branch; each ``ConvBN_i`` holds ``Conv_0`` and
``BatchNorm_0``.

The layers are :mod:`.resnet`'s: NHWC images viewed as NCHW in
``channels_last`` memory, cuDNN convolutions through ``F.conv2d`` (no
port kernel lies on these paths, as no Pallas kernel lies on the JAX
package's), flax's SAME padding, BatchNorm and pools.  Branches are
concatenated along dim 1, the channels of the NCHW view, which
``torch.cat`` keeps in ``channels_last``.

* **InceptionV3**: bias-free convolutions, BatchNorm with epsilon 1e-3,
  flax's ``avg_pool(padding="SAME")`` (zero padding counted) and
  ``max_pool`` (VALID); the head is the spatial mean in f32, cast to
  ``dtype``, then an f32 ``head`` Dense.  No aux classifier, as in the
  reference.
* **VGG16**: 13 convolutions with bias and ReLU named
  ``conv{stage}_{i}``, 2x2 max pools, ``fc1``, ``fc2`` and an f32
  ``head``.  flax flattens the NHWC map in (H, W, C) order, so the NCHW
  view is permuted back to NHWC before the flatten; only then does
  ``fc1``'s (25088, 4096) kernel carried from flax compute the same
  thing at 224 x 224.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense
from horovod_tpu_torch.models.resnet import (BatchNorm, Conv, avg_pool,
                                             max_pool)

# The reference's BatchNorm epsilon for Inception V3 (inception.py:154).
INCEPTION_BN_EPSILON = 1e-3


class ConvBN(nn.Module):
    """conv -> BN -> relu, the V3 building unit (bias-free conv)."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=(1, 1), padding="SAME", *, dtype: torch.dtype,
                 device, gen):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           dtype=dtype, device=device, gen=gen)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device,
                                     epsilon=INCEPTION_BN_EPSILON)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Block(nn.Module):
    """A block whose ``ConvBN`` units are named ``ConvBN_<i>`` in the
    order :meth:`cb` creates them, as flax names them.  Branches keep
    their units in plain lists, so that each is registered once."""

    def __init__(self, *, dtype, device, gen):
        super().__init__()
        self._kw = dict(dtype=dtype, device=device, gen=gen)
        self._n = 0

    def cb(self, in_features, features, kernel, strides=(1, 1),
           padding="SAME") -> ConvBN:
        unit = ConvBN(in_features, features, kernel, strides, padding,
                      **self._kw)
        self.add_module(f"ConvBN_{self._n}", unit)
        self._n += 1
        return unit


class InceptionA(_Block):
    """35x35: 1x1, 5x5, double 3x3 and pool branches."""

    def __init__(self, in_features: int, pool_features: int, **kw):
        super().__init__(**kw)
        self.b1 = [self.cb(in_features, 64, (1, 1))]
        self.b5 = [self.cb(in_features, 48, (1, 1)), self.cb(48, 64, (5, 5))]
        self.b3 = [self.cb(in_features, 64, (1, 1)), self.cb(64, 96, (3, 3)),
                   self.cb(96, 96, (3, 3))]
        self.bp = [self.cb(in_features, pool_features, (1, 1))]
        self.features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b5, x),
                          _chain(self.b3, x),
                          _chain(self.bp, avg_pool(x, (3, 3)))], dim=1)


class InceptionB(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, in_features: int, **kw):
        super().__init__(**kw)
        self.b3 = [self.cb(in_features, 384, (3, 3), (2, 2), "VALID")]
        self.bd = [self.cb(in_features, 64, (1, 1)), self.cb(64, 96, (3, 3)),
                   self.cb(96, 96, (3, 3), (2, 2), "VALID")]
        self.features = 384 + 96 + in_features

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.bd, x),
                          max_pool(x, (3, 3), (2, 2))], dim=1)


class InceptionC(_Block):
    """Factorized 7x7 branches at 17x17."""

    def __init__(self, in_features: int, channels_7x7: int, **kw):
        super().__init__(**kw)
        c7 = channels_7x7
        self.b1 = [self.cb(in_features, 192, (1, 1))]
        self.b7 = [self.cb(in_features, c7, (1, 1)), self.cb(c7, c7, (1, 7)),
                   self.cb(c7, 192, (7, 1))]
        self.bd = [self.cb(in_features, c7, (1, 1)), self.cb(c7, c7, (7, 1)),
                   self.cb(c7, c7, (1, 7)), self.cb(c7, c7, (7, 1)),
                   self.cb(c7, 192, (1, 7))]
        self.bp = [self.cb(in_features, 192, (1, 1))]
        self.features = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b7, x),
                          _chain(self.bd, x),
                          _chain(self.bp, avg_pool(x, (3, 3)))], dim=1)


class InceptionD(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, in_features: int, **kw):
        super().__init__(**kw)
        self.b3 = [self.cb(in_features, 192, (1, 1)),
                   self.cb(192, 320, (3, 3), (2, 2), "VALID")]
        self.b7 = [self.cb(in_features, 192, (1, 1)),
                   self.cb(192, 192, (1, 7)), self.cb(192, 192, (7, 1)),
                   self.cb(192, 192, (3, 3), (2, 2), "VALID")]
        self.features = 320 + 192 + in_features

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.b7, x),
                          max_pool(x, (3, 3), (2, 2))], dim=1)


class InceptionE(_Block):
    """Expanded 3x3 branches at 8x8."""

    def __init__(self, in_features: int, **kw):
        super().__init__(**kw)
        self.b1 = [self.cb(in_features, 320, (1, 1))]
        self.b3 = [self.cb(in_features, 384, (1, 1))]
        self.b3_split = [self.cb(384, 384, (1, 3)), self.cb(384, 384, (3, 1))]
        self.bd = [self.cb(in_features, 448, (1, 1)),
                   self.cb(448, 384, (3, 3))]
        self.bd_split = [self.cb(384, 384, (1, 3)), self.cb(384, 384, (3, 1))]
        self.bp = [self.cb(in_features, 192, (1, 1))]
        self.features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = _chain(self.b3, x)
        bd = _chain(self.bd, x)
        return torch.cat([_chain(self.b1, x)]
                         + [u(b3) for u in self.b3_split]
                         + [u(bd) for u in self.bd_split]
                         + [_chain(self.bp, avg_pool(x, (3, 3)))], dim=1)


def _chain(units, x):
    for unit in units:
        x = unit(x)
    return x


class InceptionV3(nn.Module):
    """Inception V3 for NHWC images (N, H, W, 3), canonical 299 x 299 (any
    size >= 75 works); returns f32 logits.

    Parameters are f32, drawn from ``seed`` with flax's initializer
    distributions on ``device`` ("cuda" unless the caller asks for the
    CPU); ``dtype`` is the compute dtype of the convolutions and the
    BatchNorm outputs.
    """

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, gen=gen)
        cb = functools.partial(ConvBN, **kw)
        self.ConvBN_0 = cb(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = cb(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = cb(32, 64, (3, 3))
        self.ConvBN_3 = cb(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = cb(80, 192, (3, 3), padding="VALID")
        blocks, features = [], 192
        for i, pool_features in enumerate((32, 64, 64)):
            blocks.append((f"InceptionA_{i}",
                           InceptionA(features, pool_features, **kw)))
            features = blocks[-1][1].features
        blocks.append(("InceptionB_0", InceptionB(features, **kw)))
        features = blocks[-1][1].features
        for i, c7 in enumerate((128, 160, 160, 192)):
            blocks.append((f"InceptionC_{i}", InceptionC(features, c7, **kw)))
            features = blocks[-1][1].features
        blocks.append(("InceptionD_0", InceptionD(features, **kw)))
        features = blocks[-1][1].features
        for i in range(2):
            blocks.append((f"InceptionE_{i}", InceptionE(features, **kw)))
            features = blocks[-1][1].features
        for name, block in blocks:
            self.add_module(name, block)
        self.blocks = [name for name, _ in blocks]
        self.head = Dense(features, num_classes, use_bias=True,
                          dtype=torch.float32, device=device, gen=gen)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = max_pool(x, (3, 3), (2, 2))
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = max_pool(x, (3, 3), (2, 2))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x)


class VGG16(nn.Module):
    """VGG-16 for NHWC images: 13 convolutions in 5 stages and 3 fully
    connected layers, no BatchNorm, an f32 ``head``; returns f32 logits.
    ``image_size`` (an int or (H, W), 224 by default) fixes ``fc1``'s
    input width, which flax infers at ``init``."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 stage_sizes: Sequence[int] = (2, 2, 3, 3, 3), *,
                 image_size=224, seed: int = 0, device="cuda"):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.convs = []
        features, channels = 64, 3
        for stage, n in enumerate(stage_sizes):
            for i in range(n):
                name = f"conv{stage}_{i}"
                self.add_module(name, Conv(
                    channels, min(features, 512), (3, 3), dtype=dtype,
                    device=device, gen=gen, use_bias=True))
                self.convs.append(name)
                channels = min(features, 512)
            self.convs.append(None)          # the stage's 2x2 max pool
            h, w = h // 2, w // 2
            features *= 2
        dense = functools.partial(Dense, use_bias=True, device=device,
                                  gen=gen)
        self.fc1 = dense(h * w * channels, 4096, dtype=dtype)
        self.fc2 = dense(4096, 4096, dtype=dtype)
        self.head = dense(4096, num_classes, dtype=torch.float32)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for name in self.convs:
            x = (max_pool(x, (2, 2), (2, 2)) if name is None
                 else F.relu(getattr(self, name)(x)))
        # flax flattens NHWC: back to (N, H, W, C) before the flatten.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.head(x)
