"""MNIST-scale models, the framework's smoke-test family.

Port of ``horovod_tpu/models/mlp.py``: ``MLP`` (:17) and ``ConvNet``
(:33), with flax's parameter names (``dense_<i>`` and ``head``;
``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``), so a flax ``params``
tree loads with :func:`horovod_tpu_torch.weights.load_flax_params`.
flax infers the input width of the first Dense at ``init``; here the
constructor takes it (``in_features``, or ConvNet's ``image_size`` and
``channels``).  ConvNet views the NHWC images as NCHW in
``channels_last`` memory, as :mod:`.resnet` does, and permutes back to
NHWC before the flatten, whose (H, W, C) order ``Dense_0``'s kernel
carried from flax expects.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense
from horovod_tpu_torch.models.resnet import Conv, max_pool


class MLP(nn.Module):
    """Plain MLP classifier: the input flattened to ``in_features``, one
    ReLU Dense (``dense_<i>``) a width of ``features``, an f32 ``head``."""

    def __init__(self, in_features: int, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 *, seed: int = 0, device="cuda"):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(
                in_features, f, use_bias=True, dtype=dtype, device=device,
                gen=gen))
            in_features = f
        self.head = Dense(in_features, num_classes, use_bias=True,
                          dtype=torch.float32, device=device, gen=gen)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)


class ConvNet(nn.Module):
    """The reference MNIST conv net: two 5x5 SAME convolutions with bias
    and ReLU, each followed by a 2x2 max pool, then a 512-wide ReLU Dense
    and an f32 Dense to the classes.  Takes NHWC images (N, H, W, C) or
    (N, H, W), which gain a channel axis; ``image_size`` (int or (H, W))
    and ``channels`` fix ``Dense_0``'s input width (28 x 28 x 1 by
    default)."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, image_size=28,
                 channels: int = 1, seed: int = 0, device="cuda"):
        super().__init__()
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        conv = functools.partial(Conv, padding="SAME", dtype=dtype,
                                 device=device, gen=gen, use_bias=True)
        self.Conv_0 = conv(channels, 32, (5, 5))
        self.Conv_1 = conv(32, 64, (5, 5))
        self.Dense_0 = Dense((h // 4) * (w // 4) * 64, 512, use_bias=True,
                             dtype=dtype, device=device, gen=gen)
        self.Dense_1 = Dense(512, num_classes, use_bias=True,
                             dtype=torch.float32, device=device, gen=gen)

    def forward(self, x):
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = max_pool(F.relu(self.Conv_0(x)), (2, 2), (2, 2))
        x = max_pool(F.relu(self.Conv_1(x)), (2, 2), (2, 2))
        # flax flattens NHWC: back to (N, H, W, C) before the flatten.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)
