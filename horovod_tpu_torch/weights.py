"""Carry flax parameters into the port's modules.

No JAX counterpart.  The port's modules keep flax's parameter names,
shapes and layouts (Dense kernels (in, out), the raw (C, 3C) qkv kernel,
LayerNorm ``scale``/``bias``, Embed ``embedding``), so a flax ``params``
tree maps onto a ``state_dict`` by joining its keys with dots; nothing is
transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a flax ``params`` tree (nested mappings of
    arrays): ``params["block_0"]["attn"]["qkv"]["kernel"]`` becomes
    ``"block_0.attn.qkv.kernel"``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
            else:
                out[name] = torch.from_numpy(np.array(value))

    walk(params, "")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy a flax ``params`` tree into ``model`` (strict: every name and
    shape must match)."""
    model.load_state_dict(from_flax(params), strict=True)
