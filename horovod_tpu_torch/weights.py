"""Carry flax parameters and optax optimizer state into the port.

No JAX counterpart.  The port's modules keep flax's parameter names,
shapes and layouts (Dense kernels (in, out), the raw (C, 3C) qkv kernel,
LayerNorm ``scale``/``bias``, Embed ``embedding``), so a flax ``params``
tree maps onto a ``state_dict`` by joining its keys with dots; nothing is
transposed.  Optimizer state trees have the shape of ``params`` and map
the same way.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


def load_optax_sgd_state(optimizer, model: torch.nn.Module, trace: Mapping,
                         residual: Optional[Mapping] = None) -> None:
    """Load an optax SGD-momentum state into a ``torch.optim.SGD`` over
    ``model``'s parameters, or a ``DistributedOptimizer`` around one.

    ``trace`` is the ``TraceState.trace`` tree of ``optax.sgd(lr,
    momentum=m)`` (it becomes each parameter's ``momentum_buffer``: both
    compute ``trace = g + m * trace``), ``residual`` the
    ``ErrorFeedbackState.residual`` tree of the JAX package's
    ``DistributedOptimizer(error_feedback=True)`` (it becomes
    ``state[p]["residual"]``, f32).  Both are trees of arrays shaped like
    the flax ``params`` of ``model``; every name must match."""
    params = dict(model.named_parameters())
    for key, tree in (("momentum_buffer", trace), ("residual", residual)):
        if tree is None:
            continue
        values = from_flax(tree)
        if values.keys() != params.keys():
            raise ValueError(f"{key}: names {sorted(values)} do not match "
                             f"the model's {sorted(params)}")
        for name, value in values.items():
            p = params[name]
            dtype = torch.float32 if key == "residual" else p.dtype
            optimizer.state[p][key] = value.to(device=p.device, dtype=dtype)
