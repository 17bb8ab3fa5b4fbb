"""Carry flax parameters and optax optimizer state into the port.

No JAX counterpart.  The port's modules keep flax's parameter names,
shapes and layouts (Dense kernels (in, out), the raw (C, 3C) qkv kernel,
LayerNorm and BatchNorm ``scale``/``bias``, Embed ``embedding``, BatchNorm
``batch_stats`` ``mean``/``var`` as buffers), so a flax tree maps onto a
``state_dict`` by joining its keys with dots.  One layout differs: a 4-D
``kernel`` is a convolution's, HWIO in flax and OIHW in the port, and is
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
    ``"block_0.attn.qkv.kernel"``; a 4-D ``kernel`` (HWIO) becomes OIHW."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
            else:
                t = torch.from_numpy(np.array(value))
                if key == "kernel" and t.dim() == 4:
                    t = t.permute(3, 2, 0, 1).contiguous()
                out[name] = t

    walk(params, "")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy a flax ``params`` tree into ``model`` (strict: every name and
    shape must match)."""
    model.load_state_dict(from_flax(params), strict=True)


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a flax variables dict -- ``{"params": ..., "batch_stats":
    ...}`` -- into ``model``'s parameters and buffers (strict: every name
    and shape must match)."""
    state = from_flax(variables["params"])
    state.update(from_flax(variables.get("batch_stats", {})))
    model.load_state_dict(state, strict=True)


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
    the flax ``params`` of ``model``, in flax's layouts (conv leaves are
    transposed as in :func:`from_flax`); every name must match."""
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
