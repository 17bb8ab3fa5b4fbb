"""Carry flax parameters and optax optimizer state into the port.

No JAX counterpart.  The port's modules keep flax's parameter names,
shapes and layouts (Dense kernels (in, out), the raw (C, 3C) qkv kernel,
LayerNorm and BatchNorm ``scale``/``bias``, Embed ``embedding``, BatchNorm
``batch_stats`` ``mean``/``var`` as buffers), so a flax tree maps onto a
``state_dict`` by joining its keys with dots.  One layout differs: a 4-D
``kernel`` is a convolution's, HWIO in flax and OIHW in the port, and is
transposed.  Optimizer state trees have the shape of ``params`` and map
the same way.

The model-parallel layouts: :func:`load_flax_tp_params` slices a
tensor-parallel tree by ``tp_spec_tree``'s classification (the
counterpart of the JAX package's ``tp_abstract_params`` /
``tp_optimizer_specs``, which build ``shard_map`` specs the port does not
need); :func:`load_flax_stage_params` and :func:`load_flax_expert_params`
take one stage or one expert of trees stacked over ``pp`` or ``ep``; the
sequence-parallel models share ``attn="full"``'s tree and load with
:func:`load_flax_params`.  :func:`dense_to_tp_state` and
:func:`tp_to_dense_state` move a TransformerLM's weights between its
``attn="full"`` layout and its ``tp_axis`` slices.
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


# ------------------------------------------------- model-parallel layouts


def tp_shard_tree(params: Mapping, index: int, size: int,
                  axis: str = "tp") -> Dict:
    """Shard ``index`` of ``size`` of a tensor-parallel flax tree, as
    ``shard_map`` returns it with ``tp_spec_tree``'s out_specs (each
    sharded leaf the concatenation of the shards' slices along its
    sharded dimension): every leaf that
    :func:`~horovod_tpu_torch.parallel.tensor_parallel.tp_spec_tree`
    classifies as sharded is cut along that dimension, the others are
    kept whole."""
    from horovod_tpu_torch.parallel.tensor_parallel import tp_spec_tree
    specs = tp_spec_tree(params, axis)

    def walk(tree, spec):
        out = {}
        for key, value in tree.items():
            if isinstance(value, Mapping):
                out[key] = walk(value, spec[key])
                continue
            value = np.asarray(value)
            for dim, name in enumerate(spec[key]):
                if name == axis:
                    value = np.split(value, size, axis=dim)[index]
            out[key] = value
        return out

    return walk(params, specs)


def load_flax_tp_params(model: torch.nn.Module, params: Mapping, index: int,
                        size: int, axis: str = "tp") -> None:
    """Load rank ``index``'s slice (of ``size``) of a tensor-parallel flax
    ``params`` tree into ``model`` (strict): :func:`tp_shard_tree`, then
    :func:`load_flax_params`."""
    load_flax_params(model, tp_shard_tree(params, index, size, axis))


def load_flax_stage_params(module: torch.nn.Module, params: Mapping,
                           stage: int) -> None:
    """Load stage ``stage`` of a pipeline's stage trees stacked over
    ``pp`` (each leaf's leading dimension indexes the stages) into one
    stage's ``module`` (strict)."""
    load_flax_params(module, _index_leading(params, stage))


def load_flax_expert_params(layer: torch.nn.Module, params: Mapping,
                            expert: int) -> None:
    """Load an ``MoELayer`` tree whose ``w1``/``w2`` are stacked over
    ``ep`` (leading dimension: the expert) into the layer of the rank
    holding ``expert``; the router is replicated and loads whole
    (strict)."""
    tree = dict(params)
    for key in ("w1", "w2"):
        tree[key] = np.asarray(params[key])[expert]
    load_flax_params(layer, tree)


def _index_leading(tree: Mapping, i: int) -> Dict:
    return {k: _index_leading(v, i) if isinstance(v, Mapping)
            else np.asarray(v)[i] for k, v in tree.items()}


def _tp_dense_names(depth: int):
    """(dense name, tp name, sharded dimension or None) of every block
    parameter whose name differs between ``attn="full"`` and
    ``tp_axis``; the fused q | k | v kernel is handled apart."""
    for i in range(depth):
        b = f"block_{i}."
        yield b + "attn.proj.kernel", b + "attn.row_proj.kernel", 0
        yield b + "fc1.kernel", b + "mlp.col.kernel", 1
        yield b + "fc1.bias", b + "mlp.col.bias", 0
        yield b + "fc2.kernel", b + "mlp.row.kernel", 0
        yield b + "fc2.bias", b + "mlp.row.bias", None


def dense_to_tp_state(state: Mapping, depth: int, index: int,
                      size: int) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s ``state_dict`` (of ``size`` tp ranks) of a
    ``TransformerLM(tp_axis=...)`` holding the same function as the
    ``attn="full"`` model whose ``state_dict`` is ``state``: the heads
    and MLP columns of block ``i`` that rank ``index`` computes.  A
    rank's ``col_qkv`` kernel is its heads' q | k | v columns."""
    out = {k: v for k, v in state.items()
           if ".attn.qkv." not in k
           and k not in {d for d, _, _ in _tp_dense_names(depth)}}
    for dense, tp, dim in _tp_dense_names(depth):
        v = state[dense]
        out[tp] = v if dim is None else v.chunk(size, dim=dim)[index]
    for i in range(depth):
        qkv = state[f"block_{i}.attn.qkv.kernel"]
        out[f"block_{i}.attn.col_qkv.kernel"] = torch.cat(
            [t.chunk(size, dim=1)[index] for t in qkv.chunk(3, dim=1)],
            dim=1)
    return out


def tp_to_dense_state(states, depth: int) -> Dict[str, torch.Tensor]:
    """The ``attn="full"`` ``state_dict`` of the model whose tp ranks'
    ``state_dict``s are ``states`` (in rank order): the inverse of
    :func:`dense_to_tp_state`.  Replicated entries are taken from rank
    0."""
    size = len(states)
    out = {k: v for k, v in states[0].items()
           if ".attn.col_qkv." not in k
           and k not in {t for _, t, _ in _tp_dense_names(depth)}}
    for dense, tp, dim in _tp_dense_names(depth):
        out[dense] = (states[0][tp] if dim is None
                      else torch.cat([s[tp] for s in states], dim=dim))
    for i in range(depth):
        parts = [s[f"block_{i}.attn.col_qkv.kernel"].chunk(3, dim=1)
                 for s in states]
        out[f"block_{i}.attn.qkv.kernel"] = torch.cat(
            [torch.cat([p[j] for p in parts], dim=1) for j in range(3)],
            dim=1)
    return out
