"""Tensor (model) parallelism: Megatron-style sharded matmuls over a mesh
axis.

Port of ``horovod_tpu/parallel/tensor_parallel.py``:
``matmul_reducescatter`` (:49), ``ColumnParallelDense`` (:93),
``RowParallelDense`` (:130), ``TPMlp`` (:176), ``TPSelfAttention``
(:193), ``tp_spec_tree`` (:262) and ``tp_value_and_grad`` (:320).

* :class:`ColumnParallelDense` -- output features sharded: each rank holds
  ``features / tp`` columns of the kernel and computes its slice with no
  communication; its replicated input passes :func:`.collectives.pvary`
  (Megatron's f: identity forward, the cotangent summed over ``tp``
  backward).
* :class:`RowParallelDense` -- input features sharded: each rank holds
  ``in / tp`` rows, computes a partial product, and one
  :func:`.collectives.psum` (g: identity backward) completes it.  The
  bias is replicated and added once, after the reduction.

Parameters are materially sharded: each rank builds only its slice, drawn
from a generator seeded with :func:`.mesh.fold_in` of the seed and its
``tp`` index, with the reference's initializers on the slice's own shape.
The JAX package's ``tp_abstract_params`` (:232) and ``tp_optimizer_specs``
(:295) build shape and ``PartitionSpec`` trees for ``shard_map``; the port
has no such trees to build, since every rank constructs its own slice and
its optimizer state follows it.  Their counterpart is the weights
carry-over (:func:`horovod_tpu_torch.weights.load_flax_tp_params`), which
slices a JAX tree by :func:`tp_spec_tree`'s classification.

Train with :func:`tp_value_and_grad`, not ``make_train_step``: the latter
averages every gradient over the world, which is right for data and
sequence parallelism only, where every parameter is replicated.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from horovod_tpu_torch.models.layers import _trunc_normal
from horovod_tpu_torch.parallel.collectives import ppermute, psum, pvary
from horovod_tpu_torch.parallel.mesh import ranks_mesh, resolve
from horovod_tpu_torch.parallel.ring_attention import full_attention

TP_AXIS = "tp"


def matmul_reducescatter(x, kernel, axis=TP_AXIS, *, mesh=None):
    """``x @ kernel`` summed over ``axis`` with row block ``idx`` of the
    result left on shard ``idx``: an n-step ring where the accumulator of
    one output row block hops to the neighbour (:func:`ppermute`) while
    the next block's partial product is computed.

    ``x``: ``(..., rows, k_local)``; ``kernel``: ``(k_local, features)``.
    Returns ``(..., rows // n, features)``.  The accumulation order
    differs from ``psum``'s, so results agree to float tolerance."""
    ax = resolve(mesh, axis)
    n, idx = ax.size, ax.index
    rows = x.shape[-2]
    if rows % n:
        raise ValueError(
            f"matmul_reducescatter: rows={rows} not divisible by "
            f"axis size {n}")
    blk = rows // n

    def block_partial(step):
        j = (idx + 1 + step) % n
        return x[..., j * blk:(j + 1) * blk, :] @ kernel

    acc = block_partial(0)
    perm = [(i, (i - 1) % n) for i in range(n)]
    for s in range(1, n):
        acc = ppermute(acc, ax, perm) + block_partial(s)
    return acc


class ColumnParallelDense(nn.Module):
    """Dense with output features sharded over ``axis``: ``features`` is
    the GLOBAL width, of which this rank computes ``features // tp``.
    The input must be replicated across ``axis``; the output is
    feature-sharded.  ``gen`` draws this shard's kernel (lecun normal on
    the slice's shape); the bias starts at zero."""

    def __init__(self, in_features: int, features: int, axis=TP_AXIS, *,
                 use_bias: bool = True, dtype=torch.bfloat16, mesh=None,
                 device="cuda", gen=None):
        super().__init__()
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        n = resolve(mesh, axis).size
        if features % n:
            raise ValueError(
                f"ColumnParallelDense features={features} not divisible "
                f"by tp={n}")
        local = features // n
        self.kernel = nn.Parameter(
            _trunc_normal((in_features, local), in_features, device, gen))
        self.bias = (nn.Parameter(torch.zeros(local, device=device))
                     if use_bias else None)

    def forward(self, x):
        x = pvary(x, self.axis, mesh=self.mesh)
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RowParallelDense(nn.Module):
    """Dense with input features sharded over ``axis``: this rank holds
    ``in_local`` rows of the global ``(in, features)`` kernel, and the
    partial products are reduced with one :func:`psum`; the result is
    replicated.  ``scatter_output=True`` reduces with
    :func:`matmul_reducescatter` instead, leaving the token dimension
    scattered over ``axis``; the replicated bias then meets a sharded
    value and passes :func:`pvary`."""

    def __init__(self, in_local: int, features: int, axis=TP_AXIS, *,
                 use_bias: bool = True, dtype=torch.bfloat16,
                 scatter_output: bool = False, mesh=None, device="cuda",
                 gen=None):
        super().__init__()
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        self.scatter_output = scatter_output
        self.kernel = nn.Parameter(
            _trunc_normal((in_local, features), in_local, device, gen))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        x = x.to(self.dtype)
        kernel = self.kernel.to(self.dtype)
        if self.scatter_output:
            y = matmul_reducescatter(x, kernel, self.axis, mesh=self.mesh)
        else:
            y = psum(x @ kernel, self.axis, mesh=self.mesh)
        if self.bias is not None:
            bias = self.bias
            if self.scatter_output:
                bias = pvary(bias, self.axis, mesh=self.mesh)
            y = y + bias.to(self.dtype)
        return y


class TPMlp(nn.Module):
    """Megatron MLP: Column(hidden) -> tanh GELU -> Row(out), one psum."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 axis=TP_AXIS, *, dtype=torch.bfloat16, mesh=None,
                 device="cuda", gen=None):
        super().__init__()
        n = resolve(mesh, axis).size
        self.col = ColumnParallelDense(in_features, hidden, axis,
                                       dtype=dtype, mesh=mesh,
                                       device=device, gen=gen)
        self.row = RowParallelDense(hidden // n, out, axis, dtype=dtype,
                                    mesh=mesh, device=device, gen=gen)

    def forward(self, x):
        return self.row(F.gelu(self.col(x), approximate="tanh"))


class TPSelfAttention(nn.Module):
    """Causal self-attention with heads sharded over ``axis``: q/k/v
    column-parallel (``num_heads // tp`` heads a rank), the oracle
    attention on them locally, the output projection row-parallel."""

    def __init__(self, dim: int, num_heads: int, axis=TP_AXIS, *,
                 causal: bool = True, dtype=torch.bfloat16, mesh=None,
                 device="cuda", gen=None):
        super().__init__()
        n = resolve(mesh, axis).size
        if num_heads % n:
            raise ValueError(
                f"num_heads={num_heads} not divisible by tp={n}")
        self.local_heads = num_heads // n
        self.head_dim = dim // num_heads
        self.causal = causal
        self.col_qkv = ColumnParallelDense(dim, 3 * dim, axis,
                                           use_bias=False, dtype=dtype,
                                           mesh=mesh, device=device, gen=gen)
        self.row_proj = RowParallelDense(dim // n, dim, axis, use_bias=False,
                                         dtype=dtype, mesh=mesh,
                                         device=device, gen=gen)

    def forward(self, x):
        B, T, _ = x.shape
        q, k, v = (t.reshape(B, T, self.local_heads, self.head_dim)
                   for t in self.col_qkv(x).chunk(3, dim=-1))
        out = full_attention(q, k, v, causal=self.causal)
        return self.row_proj(out.reshape(B, T, -1))


# --------------------------------------------------------- spec derivation


def _is_col_name(name: str) -> bool:
    return (name.startswith("ColumnParallelDense") or name == "col"
            or name.startswith("col_"))


def _is_row_name(name: str) -> bool:
    return (name.startswith("RowParallelDense") or name == "row"
            or name.startswith("row_"))


def tp_spec_tree(params, axis: str = TP_AXIS):
    """The spec tree of a parameter tree holding parallel layers: the
    tree's structure with, at each leaf, a tuple naming the axis each
    dimension is sharded over (``PartitionSpec``'s entries).  Classified
    by the leaf's DIRECT parent module name (``ColumnParallelDense_i`` /
    ``RowParallelDense_i``, or ``col`` / ``col_*`` / ``row`` / ``row_*``
    as :class:`TPMlp` and :class:`TPSelfAttention` name theirs):

    * column-parallel -- kernel ``(None, tp)``, bias ``(tp,)``;
    * row-parallel    -- kernel ``(tp, None)``, bias replicated ``()``;
    * everything else -- replicated ``()``.

    ``params`` is a nested mapping, e.g. a flax ``params`` tree."""

    def walk(tree, path):
        return {k: walk(v, path + [k]) if isinstance(v, Mapping)
                else _classify(path + [k], axis) for k, v in tree.items()}

    return walk(params, [])


def _classify(keys, axis):
    parent = keys[-2] if len(keys) >= 2 else ""
    leaf = keys[-1] if keys else ""
    if _is_col_name(parent):
        return (None, axis) if leaf == "kernel" else (axis,)
    if _is_row_name(parent):
        return (axis, None) if leaf == "kernel" else ()
    return ()


def tp_value_and_grad(loss_fn, params, dp_axes: Sequence[str] = (), *,
                      mesh=None):
    """``(loss, grads)`` of ``loss_fn(params)`` for a tensor-parallel
    model: ``params`` is an ``nn.Module`` (grads: a dict of its
    ``named_parameters``) or a tree of tensors (grads: the same tree).

    As in the JAX package, the per-shard loss is scaled by 1/dp and the
    gradients are SUMMED over the ``dp_axes`` group (there, the transpose
    of the implicit pvary of dp-invariant parameters), which makes them
    the mean; the returned loss is the global mean (the psum of the
    scaled losses).  tp-sharded parameters get their slice's gradient;
    replicated ones get the same full gradient on every rank of the
    ``tp`` group (the pvary/psum transposes inside the layers)."""
    from horovod_tpu_torch.spmd import reduce_gradients
    mesh = mesh if mesh is not None else ranks_mesh()
    dp_axes = tuple(dp_axes)
    if isinstance(params, nn.Module):
        names, leaves = zip(*[(n, p) for n, p in params.named_parameters()
                              if p.requires_grad])
        spec = None
    else:
        leaves, spec = tree_flatten(params)
    loss = loss_fn(params)
    for ax in dp_axes:
        loss = loss / mesh.axis_size(ax)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    loss = loss.detach()
    if dp_axes:
        dp = mesh.axis(dp_axes)
        if dp.size > 1:
            grads = reduce_gradients(grads, average=False, group=dp.group)
            loss = psum(loss, dp)
    if spec is None:
        return loss, dict(zip(names, grads))
    return loss, tree_unflatten(grads, spec)
