"""The ``lax`` collectives of the model-parallel modules, with JAX's
transposes as their backward.

The JAX package runs its model-parallel code inside ``shard_map(...,
check_vma=True)``, where JAX tracks whether each value varies across a
mesh axis and picks each collective's transpose from that
(``horovod_tpu/parallel/_vma.py``, ``jax/spmd.py:633-640``,
``tensor_parallel.py:320-344``).  PyTorch has no varying/invariant types,
so ``_vma.py`` has no counterpart here: each function below is an
autograd Function whose backward is the transpose JAX's autodiff uses.

=======================  ============================  ====================
function                 ``lax`` primitive              backward
=======================  ============================  ====================
:func:`psum`             ``psum`` of a varying value    identity
                         into an invariant one
:func:`pvary`            the implicit ``pvary`` where   ``psum`` of the
                         an invariant value meets a     cotangent
                         varying one
:func:`ppermute`         ``ppermute``                   ``ppermute`` by the
                                                        inverse permutation
:func:`all_to_all`       ``all_to_all(tiled=True)``     the inverse
                                                        ``all_to_all``
:func:`psum_scatter`     ``psum_scatter(tiled=True)``   ``all_gather``
=======================  ============================  ====================

``psum`` and ``pvary`` are Megatron's g/f pair.  Do not use
``torch.distributed.nn.functional.all_reduce`` for ``psum``: its backward
all-reduces the cotangent, which multiplies the gradient by the group's
size when every rank computes the same loss.

Each function takes an axis name (or a tuple of names) and the
:class:`.mesh.Mesh` that binds it (:func:`.mesh.ranks_mesh` when
``mesh`` is ``None``), or an already resolved
:class:`.mesh.AxisGroup`.  Over an axis of size 1 every collective is
the identity.  Every rank of the group must call the same collectives in the
same order, forward and backward: the modules never place one inside a
branch that depends on the rank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel.mesh import AxisGroup, Mesh, resolve


def _exchange(xs, ax: AxisGroup, perm) -> Tuple[torch.Tensor, ...]:
    """``lax.ppermute`` of each tensor of ``xs`` over ``ax``: a rank that
    no pair sends to gets zeros.  All sends and receives of the call are
    posted together in one ``dist.batch_isend_irecv``."""
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) if src else torch.zeros_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        if dst and dst[0] == me:
            out.copy_(x)
            continue
        if dst:
            ops.append(dist.P2POp(dist.isend, x, ax.ranks[dst[0]], ax.group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src[0]],
                                  ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(outs)


def _check_perm(perm, n: int):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} indices")
    return perm


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, perm, *xs):
        ctx.ax, ctx.perm = ax, perm
        return _exchange(xs, ax, perm)

    @staticmethod
    def backward(ctx, *cts):
        inverse = [(d, s) for s, d in ctx.perm]
        cts = [torch.zeros_like(c) if c is None else c for c in cts]
        return (None, None) + _exchange(cts, ctx.ax, inverse)


def ppermute(x, axis_name, perm: Sequence[Tuple[int, int]], *,
             mesh: Optional[Mesh] = None):
    """``lax.ppermute(x, axis_name, perm)``: ``perm`` is a list of
    ``(source, destination)`` axis indices; a rank no pair sends to gets
    zeros.  ``x`` may be a tensor or a tuple of tensors, which then travel
    in one batch of sends and receives.  Backward: the inverse
    permutation."""
    ax = resolve(mesh, axis_name)
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    perm = _check_perm(perm, ax.size)
    if ax.size == 1:
        out = tuple(t if (0, 0) in perm else torch.zeros_like(t) for t in xs)
    else:
        out = _PPermute.apply(ax, perm, *xs)
    return out[0] if single else out


def _all_reduce(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ax.group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.ax), None


def psum(x: torch.Tensor, axis_name, *, mesh: Optional[Mesh] = None):
    """``lax.psum`` of a value that varies over ``axis_name`` into one
    that does not: the sum over the group; backward the identity (the
    cotangent of an invariant value is already every rank's)."""
    ax = resolve(mesh, axis_name)
    return x if ax.size == 1 else _Psum.apply(x, ax)


def pvary(x: torch.Tensor, axis_name, *, mesh: Optional[Mesh] = None):
    """The ``pvary`` JAX inserts where a value invariant over
    ``axis_name`` (replicated: a parameter, or the output of a
    :func:`psum`) enters a computation that varies over it: the identity
    forward, a ``psum`` of the cotangent backward, so the replicated value
    gets the gradient of every rank's use of it."""
    ax = resolve(mesh, axis_name)
    return x if ax.size == 1 else _Pvary.apply(x, ax)


def _all_to_all(x: torch.Tensor, ax: AxisGroup, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = ax.size
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    # Block j of the split axis goes to rank j: move it to the front,
    # where all_to_all_single splits.
    inp = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=ax.group)
    # Block i now holds rank i's piece; put it at position i of the
    # concat axis.
    c = inp.shape[0] // n
    y = out.reshape((n, c) + inp.shape[1:]).movedim(1, split_axis + 1)
    return y.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.args = (ax, split_axis, concat_axis)
        return _all_to_all(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        ax, split_axis, concat_axis = ctx.args
        return _all_to_all(ct, ax, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, *, mesh: Optional[Mesh] = None):
    """``lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``: dimension ``split_axis`` splits into one block per
    rank, block j goes to rank j, and the blocks received are
    concatenated along ``concat_axis`` in rank order.  With ``split_axis
    == concat_axis`` of size n it is also the untiled form.  Backward:
    the same exchange with the two axes swapped."""
    ax = resolve(mesh, axis_name)
    if ax.size == 1:
        return x
    return _AllToAll.apply(x, ax, split_axis, concat_axis)


def _reduce_scatter(x: torch.Tensor, ax: AxisGroup, dim: int):
    n = ax.size
    dim %= x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((inp.shape[0] // n,) + inp.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM,
                               group=ax.group)
    return out.movedim(0, dim)


def _gather(x: torch.Tensor, ax: AxisGroup, dim: int):
    dim %= x.dim()
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((inp.shape[0] * ax.size,) + inp.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, inp, group=ax.group)
    return out.movedim(0, dim)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.args = (ax, dim)
        return _reduce_scatter(x, ax, dim)

    @staticmethod
    def backward(ctx, ct):
        ax, dim = ctx.args
        return _gather(ct, ax, dim), None, None


def psum_scatter(x: torch.Tensor, axis_name, scatter_dimension: int = 0, *,
                 mesh: Optional[Mesh] = None):
    """``lax.psum_scatter(x, axis_name, scatter_dimension=...,
    tiled=True)``: the sum over the group, of which this rank keeps block
    ``axis_index`` of ``scatter_dimension``.  Backward: ``all_gather``."""
    ax = resolve(mesh, axis_name)
    if ax.size == 1:
        return x
    return _PsumScatter.apply(x, ax, scatter_dimension)
