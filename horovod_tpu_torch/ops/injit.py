"""Collectives of the train step over ``torch.distributed``.

Port of ``horovod_tpu/ops/injit.py``: ``num_ranks`` (:50), ``rank_index``
(:54), ``allreduce`` (:58), ``allgather`` (:78), ``broadcast`` (:126),
``reducescatter`` (:159), ``alltoall`` (:173) and
``staged_bucket_allreduce`` (:181).  In the JAX package these are ops
inside one XLA program over a mesh axis; here they are NCCL (or gloo)
collectives over the process group of an axis of a
:class:`..parallel.mesh.Mesh` (``axis_name``, default ``"ranks"``, of
``mesh``, default the world's :func:`..parallel.mesh.ranks_mesh`).
``allreduce`` and ``allgather`` also take a process group (``group=``).
Over an axis of one rank every collective is the identity.  The bucket
plan and issue order come from the same :mod:`..scheduler` rules.

Gradients.  JAX differentiates the whole SPMD program, whose loss is a
sum over the ranks; in PyTorch each rank's loss backpropagates on its own,
so each collective's backward is written for this convention:

* a VARYING output (``allreduce``, ``broadcast``, ``reducescatter``,
  ``alltoall``) counts in the global loss once per rank: its backward is
  JAX's transpose (``allreduce``: the all-reduce of the cotangents;
  ``broadcast``: their all-reduce, kept on the root and zero elsewhere,
  the reference's registered gradient, ``mpi_ops.py:167-182``;
  ``reducescatter``: the all-gather of the cotangents; ``alltoall``: the
  inverse exchange), so these give the JAX package's gradients under
  ``shard_map``;
* the gathered output of ``allgather`` counts once: its backward is this
  rank's slice of its own cotangent.  That is JAX's gradient where every
  rank uses the gathered value alike and it counts once
  (``out_specs=P()``; ``tests/test_injit_ops.py:125``: ``grad == w``).
  Where each rank puts the gathered value into a loss of its own, JAX
  (``check_vma=True``, ``out_specs=P("ranks")``) sums every rank's slice
  of its cotangent (``psum_scatter``); this port keeps only its own.

``MIN`` and ``MAX`` have no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel import collectives as _coll
from horovod_tpu_torch.parallel.mesh import RANKS_AXIS, AxisGroup, resolve

SUM = "sum"
AVERAGE = "average"
MIN = "min"
MAX = "max"

_OPS = {SUM: dist.ReduceOp.SUM, AVERAGE: dist.ReduceOp.SUM,
        MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX}


def num_ranks(axis_name=RANKS_AXIS, *, mesh=None) -> int:
    """``lax.axis_size``: the number of ranks on ``axis_name``."""
    return resolve(mesh, axis_name).size


def rank_index(axis_name=RANKS_AXIS, *, mesh=None) -> int:
    """``lax.axis_index``: this rank's index on ``axis_name``."""
    return resolve(mesh, axis_name).index


def _axis(group, axis_name, mesh) -> AxisGroup:
    """The ranks ``allreduce`` and ``allgather`` work over: ``group``
    (a process group) when given, else ``axis_name`` of ``mesh``, else
    the world (one rank without a process group)."""
    if group is None and axis_name is None and mesh is None:
        if not dist.is_initialized():
            return AxisGroup((), 1, 0, (0,), None)
        group = dist.group.WORLD
    if group is not None:
        return AxisGroup((), dist.get_world_size(group), dist.get_rank(group),
                         tuple(dist.get_process_group_ranks(group)), group)
    return resolve(mesh, axis_name if axis_name is not None else RANKS_AXIS)


def allreduce(x: torch.Tensor, *, average: bool = True,
              op: Optional[str] = None, group=None, axis_name=None,
              mesh=None) -> torch.Tensor:
    """Sum (or average/min/max) ``x`` across the ranks of ``group`` (or
    of ``axis_name`` of ``mesh``; the world by default); every rank gets
    the result in a new tensor.  The average is the sum divided by the
    group size, as ``lax.pmean`` computes it: the float mean, also for an
    integer ``x`` (int32 [3, 4] over 2 ranks gives float32 3.5).  A float
    sum is :func:`..parallel.collectives.pvary` of
    :func:`..parallel.collectives.psum`, so its backward (and the
    average's) is the same reduction of the cotangents."""
    if op is None:
        op = AVERAGE if average else SUM
    if op not in _OPS:
        raise ValueError(f"unknown reduction op: {op!r}")
    ax = _axis(group, axis_name, mesh)
    if ax.size == 1:
        out = x.clone()
    elif op in (SUM, AVERAGE) and x.is_floating_point():
        out = _coll.pvary(_coll.psum(x, ax), ax)
    else:
        out = x.clone()
        dist.all_reduce(out, op=_OPS[op], group=ax.group)
    return out / ax.size if op == AVERAGE else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: AxisGroup, axis: int):
        ctx.args = (ax.index, axis, x.shape[axis])
        return _coll._gather(x, ax, axis)

    @staticmethod
    def backward(ctx, ct):
        index, axis, rows = ctx.args
        return ct.narrow(axis, index * rows, rows), None, None


def allgather(x: torch.Tensor, *, axis: int = 0, group=None, axis_name=None,
              mesh=None) -> torch.Tensor:
    """Concatenate ``x`` from all ranks of ``group`` (or of ``axis_name``
    of ``mesh``; the world by default) along ``axis``, in rank order;
    every rank's ``x`` has the same shape.  Without a process group this
    is ``x`` itself.  Backward: this rank's slice of its own cotangent,
    right for a gathered value that every rank uses alike (module
    docstring)."""
    ax = _axis(group, axis_name, mesh)
    if ax.size == 1:
        return x
    return _AllGather.apply(x, ax, axis % max(x.dim(), 1))


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: AxisGroup, root: int):
        ctx.args = (ax, root)
        out = x.contiguous().clone()
        dist.broadcast(out, src=ax.ranks[root], group=ax.group)
        return out

    @staticmethod
    def backward(ctx, ct):
        ax, root = ctx.args
        total = _coll._all_reduce(ct, ax)
        if ax.index != root:
            total.zero_()
        return total, None, None


def broadcast(x: torch.Tensor, root_rank: int, *, axis_name=RANKS_AXIS,
              mesh=None, mode: str = "permute") -> torch.Tensor:
    """Every rank of ``axis_name`` receives the value of ``x`` on the
    rank whose index there is ``root_rank``.

    ``mode="permute"`` (default): a real broadcast (``dist.broadcast``
    over the axis' group, no all-reduce in the forward); its backward is
    the reference's registered gradient, the all-reduce of the cotangent
    kept on the root and zero elsewhere.  ``mode="psum"``: the masked sum
    (:func:`..parallel.collectives.psum` of ``x`` times "this rank is
    the root", marked varying again by
    :func:`..parallel.collectives.pvary`), the same values and
    gradients.  A tuple of axis names always takes the ``"psum"``
    path, as in the JAX package."""
    if mode not in ("permute", "psum"):
        raise ValueError(f"broadcast mode must be 'permute' or 'psum', "
                         f"got {mode!r}")
    ax = resolve(mesh, axis_name)
    if not 0 <= root_rank < ax.size:
        raise ValueError(f"broadcast root_rank {root_rank} is outside an "
                         f"axis of {ax.size} ranks")
    if ax.size == 1:
        return x
    if (mode == "psum" or len(ax.names) > 1
            or isinstance(axis_name, (tuple, list))):
        return _coll.pvary(_coll.psum(x * int(ax.index == root_rank), ax),
                           ax)
    return _Broadcast.apply(x, ax, root_rank)


def reducescatter(x: torch.Tensor, *, average: bool = False,
                  axis_name=RANKS_AXIS, mesh=None,
                  axis: int = 0) -> torch.Tensor:
    """Reduce across the ranks of ``axis_name`` and keep this rank's
    block of dimension ``axis`` (``lax.psum_scatter(tiled=True)``),
    divided by the axis size under ``average``.  Backward: the
    all-gather of the cotangents."""
    ax = resolve(mesh, axis_name)
    out = _coll.psum_scatter(x, ax, axis)
    if average:
        out = out / ax.size
    return out


def alltoall(x: torch.Tensor, *, axis_name=RANKS_AXIS, mesh=None,
             split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
    """All-to-all over ``axis_name`` (``lax.all_to_all(tiled=True)``):
    dimension ``split_axis`` splits into one block per rank, block j goes
    to rank j, and the blocks received are concatenated along
    ``concat_axis`` in rank order.  Backward: the inverse exchange."""
    return _coll.all_to_all(x, resolve(mesh, axis_name), split_axis,
                            concat_axis)


def staged_bucket_allreduce(leaves, reduce_flat, *, bucket_bytes=None,
                            overlap: bool = False):
    """Bucketed, staged collective over a list of tensors.

    Leaves are packed into byte-bounded buckets by
    :func:`horovod_tpu_torch.scheduler.pack_buckets` and ``reduce_flat``
    runs once per bucket on the concatenated flat payload, in the
    scheduler's issue order (reversed registration order under
    ``overlap``).  Bucket contents do not depend on the issue order, so
    overlap changes scheduling, never results.  Returns the reduced
    payload re-split per leaf (flat; the caller reshapes).
    """
    from horovod_tpu_torch import scheduler as _sched
    if bucket_bytes is None:
        bucket_bytes = _sched.bucket_bytes_from_env()
    sizes = [l.numel() * l.element_size() for l in leaves]
    dtypes = [str(l.dtype) for l in leaves]
    buckets = _sched.pack_buckets(sizes, dtypes, bucket_bytes)
    out = [None] * len(leaves)
    for b in _sched.issue_order(len(buckets), overlap):
        idxs = buckets[b]
        flat = (leaves[idxs[0]].reshape(-1) if len(idxs) == 1
                else torch.cat([leaves[i].reshape(-1) for i in idxs]))
        red = reduce_flat(flat)
        offset = 0
        for i in idxs:
            n = leaves[i].numel()
            out[i] = red[offset:offset + n]
            offset += n
    return out
