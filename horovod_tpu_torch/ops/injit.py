"""Collectives of the train step over ``torch.distributed``.

Port of ``horovod_tpu/ops/injit.py``: ``allreduce`` (:58), ``allgather``
(:78) and ``staged_bucket_allreduce`` (:181).  In the JAX package these are ops
inside one XLA program over the mesh axis; here they are NCCL (or gloo)
collectives over a process group, the world group by default.  The bucket
plan and issue order come from the same :mod:`..scheduler` rules.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

SUM = "sum"
AVERAGE = "average"
MIN = "min"
MAX = "max"

_OPS = {SUM: dist.ReduceOp.SUM, AVERAGE: dist.ReduceOp.SUM,
        MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX}


def allreduce(x: torch.Tensor, *, average: bool = True,
              op: Optional[str] = None, group=None) -> torch.Tensor:
    """Sum (or average/min/max) ``x`` across the ranks of ``group``; every
    rank gets the result in a new tensor.  The average is the sum divided
    by the group size, as ``lax.pmean`` computes it: the float mean, also
    for an integer ``x`` (int32 [3, 4] over 2 ranks gives float32 3.5)."""
    if op is None:
        op = AVERAGE if average else SUM
    if op not in _OPS:
        raise ValueError(f"unknown reduction op: {op!r}")
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    if op == AVERAGE:
        n = dist.get_world_size(group)
        if not out.is_floating_point():
            return out / n
        out.div_(n)
    return out


def allgather(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Concatenate ``x`` from all ranks of ``group`` along its first
    dimension, in rank order; every rank's ``x`` has the same shape.
    Without a process group this is ``x`` itself."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


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
