"""Data-parallel training step.

Port of ``horovod_tpu/jax/spmd.py``: ``reduce_gradients`` (:42, the flat
path :113-146) and ``make_train_step`` (:535; its single-process path
:686-737 and its data-parallel path :632-649).  The JAX package compiles
forward, backward, gradient average and optimizer update into one XLA
program over a mesh; here the step runs them eagerly, one process per GPU:
``loss.backward()``, then -- when the world group has more than one rank --
a bucketed average of the gradients over ``torch.distributed``, then
``optimizer.step()``.

On the flat mesh the JAX package binds one ``pmean`` per leaf and leaves the
batching to XLA's all-reduce combiner.  NCCL has no such combiner, so
``fuse=True`` (the default) packs each wire dtype's gradients into the
scheduler's byte-bounded buckets and reduces one bucket at a time
(:func:`..ops.injit.staged_bucket_allreduce`); ``fuse=False`` reduces leaf
by leaf.

``compression`` takes the Compressor classes or the wire names
(``"none"``, ``"bf16"``, ``"fp16"``, ``"int8"``), and
``HOROVOD_TPU_INJIT_WIRE_DTYPE`` fills it in where the caller left the
default.  Under int8, eligible leaves (:func:`..ops.quantized_collectives
.int8_eligible`) are flattened to f32, packed into the scheduler's buckets
and each bucket rides one int8 ring (``_reduce_flat_int8``, the port of
``jax/spmd.py:204-241``); the other leaves take the raw path.
``steps_per_call``, the ``"auto"`` wire and the hierarchical mesh are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch import scheduler as _sched
from horovod_tpu_torch.compression import Compressor, NoneCompressor
from horovod_tpu_torch.ops import injit as _injit
from horovod_tpu_torch.ops import quantized_collectives as _qc


def _check_compression(compression):
    """The Compressor that ``compression`` names (class, wire name or the
    env fill-in); ``"auto"`` and anything else raise
    ``NotImplementedError``."""
    compression = _qc.resolve_injit_compression(compression)
    if not (isinstance(compression, type)
            and issubclass(compression, Compressor)):
        raise NotImplementedError(
            f"compression={compression!r}: only the Compressor classes and "
            f"their wire names (none, fp16, bf16, int8) are ported")
    return compression


def reduce_gradients(grads: List[torch.Tensor], *, average: bool = True,
                     compression=NoneCompressor, fuse: bool = True,
                     bucket_bytes: Optional[int] = None,
                     overlap: Optional[bool] = None,
                     group=None) -> List[torch.Tensor]:
    """Average (or sum) a list of per-rank gradients over ``group`` (the
    world group by default), casting to the wire dtype of
    ``compression`` around the collective.  ``bucket_bytes`` defaults to
    ``HOROVOD_TPU_BUCKET_BYTES`` and ``overlap`` to ``HOROVOD_TPU_OVERLAP``
    (reverse issue order); overlap on and off give identical results."""
    compression = _check_compression(compression)
    bucket_bytes = _sched.bucket_bytes_from_env(bucket_bytes)
    overlap = _sched.overlap_enabled(overlap)
    if _qc.is_int8(compression):
        return _reduce_flat_int8(grads, average=average, fuse=fuse,
                                 bucket_bytes=bucket_bytes, overlap=overlap,
                                 group=group)

    def reduce_flat(flat):
        return _injit.allreduce(flat, average=average, group=group)

    compressed = [compression.compress(g) for g in grads]
    if not fuse:
        return [compression.decompress(reduce_flat(c), ctx)
                for c, ctx in compressed]
    groups: dict = {}
    for i, (c, _) in enumerate(compressed):
        groups.setdefault(c.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx_list in groups.values():
        reduced = _injit.staged_bucket_allreduce(
            [compressed[i][0] for i in idx_list], reduce_flat,
            bucket_bytes=bucket_bytes, overlap=overlap)
        for i, r in zip(idx_list, reduced):
            c, ctx = compressed[i]
            out[i] = compression.decompress(r.view(c.shape), ctx)
    return out


def _reduce_flat_int8(grads, *, average: bool, fuse: bool,
                      bucket_bytes: int, overlap: bool, group):
    """Eligible leaves as f32 in the scheduler's buckets (every leaf alone
    without ``fuse``), one int8 ring per bucket in issue order; the other
    leaves on the raw path, uncompressed (the under-floor policy,
    ``leaf_comp`` at ``jax/spmd.py:93-99``)."""
    ring_idx = [i for i, g in enumerate(grads)
                if _qc.int8_eligible(g.shape, g.dtype)]
    rest_idx = [i for i in range(len(grads)) if i not in set(ring_idx)]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    if rest_idx:
        red = reduce_gradients([grads[i] for i in rest_idx],
                               average=average, compression="none",
                               fuse=fuse,
                               bucket_bytes=bucket_bytes, overlap=overlap,
                               group=group)
        for i, r in zip(rest_idx, red):
            out[i] = r
    if ring_idx:
        reduced = _injit.staged_bucket_allreduce(
            [grads[i].reshape(-1).to(torch.float32) for i in ring_idx],
            lambda flat: _qc.quantized_ring_allreduce(
                flat, average=average, group=group),
            bucket_bytes=bucket_bytes if fuse else 0, overlap=overlap)
        for i, r in zip(ring_idx, reduced):
            g = grads[i]
            out[i] = r.reshape(g.shape).to(g.dtype)
    return out


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, object],
                                      torch.Tensor],
                    optimizer: torch.optim.Optimizer, *,
                    average: bool = True, compression=NoneCompressor,
                    fuse: bool = True, overlap: Optional[bool] = None):
    """Build ``step(batch) -> loss`` for data-parallel training.

    ``loss_fn(model, batch)`` returns the scalar loss of this rank's
    ``batch``.  The step zeroes the gradients, runs forward and backward,
    averages the gradients of every trainable parameter across the world
    group with :func:`reduce_gradients` when it has more than one rank
    (a parameter without a gradient contributes zeros), applies
    ``optimizer.step()`` and returns the loss averaged over the ranks,
    detached.  ``optax.sgd(lr, momentum=m)`` corresponds to
    ``torch.optim.SGD(params, lr, momentum=m)`` (dampening 0, no Nesterov):
    both compute ``trace = g + m * trace; p -= lr * trace``."""
    compression = _check_compression(compression)
    overlap = _sched.overlap_enabled(overlap)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        loss = loss.detach()
        if dist.is_initialized() and dist.get_world_size() > 1:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            reduced = reduce_gradients(grads, average=average,
                                       compression=compression, fuse=fuse,
                                       overlap=overlap)
            for p, g in zip(params, reduced):
                p.grad = g
            loss = _injit.allreduce(loss, average=True)
        optimizer.step()
        return loss

    return step
