"""Data-parallel training step.

Port of ``horovod_tpu/jax/spmd.py``: ``reduce_gradients`` (:42),
``make_train_step`` (:535), ``make_eval_step`` (:785) and ``shard_batch``
(:802) with ``batch_spec``'s layouts (:544).  The JAX package compiles
forward, backward, gradient average and optimizer update into one XLA
program over a mesh; here the step runs them
eagerly, one process per GPU: ``loss.backward()``, then -- when the world
group has more than one rank -- a bucketed average of the gradients over
``torch.distributed``, then ``optimizer.step()``, then the sync of the
model's buffers (BatchNorm statistics).

On the flat mesh the JAX package binds one ``pmean`` per leaf and leaves the
batching to XLA's all-reduce combiner.  NCCL has no such combiner, so
``fuse=True`` (the default) packs each wire dtype's gradients into the
scheduler's byte-bounded buckets and reduces one bucket at a time
(:func:`..ops.injit.staged_bucket_allreduce`); ``fuse=False`` reduces leaf
by leaf.  Handed a :class:`..parallel.mesh.HierarchicalMesh` (``mesh=``),
the buckets (or leaves) take the two-tier
:func:`..parallel.hierarchical.hierarchical_allreduce` instead (:86-133).

``compression`` takes the Compressor classes or the wire names
(``"none"``, ``"bf16"``, ``"fp16"``, ``"int8"``), and
``HOROVOD_TPU_INJIT_WIRE_DTYPE`` fills it in where the caller left the
default.  Under int8 on the flat path, eligible leaves
(:func:`..ops.quantized_collectives.int8_eligible`) are flattened to f32,
packed into the scheduler's buckets and each bucket rides one int8 ring
(``_reduce_flat_int8``, the port of ``jax/spmd.py:204-241``); the other
leaves take the raw path.  On the two-tier path eligible leaves are
snapped onto the int8 grid around the reduce (``Int8Compressor``), as in
the JAX package.  The ``"auto"`` wire is not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from horovod_tpu_torch import basics as _basics
from horovod_tpu_torch import scheduler as _sched
from horovod_tpu_torch.compression import Compressor, NoneCompressor
from horovod_tpu_torch.ops import injit as _injit
from horovod_tpu_torch.ops import quantized_collectives as _qc
from horovod_tpu_torch.parallel.hierarchical import hierarchical_allreduce
from horovod_tpu_torch.parallel.mesh import ranks_mesh as _ranks_mesh


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
                     group=None, mesh=None) -> List[torch.Tensor]:
    """Average (or sum) a list of per-rank gradients over ``group`` (the
    world group by default), casting to the wire dtype of
    ``compression`` around the collective.  With ``mesh`` (a
    :class:`..parallel.mesh.HierarchicalMesh`) every rank of the mesh
    reduces through the two-tier path and ``group`` is not used.
    ``bucket_bytes`` defaults to ``HOROVOD_TPU_BUCKET_BYTES`` and
    ``overlap`` to ``HOROVOD_TPU_OVERLAP`` (reverse issue order); overlap
    on and off give identical results."""
    compression = _check_compression(compression)
    bucket_bytes = _sched.bucket_bytes_from_env(bucket_bytes)
    overlap = _sched.overlap_enabled(overlap)
    if mesh is None and _qc.is_int8(compression):
        return _reduce_flat_int8(grads, average=average, fuse=fuse,
                                 bucket_bytes=bucket_bytes, overlap=overlap,
                                 group=group)

    def reduce_flat(flat):
        if mesh is not None:
            return hierarchical_allreduce(flat, average=average, mesh=mesh)
        return _injit.allreduce(flat, average=average, group=group)

    def leaf_comp(g):
        # Under int8 (two-tier path only) leaves below the floor skip the
        # lossy snap and stay raw; decompress passes them through.
        if _qc.is_int8(compression) and not _qc.int8_eligible(g.shape,
                                                               g.dtype):
            return NoneCompressor
        return compression

    compressed = [leaf_comp(g).compress(g) for g in grads]
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


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _sync_buffers(model: torch.nn.Module) -> None:
    """Make the model's buffers equal on every rank, in place: floating
    buffers (running statistics, which each rank computed from its own
    micro-batch) are averaged, the others (counters) take the max.  One
    bucketed collective per kind (``jax/spmd.py:740-770``); the identity
    without a world group of more than one rank."""
    if not _distributed():
        return
    for floating in (True, False):
        bufs = [b for b in model.buffers()
                if b.is_floating_point() == floating]
        if not bufs:
            continue
        op = _injit.AVERAGE if floating else _injit.MAX
        reduced = _injit.staged_bucket_allreduce(
            bufs, lambda flat: _injit.allreduce(flat, op=op))
        with torch.no_grad():
            for b, r in zip(bufs, reduced):
                b.copy_(r.view(b.shape))


def _snapshot_buffers(model: torch.nn.Module) -> dict:
    """``sync_aux_state=False``: each buffer's identity, version and a copy
    of its value before the forward, for :func:`_check_buffers_unchanged`."""
    return {n: (id(b), b._version, b.detach().clone())
            for n, b in model.named_buffers()}


def _check_buffers_unchanged(model: torch.nn.Module, before: dict) -> None:
    """``sync_aux_state=False``: a buffer the forward wrote would differ
    across ranks.  Put every buffer back to its value before the forward
    and raise the reference's error (``jax/spmd.py:774-779``), naming the
    first written buffer by its ``state_dict`` name.  Any write counts,
    on one rank too: the reference raises for every aux leaf the forward
    computes from the micro-batch, which an eager step cannot tell from
    other writes."""
    written = [name for name, b in model.named_buffers()
               if before.get(name, (None, None))[:2] != (id(b), b._version)]
    if not written:
        return
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name in before:
                b.copy_(before[name][2])
    raise ValueError(
        f"make_train_step(sync_aux_state=False): aux state leaf "
        f"'{written[0]}' varies across mesh shards (each "
        "shard computed a different value from its micro-batch). "
        "Pass sync_aux_state=True to average it across ranks, or "
        "reduce it inside loss_fn.")


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, object],
                                      torch.Tensor],
                    optimizer: torch.optim.Optimizer, *,
                    average: bool = True, compression=NoneCompressor,
                    sync_aux_state: bool = True, steps_per_call: int = 1,
                    fuse: bool = True, overlap: Optional[bool] = None,
                    mesh=None):
    """Build ``step(batch) -> loss`` for data-parallel training.

    ``loss_fn(model, batch)`` returns the scalar loss of this rank's
    ``batch``.  The step zeroes the gradients, runs forward and backward,
    averages the gradients of every trainable parameter across the world
    group with :func:`reduce_gradients` when it has more than one rank
    (a parameter without a gradient contributes zeros; over the two-tier
    path when ``mesh`` is given), applies ``optimizer.step()`` and returns
    the loss averaged over the ranks, detached.  ``optax.sgd(lr,
    momentum=m)`` corresponds to ``torch.optim.SGD(params, lr,
    momentum=m)`` (dampening 0, no Nesterov): both compute ``trace = g + m
    * trace; p -= lr * trace``.

    The model's buffers are its aux state.  ``sync_aux_state=True``
    averages the floating ones across the ranks after the update
    (``_sync_buffers``); ``False`` requires that the forward writes
    none (a model in eval mode): otherwise the step puts the buffers back
    and raises ``ValueError`` before the backward and the update, on one
    rank too, so nothing moves.

    ``steps_per_call > 1`` runs that many steps per call: every batch
    leaf gains a leading ``steps_per_call`` axis, the steps take those
    batches in turn and the call returns the mean of their losses."""
    compression = _check_compression(compression)
    overlap = _sched.overlap_enabled(overlap)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got "
                         f"{steps_per_call}")
    params = [p for p in model.parameters() if p.requires_grad]

    def one_step(batch):
        optimizer.zero_grad(set_to_none=True)
        before = None if sync_aux_state else _snapshot_buffers(model)
        loss = loss_fn(model, batch)
        if before is not None:
            _check_buffers_unchanged(model, before)
        loss.backward()
        loss = loss.detach()
        distributed = _distributed()
        if distributed:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            reduced = reduce_gradients(grads, average=average,
                                       compression=compression, fuse=fuse,
                                       overlap=overlap, mesh=mesh)
            for p, g in zip(params, reduced):
                p.grad = g
            loss = _injit.allreduce(loss, average=True)
        optimizer.step()
        if sync_aux_state:
            _sync_buffers(model)
        return loss

    if steps_per_call == 1:
        return one_step

    def leading(i):
        def pick(x):
            if x.shape[:1] != (steps_per_call,):
                raise ValueError(
                    f"steps_per_call={steps_per_call}: every batch leaf "
                    f"needs a leading axis of that length, got shape "
                    f"{tuple(x.shape)}")
            return x[i]
        return pick

    def step(batch):
        losses = [one_step(tree_map(leading(i), batch))
                  for i in range(steps_per_call)]
        return torch.stack(losses).mean()

    return step


def make_eval_step(model: torch.nn.Module,
                   apply_fn: Callable[[torch.nn.Module, object], object]):
    """Build ``step(batch) -> metrics``: ``apply_fn(model, batch)`` with
    the model in eval mode (BatchNorm on its running statistics) and no
    autograd, its metrics (a tensor or a tuple, list or dict of them)
    averaged across the ranks.  The model's mode is restored after."""

    def step(batch):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                metrics = apply_fn(model, batch)
        finally:
            model.train(was_training)
        if _distributed():
            metrics = tree_map(
                lambda m: _injit.allreduce(m, average=True), metrics)
        return metrics

    return step


def shard_batch(batch, spec=None, *, mesh=None):
    """This rank's block of a global batch, on this rank's device (the
    one ``hvd.init`` chose: ``cuda:local_rank``, or the CPU).

    Contract (as the reference's): ``batch`` is the GLOBAL batch,
    identical on every rank.  Without ``spec`` every leaf's leading
    dimension splits into one contiguous block per rank, in rank order.
    ``spec`` is the counterpart of ``make_train_step``'s ``batch_spec``
    (``jax/spmd.py:544,651-653``): one entry per leading dimension of
    every leaf, each ``None`` (not split), an axis name of ``mesh`` or a
    tuple of names, e.g. ``(None, "sp")`` or ``("dp", "sp")``; dimension
    i splits into that axis' size blocks and this rank keeps the block at
    its index."""
    device = _basics._require_init().device
    if spec is None:
        spec, mesh = ("ranks",), None
    m = mesh if mesh is not None else _ranks_mesh()
    axes = [None if entry is None else m.axis(entry) for entry in spec]

    def one(x):
        for dim, ax in enumerate(axes):
            if ax is None:
                continue
            if x.shape[dim] % ax.size:
                raise ValueError(
                    f"shard_batch: dimension {dim} of {tuple(x.shape)} "
                    f"does not split over {ax.size} ranks")
            n = x.shape[dim] // ax.size
            x = x.narrow(dim, ax.index * n, n)
        return x.to(device)

    return tree_map(one, batch)
