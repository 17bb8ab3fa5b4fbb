"""Sparse gradients: the reference's IndexedSlices route.

Port of ``horovod_tpu/sparse.py:32-94``.  A sparse gradient is reduced by
**allgathering** its rows and their indices instead of densifying
(Horovod's ``horovod/tensorflow/__init__.py:67-78``): an embedding
gradient touches few rows, so gathering them costs ``nnz x size`` rows
instead of a dense ``dim0`` allreduce.

:class:`IndexedSlices` is built from a PyTorch sparse COO gradient with
one sparse dimension -- what ``nn.Embedding(sparse=True)`` produces:
values ``(nnz, *row)``, indices ``(nnz,)``, ``dense_shape``.  Indices
may repeat; the consumer sums duplicates (:meth:`IndexedSlices.to_dense`,
:func:`apply_indexed_slices`), as TF's IndexedSlices contract says.

Two routes, as in the reference: :func:`allreduce` is the SPMD branch's
all-gather over a ``torch.distributed`` group, which needs the same row
count on every rank (the reference's tiled ``lax.all_gather`` has static
shapes); :func:`allreduce_eager` is the negotiated allgather of the eager
plane, which takes ragged row counts (``MPI_Allgatherv`` parity).
``average=True`` divides the values by the number of ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class IndexedSlices:
    """A sparse slice set: ``dense[indices[i]] += values[i]`` (mirrors
    ``tf.IndexedSlices``)."""
    values: torch.Tensor          # (nnz, *row_shape)
    indices: torch.Tensor         # (nnz,) int64 rows into dim 0
    dense_shape: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_sparse(cls, grad: torch.Tensor) -> "IndexedSlices":
        """The slices of a sparse COO tensor with one sparse dimension
        (coalesced or not: duplicates stay)."""
        if grad.layout != torch.sparse_coo or grad.sparse_dim() != 1:
            raise ValueError(
                f"IndexedSlices.from_sparse needs a sparse COO tensor with "
                f"one sparse dimension, got layout {grad.layout} with "
                f"shape {tuple(grad.shape)}")
        return cls(grad._values(), grad._indices()[0], tuple(grad.shape))

    def to_sparse(self) -> torch.Tensor:
        """The uncoalesced sparse COO tensor of these slices."""
        return torch.sparse_coo_tensor(self.indices[None], self.values,
                                       self.dense_shape,
                                       check_invariants=False)

    def to_dense(self) -> torch.Tensor:
        if self.dense_shape is None:
            raise ValueError("dense_shape required to densify")
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.indices, self.values)


def allreduce(slices: IndexedSlices, *, average: bool = True,
              group=None) -> IndexedSlices:
    """SPMD sparse allreduce: all-gather rows and indices over ``group``
    (the world group by default), in rank order.  Every rank must hold the
    same number of rows; otherwise every rank raises ``ValueError``."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    values, indices = slices.values, slices.indices
    if world > 1:
        count = torch.tensor([values.shape[0]], dtype=torch.int64,
                             device=values.device)
        counts = [torch.empty_like(count) for _ in range(world)]
        dist.all_gather(counts, count, group=group)
        counts = [int(c.item()) for c in counts]
        if len(set(counts)) > 1:
            raise ValueError(
                f"sparse allreduce on the SPMD branch needs the same number "
                f"of rows on every rank (a tiled all-gather), got {counts}; "
                f"use allreduce_eager (the negotiated allgather) for ragged "
                f"row counts")
        parts = [torch.empty_like(values) for _ in range(world)]
        dist.all_gather(parts, values.contiguous(), group=group)
        idx = [torch.empty_like(indices) for _ in range(world)]
        dist.all_gather(idx, indices.contiguous(), group=group)
        values, indices = torch.cat(parts), torch.cat(idx)
    if average:
        values = values / world
    return IndexedSlices(values, indices, slices.dense_shape)


def allreduce_eager(slices: IndexedSlices, *, average: bool = True,
                    name: Optional[str] = None) -> IndexedSlices:
    """Eager sparse allreduce through the negotiated allgather of values
    and indices; row counts may differ across ranks."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import eager

    nm = name or eager._auto_name("sparse.allreduce")
    vh = eager.allgather_async(slices.values, name=f"{nm}.values")
    ih = eager.allgather_async(slices.indices, name=f"{nm}.indices")
    values = eager.synchronize(vh)
    indices = eager.synchronize(ih)
    if average:
        values = values / basics.size()
    return IndexedSlices(values, indices, slices.dense_shape)


def apply_indexed_slices(dense: torch.Tensor, slices: IndexedSlices, *,
                         scale=1.0) -> torch.Tensor:
    """``dense[indices] += scale * values`` with duplicate indices summed,
    as a new tensor -- the consumer side of a gathered sparse gradient."""
    scale = torch.tensor(scale, dtype=dense.dtype, device=dense.device)
    return dense.index_add(0, slices.indices,
                           scale * slices.values.to(dense.dtype))
