"""Hierarchical (two-tier) allreduce over a :class:`.mesh.HierarchicalMesh`.

Port of ``horovod_tpu/parallel/hierarchical.py:53``, itself the
reference's hierarchical allreduce (``operations.cc:1025-1177``): a
reduce-scatter within each host, an allreduce of each rank's shard across
hosts, an allgather within each host, so the network carries only
``1/ici_size`` of the bytes.  The tensor is flattened and zero-padded to a
multiple of the ici size, and cut back after the gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def hierarchical_allreduce(x: torch.Tensor, *, average: bool = False,
                           mesh) -> torch.Tensor:
    """Sum (or average) ``x`` over every rank of ``mesh``, in a new
    tensor of ``x``'s shape: equal, up to the order of the float sums, to
    a flat allreduce over the world group."""
    if mesh.size == 1:
        return x.clone()
    n_ici = mesh.ici_size
    flat = x.reshape(-1)
    size = flat.numel()
    padded = -(-size // n_ici) * n_ici
    if padded != size:
        flat = F.pad(flat, (0, padded - size))
    flat = flat.contiguous()
    shard = torch.empty(padded // n_ici, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(shard, flat, op=dist.ReduceOp.SUM,
                               group=mesh.ici_group)
    dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=mesh.dcn_group)
    full = torch.empty(padded, dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(full, shard, group=mesh.ici_group)
    out = full[:size].view(x.shape)
    if average:
        out = out / mesh.size
    return out
