"""The two-tier process-group layout of the hierarchical reduction.

Port of ``horovod_tpu/parallel/mesh.py``.  The JAX package lays its chips
out as a ``('dcn', 'ici')`` mesh; the port has one process per GPU and no
mesh object, so the same layout is a pair of ``torch.distributed``
subgroups per rank, standing in for the reference's node-local and
cross-node communicators (``operations.cc:1487-1532``):

* ``ici``: the ranks of one host (NVLink, like NCCL intra-node);
* ``dcn``: the ranks at the same position of every host (the network).

Hosts are the ranks' :func:`..topology.host_fingerprint` values, gathered
over the world group; they are ordered by leader (the lowest rank of each
host, :func:`..topology.derive_host_groups`), and each host's ranks
ascend.  ``ici_size`` forces a fixed width instead: consecutive ranks in
blocks of that many.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

from horovod_tpu_torch import topology as _topology

RANKS_AXIS = "ranks"
ICI_AXIS = "ici"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True)
class HierarchicalMesh:
    """This rank's view of the ``(dcn, ici)`` grid.

    * ``grid``     -- the world ranks, one tuple per host (dcn-major);
    * ``ici_group``/``dcn_group`` -- the subgroups this rank belongs to
      (``None`` when the world is one rank and has no process group);
    * ``ici_size``/``dcn_size``   -- their sizes;
    * ``ici_rank``/``dcn_rank``   -- this rank's index in each.
    """

    grid: Tuple[Tuple[int, ...], ...]
    ici_group: Optional[object]
    dcn_group: Optional[object]
    ici_size: int
    dcn_size: int
    ici_rank: int
    dcn_rank: int

    @property
    def size(self) -> int:
        return self.ici_size * self.dcn_size


def _host_grid(fingerprints, ici_size: Optional[int]):
    """Equal-length rank lists, one per ici group; an uneven partition
    raises the reference's texts (``horovod_tpu/topology.py:262-266,
    283-288``)."""
    n = len(fingerprints)
    if ici_size is not None:
        if n % ici_size != 0:
            raise ValueError(
                f"total ranks {n} not divisible by ici group size "
                f"{ici_size}; hierarchical collectives need a homogeneous "
                "topology (reference operations.cc:1511-1525 makes the "
                "same check)")
        return [list(range(i, i + ici_size)) for i in range(0, n, ici_size)]
    groups, leaders = _topology.derive_host_groups(fingerprints)
    sizes = {len(g) for g in groups.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"device host groups are uneven "
            f"({sorted((v, len(g)) for v, g in groups.items())}); "
            "hierarchical collectives need a homogeneous topology "
            "(reference operations.cc:1511-1525 makes the same check)")
    by_leader = {g[0]: g for g in groups.values()}
    return [by_leader[lead] for lead in leaders]


def build_hierarchical_mesh(topology: _topology.Topology,
                            ici_size: Optional[int] = None
                            ) -> HierarchicalMesh:
    """Gather every rank's host fingerprint over the world group, split
    the ranks into hosts and create the subgroups.  Every rank must call
    this, in the same order relative to its other collectives: PyTorch
    requires every rank to create every subgroup, in one order."""
    if topology.size == 1:
        return HierarchicalMesh(grid=((0,),), ici_group=None,
                                dcn_group=None, ici_size=1, dcn_size=1,
                                ici_rank=0, dcn_rank=0)
    fps = [None] * topology.size
    dist.all_gather_object(fps, _topology.host_fingerprint())
    grid = _host_grid(fps, ici_size)
    width = len(grid[0])
    ici_group = dcn_group = None
    ici_rank = dcn_rank = -1
    for d, ranks in enumerate(grid):
        g = dist.new_group(ranks)
        if topology.rank in ranks:
            ici_group, dcn_rank = g, d
            ici_rank = ranks.index(topology.rank)
    for i in range(width):
        g = dist.new_group([ranks[i] for ranks in grid])
        if i == ici_rank:
            dcn_group = g
    return HierarchicalMesh(grid=tuple(tuple(r) for r in grid),
                            ici_group=ici_group, dcn_group=dcn_group,
                            ici_size=width, dcn_size=len(grid),
                            ici_rank=ici_rank, dcn_rank=dcn_rank)
