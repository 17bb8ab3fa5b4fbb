"""Process-group layouts: the two-tier grid of the hierarchical reduction
and the general named mesh of the model-parallel modules.

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

:func:`build_mesh` (:64) lays the ranks out row-major on a named grid
(``"dp"``, ``"sp"``, ``"tp"``, ``"pp"``, ``"ep"``, ...) and gives each
axis, and each tuple of axes, this rank's subgroup, size and index: the
counterparts of a bound ``shard_map`` axis, ``lax.axis_size`` and
``lax.axis_index``.  The collectives over those groups are
:mod:`.collectives`.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
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


# ------------------------------------------------------------ general mesh


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis, or a tuple of axes, as this rank sees it: the
    counterpart of a bound ``shard_map`` axis name.

    * ``names`` -- the axes, in the mesh's order;
    * ``size``/``index`` -- ``lax.axis_size`` and ``lax.axis_index``;
    * ``ranks`` -- the world ranks of this rank's subgroup, in axis
      order (position ``i`` holds the rank whose index is ``i``);
    * ``group`` -- its ``torch.distributed`` process group, ``None``
      when ``size`` is 1: every collective over it is then the identity.
    """

    names: Tuple[str, ...]
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a named grid of ranks (``build_mesh``).

    ``shape`` and ``axis_names`` as in JAX's ``Mesh``; ``coords`` is this
    rank's position on the grid; :meth:`axis` gives the subgroup of an
    axis or of a tuple of axes."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...]
    axes: Dict[Tuple[str, ...], AxisGroup]

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    def axis(self, name) -> AxisGroup:
        """The :class:`AxisGroup` of ``name`` (one axis name, or a tuple
        of them in any order); an axis the mesh lacks raises ``NameError``
        with JAX's text."""
        names = (name,) if isinstance(name, str) else tuple(name)
        for n in names:
            if n not in self.axis_names:
                raise NameError(f"unbound axis name: {n}")
        key = tuple(n for n in self.axis_names if n in names)
        return self.axes[key]

    def axis_size(self, name) -> int:
        return self.axis(name).size

    def axis_index(self, name) -> int:
        return self.axis(name).index


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(topology: _topology.Topology, shape: Sequence[int],
               axis_names: Sequence[str]) -> Mesh:
    """Lay the world's ranks out row-major on a grid of ``shape`` (port of
    ``horovod_tpu/parallel/mesh.py:64``: the LAST axis varies fastest, so
    it spans consecutive ranks -- put the heaviest-communication axis
    (tp/sp) last) and create a process group for every axis and every
    tuple of axes.  Every rank must call this, with the same arguments
    and in the same order relative to its other collectives: each group
    is created with ``dist.new_group`` by every rank (NCCL hangs
    otherwise).  The tuple of all axes uses the world group.  A one-rank
    world needs no process group."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "differ in length")
    if math.prod(shape) != topology.size:
        raise ValueError(
            f"mesh shape {shape} does not cover {topology.size} chips")
    world, rank = _world()
    if world != topology.size:
        raise ValueError(f"the topology has {topology.size} ranks but the "
                         f"process group {world}")
    coords = _unravel(rank, shape)
    axes: Dict[Tuple[str, ...], AxisGroup] = {}
    dims = range(len(shape))
    for r in range(1, len(shape) + 1):
        for subset in itertools.combinations(dims, r):
            names = tuple(axis_names[d] for d in subset)
            size = math.prod(shape[d] for d in subset)
            sub_shape = tuple(shape[d] for d in subset)
            index = _ravel(tuple(coords[d] for d in subset), sub_shape)
            ranks = tuple(_members(coords, shape, subset))
            if size == 1:
                group = None
            elif len(subset) == len(shape):
                group = dist.group.WORLD
            else:
                group = None
                rest = [d for d in dims if d not in subset]
                for other in itertools.product(
                        *(range(shape[d]) for d in rest)):
                    fixed = list(coords)
                    for d, c in zip(rest, other):
                        fixed[d] = c
                    g = dist.new_group(list(_members(fixed, shape, subset)))
                    if tuple(fixed) == coords:
                        group = g
            axes[names] = AxisGroup(names, size, index, ranks, group)
    return Mesh(shape, axis_names, coords, axes)


def ranks_mesh() -> Mesh:
    """The 1-D ``('ranks',)`` mesh over the whole world (the world group:
    no group is created, so it can be built at any time and by one rank
    alone).  The default mesh of the parallel modules."""
    world, rank = _world()
    ranks = tuple(range(world))
    group = dist.group.WORLD if world > 1 else None
    return Mesh((world,), (RANKS_AXIS,), (rank,),
                {(RANKS_AXIS,): AxisGroup((RANKS_AXIS,), world, rank, ranks,
                                          group)})


def resolve(mesh: Optional[Mesh], name) -> AxisGroup:
    """``mesh.axis(name)``, with :func:`ranks_mesh` when ``mesh`` is
    ``None``; an :class:`AxisGroup` is returned as it is."""
    if isinstance(name, AxisGroup):
        return name
    return (mesh if mesh is not None else ranks_mesh()).axis(name)


def fold_in(seed: int, index: int) -> int:
    """A seed for shard ``index`` of ``seed`` (the counterpart of
    ``jax.random.fold_in(key, lax.axis_index(axis))``): distinct shards
    draw distinct parameters."""
    return (int(seed) * 0x9E3779B1 + 0x7F4A7C15 * (int(index) + 1)) % (1 << 62)


def shard_generator(device, seed: int, ax: AxisGroup) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`fold_in` of ``seed``
    and this rank's index on ``ax``: the draws of a parameter that is
    sharded over ``ax`` (the JAX package's ``per_shard_init``)."""
    return torch.Generator(device=device).manual_seed(fold_in(seed,
                                                              ax.index))


def _unravel(i: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    i = 0
    for c, s in zip(coords, shape):
        i = i * s + c
    return i


def _members(coords, shape, subset):
    """World ranks of the grid points that share ``coords`` off the axes
    of ``subset``, in row-major order over ``subset`` (which is also
    ascending rank order)."""
    for sub in itertools.product(*(range(shape[d]) for d in subset)):
        c = list(coords)
        for d, v in zip(subset, sub):
            c[d] = v
        yield _ravel(c, shape)
