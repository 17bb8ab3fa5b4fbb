"""Multi-tenant process sets: named communicators with their own
negotiation namespace.

Port of ``horovod_tpu/process_set.py`` (Horovod's process-set API,
``horovod/common/process_set.{h,cc}``): training, eval and auxiliary jobs
share one pod without stepping on each other's collectives.

* :class:`ProcessSet` -- one named communicator over a subset of global
  ranks, with a per-set membership generation (per-set elastic: losing a
  rank reconfigures that set, never the pod).
* :class:`ProcessSetRegistry` -- the behaviour-identical Python mirror of
  the native registry (``cpp/htpu/process_set.{h,cc}``, reachable via
  :class:`horovod_tpu_torch.cpp_core.CppProcessSetTable`): each set owns a
  MessageTable sized to the set and indexed by SET-LOCAL rank, plus its
  own response-cache slots, so two disjoint sets negotiate concurrently
  with zero cross-talk.
* Module-level API (re-exported from ``horovod_tpu_torch``):
  :func:`add_process_set`, :func:`remove_process_set`,
  :func:`process_set_by_name`, :func:`reconfigure_process_set`, plus the
  ``HOROVOD_TPU_PROCESS_SETS`` startup spec (``name:0,1;name2:2,3`` --
  the grammar the native coordinator parses in ``control.cc Create``).

Set ids start at 1 and are assigned in registration order; id 0 is the
implicit default/world set owned by the controller itself.  Jobs of
several processes register sets through ``HOROVOD_TPU_PROCESS_SETS``
(every process and the native coordinator parse the same spec, so ids
agree by construction); :func:`add_process_set` after init works in a job
of one process only.

**The data plane.**  The reference reduces the members' contributions in
one process, so a set must not span processes.  The port runs one process
per GPU, so its rule is one HOST: every member rank of a set must sit on
the host the controller's host discovery assigns it, and the set's
collectives run over a ``torch.distributed`` group of its member
processes -- NCCL for CUDA tensors (on the device's default stream, as the
world route's), gloo for host tensors, so that host traffic (the
parameter publisher's) never touches the training job's NCCL
communicator.  A one-member set computes locally, with no group.  The
semantics are the reference's :func:`execute_host`: a sum in the entry's
dtype, an average that divides floats by the set's size and floor-divides
integers, an allgather in set-local rank order, a broadcast from a
set-local root.  A result stays on its contribution's device.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import metrics as _metrics

# Metric series retired when a set reconfigures or is removed (tag value =
# set name); counters survive by registry policy (remove_matching drops
# gauges/histograms only).
PER_SET_SERIES = (
    "control.negotiate_seconds",
    "control.tick_seconds",
    "control.set_requests",
    "elastic.set_generation",
    "publish.latency_seconds",
    "publish.staleness_seconds",
    "publish.epoch",
)


class ProcessSet:
    """One named communicator over a subset of global ranks.

    Mirrors the native ``htpu::ProcessSet`` (cpp/htpu/process_set.h):
    ascending member ranks, a set-local rank space, and a membership
    generation bumped by per-set reconfiguration."""

    def __init__(self, set_id: int, name: str, ranks: Sequence[int]):
        self.id = int(set_id)
        self.name = name
        self.ranks: Tuple[int, ...] = tuple(sorted(int(r) for r in ranks))
        self.generation = 0

    def size(self) -> int:
        return len(self.ranks)

    def included(self, global_rank: int) -> bool:
        return int(global_rank) in self.ranks

    def local_rank(self, global_rank: int) -> int:
        """SET-LOCAL rank of ``global_rank`` (-1 when not a member)."""
        try:
            return self.ranks.index(int(global_rank))
        except ValueError:
            return -1

    def rank(self) -> int:
        """Set-local rank of this process (-1 when it is not a member) --
        the per-set analogue of ``hvd.rank()``; each process is one
        rank."""
        from horovod_tpu_torch import basics
        return self.local_rank(basics._require_init().topology.rank)

    def __repr__(self) -> str:
        return (f"ProcessSet(id={self.id}, name={self.name!r}, "
                f"ranks={list(self.ranks)}, generation={self.generation})")


def parse_spec(spec: str) -> List[Tuple[str, List[int]]]:
    """Parse the ``HOROVOD_TPU_PROCESS_SETS`` grammar
    (``name:0,1;name2:2,3``) into ``[(name, ranks), ...]``; raises
    ``ValueError`` on a malformed spec -- the native parser's strictness
    (``ProcessSetTable::ParseSpec``), which refuses init rather than
    silently dropping a tenant."""
    out: List[Tuple[str, List[int]]] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, ranks_txt = part.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"malformed process-set spec entry {part!r}: expected "
                "'name:rank,rank,...' entries separated by ';'")
        try:
            ranks = [int(tok) for tok in ranks_txt.split(",") if tok.strip()]
        except ValueError:
            raise ValueError(
                f"malformed process-set spec entry {part!r}: ranks must "
                "be integers") from None
        if not ranks or any(r < 0 for r in ranks):
            raise ValueError(
                f"malformed process-set spec entry {part!r}: needs at "
                "least one non-negative rank")
        out.append((name, ranks))
    return out


class ProcessSetRegistry:
    """Python mirror of the native ``ProcessSetTable``: registered sets
    plus their scoped negotiation state (MessageTable + response cache per
    set).  Mutex-guarded so the controller's tick thread can negotiate on
    one set while a framework thread registers or tears down another."""

    def __init__(self, cache_capacity: int = 0):
        self._lock = threading.Lock()
        self._cache_capacity = int(cache_capacity)
        self._next_id = 1
        self._sets: Dict[int, ProcessSet] = {}
        self._tables: Dict[int, object] = {}
        self._caches: Dict[int, object] = {}

    # --------------------------------------------------------- registration

    def parse_spec(self, spec: str) -> bool:
        """Register every set in ``spec``; False (earlier entries stay
        registered -- native parity) on a malformed spec or a rejected
        registration."""
        try:
            entries = parse_spec(spec)
        except ValueError:
            return False
        for name, ranks in entries:
            if self.add(name, ranks) < 0:
                return False
        return True

    def add(self, name: str, ranks: Sequence[int]) -> int:
        """Register a set; returns the new id, or -1 on invalid input
        (empty membership, duplicate rank, duplicate name)."""
        members = sorted(int(r) for r in ranks)
        with self._lock:
            if (not name or not members
                    or len(set(members)) != len(members)
                    or any(ps.name == name for ps in self._sets.values())):
                return -1
            sid = self._next_id
            self._next_id += 1
            ps = ProcessSet(sid, name, members)
            self._sets[sid] = ps
            self._tables[sid] = self._new_table(len(members))
            self._caches[sid] = self._new_cache(len(members))
            return sid

    @staticmethod
    def _new_table(size: int):
        from horovod_tpu_torch.core import MessageTable
        return MessageTable(size)

    def _new_cache(self, size: int):
        del size   # capacity-bounded like the native per-set cache slots
        from horovod_tpu_torch.core import _LocalResponseCache
        return _LocalResponseCache(self._cache_capacity)

    def remove(self, set_id: int) -> bool:
        """Tear a set down; True if it existed.  In-flight requests for
        the removed set error out at routing, never cross-talk."""
        with self._lock:
            if set_id not in self._sets:
                return False
            ps = self._sets.pop(set_id)
            self._tables.pop(set_id, None)
            self._caches.pop(set_id, None)
        retire_metrics(ps.name)
        return True

    # -------------------------------------------------------------- queries

    def get(self, set_id: int) -> Optional[ProcessSet]:
        with self._lock:
            return self._sets.get(int(set_id))

    def by_name(self, name: str) -> Optional[ProcessSet]:
        with self._lock:
            for ps in self._sets.values():
                if ps.name == name:
                    return ps
        return None

    def id_of(self, name: str) -> int:
        ps = self.by_name(name)
        return ps.id if ps is not None else -1

    def count(self) -> int:
        with self._lock:
            return len(self._sets)

    def size_of(self, set_id: int) -> int:
        ps = self.get(set_id)
        return ps.size() if ps is not None else -1

    def local_rank(self, set_id: int, global_rank: int) -> int:
        ps = self.get(set_id)
        return ps.local_rank(global_rank) if ps is not None else -1

    def generation(self, set_id: int) -> int:
        ps = self.get(set_id)
        return ps.generation if ps is not None else -1

    def all(self) -> List[ProcessSet]:
        with self._lock:
            return list(self._sets.values())

    # -------------------------------------------------------------- elastic

    def reconfigure(self, set_id: int, lost_global_rank: int) -> int:
        """Per-set elastic reconfiguration: drop the lost rank from the
        set's membership, clear its negotiation state (stale set-local
        ranks would corrupt later negotiations), bump the generation.
        Returns the new generation, or -1 on an unknown set/rank."""
        with self._lock:
            ps = self._sets.get(int(set_id))
            if ps is None or not ps.included(lost_global_rank):
                return -1
            ps.ranks = tuple(r for r in ps.ranks
                             if r != int(lost_global_rank))
            ps.generation += 1
            self._tables[set_id] = self._new_table(len(ps.ranks))
            self._caches[set_id] = self._new_cache(len(ps.ranks))
            gen = ps.generation
            name = ps.name
        retire_metrics(name)
        _metrics.registry.set_gauge(
            f"elastic.set_generation#process_set={name}", gen)
        return gen

    # ---------------------------------------------------------- negotiation

    def increment(self, set_id: int, request) -> int:
        """Route one request into its set's table: 1 when the tensor is
        ready to construct, 0 when still waiting, -1 on an unknown set or
        a set-local rank out of range (native ``Increment`` parity)."""
        with self._lock:
            ps = self._sets.get(int(set_id))
            table = self._tables.get(int(set_id))
        if ps is None or table is None:
            return -1
        if not 0 <= request.request_rank < ps.size():
            return -1
        return 1 if table.increment(request) else 0

    def construct_response(self, set_id: int, name: str):
        """Construct the set's response for ``name`` (after
        :meth:`increment` returned 1); the response's ``process_set`` is
        stamped.  Raises ``KeyError`` on an unknown set."""
        with self._lock:
            table = self._tables.get(int(set_id))
        if table is None:
            raise KeyError(f"unknown process set id {set_id}")
        resp = table.construct_response(name)
        resp.process_set = int(set_id)
        return resp

    def clear_negotiation_state(self) -> None:
        """Abort/quiesce: drop every set's readiness counts and cached
        responses (membership and generations survive -- only in-flight
        negotiation dies with the job)."""
        with self._lock:
            tables = list(self._tables.values())
            caches = list(self._caches.values())
        for t in tables:
            t.clear()
        for c in caches:
            c.flush()


# --------------------------------------------------------------------------
# Module-global registry + public API
# --------------------------------------------------------------------------

_registry: Optional[ProcessSetRegistry] = None
_registry_lock = threading.Lock()


def registry() -> ProcessSetRegistry:
    """The process-global set registry (created on first use; seeded from
    ``HOROVOD_TPU_PROCESS_SETS`` so the Python ids match the native
    coordinator's, which parses the same spec at Create)."""
    global _registry
    with _registry_lock:
        if _registry is None:
            from horovod_tpu_torch.core import cache_capacity_from_env
            reg = ProcessSetRegistry(cache_capacity_from_env())
            spec = os.environ.get("HOROVOD_TPU_PROCESS_SETS", "")
            if spec:
                # Loud failure: a silently dropped tenant would deadlock
                # its first collective 60 s later.
                for name, ranks in parse_spec(spec):
                    if reg.add(name, ranks) < 0:
                        raise ValueError(
                            f"HOROVOD_TPU_PROCESS_SETS rejected entry "
                            f"{name!r} (duplicate name or rank in "
                            f"{ranks})")
            _registry = reg
        return _registry


def reset() -> None:
    """Drop the global registry and the set groups (tests + shutdown); the
    next access re-seeds from the environment."""
    global _registry
    with _registry_lock:
        _registry = None
    _groups.clear()


def get(set_id: int) -> Optional[ProcessSet]:
    return registry().get(set_id)


def resolve(process_set) -> ProcessSet:
    """Accept a :class:`ProcessSet`, a set name, or a numeric id; raises
    ``ValueError`` on anything unknown."""
    reg = registry()
    if isinstance(process_set, ProcessSet):
        ps = reg.get(process_set.id)
        if ps is not None:
            return ps
    elif isinstance(process_set, str):
        ps = reg.by_name(process_set)
        if ps is not None:
            return ps
    elif isinstance(process_set, int) and process_set != 0:
        ps = reg.get(process_set)
        if ps is not None:
            return ps
    raise ValueError(
        f"Unknown process set {process_set!r}: register it with "
        "hvd.add_process_set([...], name=...) or the "
        "HOROVOD_TPU_PROCESS_SETS spec (see docs/process-sets.md).")


def add_process_set(ranks: Sequence[int],
                    name: Optional[str] = None) -> ProcessSet:
    """Register a named process set over ``ranks`` (reference
    ``hvd.add_process_set``).  Jobs of several processes use the
    ``HOROVOD_TPU_PROCESS_SETS`` startup spec instead -- the native
    coordinator's registry is sealed at init, so a dynamically added id
    would be unknown to it and every collective on it would error."""
    from horovod_tpu_torch import basics
    st = basics._state
    if (st.initialized and st.topology is not None
            and st.topology.process_count > 1):
        raise RuntimeError(
            "add_process_set() after init is single-process only: "
            "multi-process jobs register sets with "
            "HOROVOD_TPU_PROCESS_SETS=<name:ranks;...> on every process "
            "so the coordinator knows them too (docs/process-sets.md).")
    reg = registry()
    if name is None:
        name = "set_" + ",".join(str(int(r)) for r in sorted(ranks))
    sid = reg.add(name, ranks)
    if sid < 0:
        raise ValueError(
            f"add_process_set rejected {name!r} over {list(ranks)}: "
            "empty membership, duplicate rank, or duplicate name.")
    _metrics.registry.set_gauge(
        f"elastic.set_generation#process_set={name}", 0)
    return reg.get(sid)


def remove_process_set(process_set) -> bool:
    """Tear a set down (by object, name, or id); True if it existed."""
    try:
        ps = resolve(process_set)
    except ValueError:
        return False
    _drop_group(ps.id)
    return registry().remove(ps.id)


def process_set_by_name(name: str) -> Optional[ProcessSet]:
    return registry().by_name(name)


def reconfigure_process_set(process_set, lost_global_rank: int) -> int:
    """Per-set elastic: drop ``lost_global_rank`` from the set, retire its
    tagged metric series, bump and return the new generation (-1 on an
    unknown set/rank).  The pod is untouched -- this is the per-tenant
    failure domain.  In a job of several processes every process calls
    it, in the same order: each keeps its own registry, and the set's
    group over its remaining members is made on the whole world
    (:func:`rebuild_group`)."""
    ps = resolve(process_set)
    gen = registry().reconfigure(ps.id, lost_global_rank)
    if gen >= 0:
        rebuild_group(ps)
    return gen


def on_pod_reconfigure(lost_global_rank: int) -> None:
    """Pod-level membership-change hook (elastic RECONFIGURE broadcast):
    every registered set containing the lost rank reconfigures itself --
    its generation advances independently of the pod's."""
    if lost_global_rank < 0 or _registry is None:
        return
    reg = registry()
    for ps in reg.all():
        if ps.included(lost_global_rank):
            reg.reconfigure(ps.id, lost_global_rank)


def retire_metrics(set_name: str) -> None:
    """Retire every per-set gauge/histogram series tagged with this set
    (membership changed or set removed: the old series describe a world
    that no longer exists; counters survive as process-lifetime totals,
    the pod re-rank path's policy)."""
    for prefix in PER_SET_SERIES:
        _metrics.registry.remove_matching(
            f"{prefix}#process_set={set_name}")


# --------------------------------------------------------------------------
# Set groups: one torch.distributed group a set, on its member processes
# --------------------------------------------------------------------------

# set id -> this process's group of that set (members of sets of two or
# more ranks only), and the device kind it was built for.
_groups: Dict[int, Tuple[object, str]] = {}


def _backend(kind: str) -> str:
    """NCCL carries a set's CUDA tensors and gloo its host tensors: one
    group with both backends in a CUDA job, gloo alone in a CPU job."""
    return "cpu:gloo,cuda:nccl" if kind == "cuda" else "gloo"


def _warm(group, kind: str, device) -> None:
    """One collective on each backend of a member's group, so that a
    group that cannot form fails here with its cause."""
    dist.all_reduce(torch.zeros(1), group=group)
    if kind == "cuda":
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        torch.cuda.synchronize(device)


def build_groups(kind: str, rank: int, size: int, device) -> None:
    """The group of every registered set of two or more ranks, made on
    EVERY process in set-id order (``dist.new_group`` is collective over
    the world), kept by its members and warmed by them in the same order
    (``basics.init`` and every generation's ``basics._rebuild_world``,
    after the world group).  A set with a rank outside the world gets
    none, and its collectives raise."""
    _groups.clear()
    if size <= 1 or _registry is None:
        return
    made: Dict[Tuple[int, ...], object] = {}
    for ps in sorted(registry().all(), key=lambda p: p.id):
        if ps.size() < 2 or any(r >= size for r in ps.ranks):
            continue
        if ps.ranks not in made:
            made[ps.ranks] = dist.new_group(list(ps.ranks),
                                            backend=_backend(kind))
        if ps.included(rank):
            _groups[ps.id] = (made[ps.ranks], kind)
    warmed: set = set()
    for sid in sorted(_groups):
        group = _groups[sid][0]
        if id(group) not in warmed:
            warmed.add(id(group))
            _warm(group, kind, device)


def _drop_group(set_id: int) -> None:
    """Abort this process's group of the set, never waiting on it (a
    member may be gone)."""
    entry = _groups.pop(set_id, None)
    if entry is not None and not any(g is entry[0]
                                     for g, _ in _groups.values()):
        dist.distributed_c10d._abort_process_group(entry[0])


def rebuild_group(ps: ProcessSet) -> None:
    """After a per-set reconfigure, on every process of the world: abort
    the set's old group (on its old members) and make the new one over
    the remaining members.  ``dist.new_group(...,
    use_local_synchronization=True)`` would let the members alone make
    it, but on gloo (torch 2.13) such a group hung -- in its creation or
    its first collective -- once the processes had made different groups
    before it; a world-collective ``new_group`` has no such history to
    agree on."""
    from horovod_tpu_torch import basics
    st = basics._state
    _drop_group(ps.id)
    if (not st.initialized or st.topology.size <= 1 or ps.size() < 2
            or any(r >= st.topology.size for r in ps.ranks)):
        return
    group = dist.new_group(list(ps.ranks), backend=_backend(st.kind))
    if ps.included(st.topology.rank):
        _groups[ps.id] = (group, st.kind)
        _warm(group, st.kind, st.device)


def group_of(ps: ProcessSet, device: torch.device):
    """This process's group of ``ps`` for a tensor on ``device``; raises
    when there is none, or when a CUDA tensor would not ride NCCL."""
    entry = _groups.get(ps.id)
    if entry is None:
        raise RuntimeError(
            f"process set '{ps.name}' (ranks {list(ps.ranks)}, generation "
            f"{ps.generation}) has no group on this process in this "
            "membership generation")
    group, kind = entry
    if device.type == "cuda" and kind != "cuda":
        raise ValueError(
            f"process set '{ps.name}': a CUDA tensor needs the set's NCCL "
            "group, and this job's groups are gloo (init(device='cpu'))")
    return group


# --------------------------------------------------------------------------
# The set data plane
# --------------------------------------------------------------------------

def execute(entry, ps: ProcessSet, tensor_sizes: Sequence[int] = ()):
    """Execute one negotiated set-scoped collective: this process's
    contribution ``entry.per_rank[0]``, the result on its device.

    The contract is the reference's :func:`execute_host` (its data plane
    in one process): allreduce sums in the entry's dtype and, for an
    average, divides floats by the set's size (cast back) and
    floor-divides integers; allgather concatenates dim 0 in set-local
    rank order (``tensor_sizes``: the negotiated rows of each member);
    broadcast takes the set-local root's value.  One member computes
    locally; more run over the set's group."""
    from horovod_tpu_torch.core import RequestType
    from horovod_tpu_torch.ops.executor import _average
    mine = entry.per_rank[0]
    n = ps.size()
    if entry.request_type == RequestType.BROADCAST:
        if not 0 <= entry.root_rank < n:
            raise ValueError(
                f"set-local root rank {entry.root_rank} out of range "
                f"for a {n}-member process set")
    elif entry.request_type not in (RequestType.ALLREDUCE,
                                    RequestType.ALLGATHER):
        raise ValueError(f"bad request type {entry.request_type}")
    out = mine.detach().contiguous().clone()
    if n == 1:
        if entry.request_type == RequestType.ALLREDUCE and entry.average:
            out = _average(out, n)
        return out
    group = group_of(ps, mine.device)
    if entry.request_type == RequestType.ALLREDUCE:
        dist.all_reduce(out, group=group)
        return _average(out, n) if entry.average else out
    if entry.request_type == RequestType.BROADCAST:
        dist.broadcast(out, src=ps.ranks[entry.root_rank], group=group)
        return out
    # Ragged allgather: every member's rows padded to the longest, one
    # collective, the true rows kept.
    sizes = [int(s) for s in tensor_sizes] or [int(mine.shape[0])] * n
    rows = max(sizes)
    pad = out.new_zeros((rows,) + tuple(mine.shape[1:]))
    pad[:mine.shape[0]] = out
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])
