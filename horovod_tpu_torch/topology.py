"""Job topology from the launcher's environment.

Port of ``horovod_tpu/topology.py`` (``Topology`` :37, ``resolve`` :293),
for one process per GPU.  The JAX package reads the rank space from the
same launcher variables (``topology.py:87,318-325``) and otherwise asks the
JAX runtime for its devices; the port has no such runtime, so without the
variables the job is one rank.  ``host_fingerprint`` (:115) and
``derive_host_groups`` (:159) are the reference's, verbatim: they feed the
intra-host and cross-host groups of :mod:`.parallel.mesh` and the
controller's host discovery, which sets ``local_rank`` when
``HOROVOD_TPU_LOCAL_RANK`` is unset (:func:`local_rank_is_explicit`).

Rank subsets (``resolve(ranks)``, reference :293-377): the launched
ranks listed in ``ranks`` form a job of ``len(ranks)`` ranks, rank r
being the launched rank ``ranks[r]``; a launched process outside the list
raises.  As in the reference, a job whose control plane spans processes
(``HOROVOD_TPU_COORD_ADDR`` with more than one process, every job of
``python -m horovod_tpu_torch.run``) refuses a subset: the subset is the
reference's mode of several processes without a control plane, where the
in-step path works and the eager collectives raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable snapshot of the job topology at init time.

    * ``size``       -- total ranks in the job;
    * ``rank``       -- this process's global rank;
    * ``local_rank`` -- this process's index among the processes of its
      host, which is also the index of its GPU;
    * ``local_size`` -- ranks driven by this process (1: one GPU each);
    * ``launched_rank`` -- in a rank subset, this process's rank in the
      job as launched (``HOROVOD_TPU_RANK``); ``None`` otherwise.
    """

    size: int
    rank: int
    local_rank: int
    local_size: int
    launched_rank: Optional[int] = None

    # One rank per process: the reference's process queries
    # (``horovod_tpu/topology.py``) are the rank queries.
    @property
    def process_index(self) -> int:
        return self.rank

    @property
    def process_count(self) -> int:
        return self.size

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def local_rank_is_explicit() -> bool:
    """Whether the launcher set ``HOROVOD_TPU_LOCAL_RANK``; without it the
    controller discovers the index among the host's processes, as the
    reference does (``horovod_tpu/topology.py:75-92``)."""
    return os.environ.get("HOROVOD_TPU_LOCAL_RANK", "") != ""


def resolve(ranks: Optional[Sequence[int]] = None) -> Topology:
    """Read ``HOROVOD_TPU_SIZE``, ``HOROVOD_TPU_RANK``,
    ``HOROVOD_TPU_LOCAL_RANK`` and ``HOROVOD_TPU_LOCAL_SIZE``; without them
    the job is a single rank.  ``local_rank`` is 0 until ``init()`` folds
    in the discovered one, unless the variable sets it.

    ``ranks``: a subset of the launched ranks (module docstring), checked
    with the reference's texts (``horovod_tpu/topology.py:316,356,359,
    371``).  The member keeps the ``local_rank`` of its launch."""
    size = _env_int("HOROVOD_TPU_SIZE", 1)
    rank = _env_int("HOROVOD_TPU_RANK", 0)
    local_rank = _env_int("HOROVOD_TPU_LOCAL_RANK", 0)
    local_size = _env_int("HOROVOD_TPU_LOCAL_SIZE", 1)
    if (ranks is not None and os.environ.get("HOROVOD_TPU_COORD_ADDR")
            and _env_int("HOROVOD_TPU_PROCESS_COUNT", size) > 1):
        raise ValueError(
            "rank subsets are not supported in multi-process mode")
    # An elastic standby's env-derived rank is a placeholder ABOVE the
    # live rank space (the launcher hands spares process indices past the
    # worker range); the controller adopts the real seat at admission
    # (reference ``topology.py:334-341``).
    standby = (os.environ.get("HOROVOD_TPU_STANDBY", "") == "1"
               and os.environ.get("HOROVOD_TPU_ELASTIC", "") == "1")
    if size < 1 or rank < 0 or (rank >= size and not standby):
        raise RuntimeError(
            f"horovod_tpu_torch: rank {rank} is outside a job of size "
            f"{size}")
    if local_rank < 0 or local_size < 1:
        raise RuntimeError(
            f"horovod_tpu_torch: bad local layout (local_rank "
            f"{local_rank}, local_size {local_size})")
    if ranks is None:
        return Topology(size=size, rank=rank, local_rank=local_rank,
                        local_size=local_size)
    ranks = [int(r) for r in ranks]
    if sorted(set(ranks)) != sorted(ranks):
        raise ValueError("duplicate ranks in subset")
    if any(r < 0 or r >= size for r in ranks):
        raise ValueError(
            f"rank subset {ranks} out of range for {size} devices")
    if rank not in ranks:
        raise RuntimeError(
            "this process owns no devices in the requested rank subset")
    return Topology(size=len(ranks), rank=ranks.index(rank),
                    local_rank=local_rank, local_size=local_size,
                    launched_rank=rank)


def host_fingerprint(warn_truncation: bool = False) -> str:
    """Host-unique identity for grouping processes by physical host -- the
    stand-in for the reference's ``MPI_Comm_split_type(SHARED)``
    (``operations.cc:1499-1509``).

    Hostname alone is ambiguous both ways: two hosts can collide on a
    64-byte truncated name, and containers on one host can carry distinct
    names while sharing the hardware.  The kernel boot id is unique per
    booted host and shared by every container on it, so when readable it
    IS the fingerprint.

    ``warn_truncation``: set by callers that compare only the first 64
    bytes of the name.

    ``HOROVOD_TPU_HOST_FINGERPRINT`` (non-empty) overrides everything --
    the seam for faking multi-host layouts on one machine, and an escape
    hatch where boot-id sharing lies about locality (e.g. VMs cloned from
    one image without re-seeding).
    """
    import socket
    import warnings
    forced = os.environ.get("HOROVOD_TPU_HOST_FINGERPRINT", "")
    if forced:
        return forced
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    if boot:
        return boot
    name = socket.gethostname()
    if warn_truncation and len(name.encode()) > 64:
        warnings.warn(
            "horovod_tpu: hostname exceeds the 64-byte host-grouping field "
            "and /proc/sys/kernel/random/boot_id is unreadable; hosts "
            "sharing this 64-byte name prefix would be grouped as one host "
            "(wrong local_rank/local_size).", RuntimeWarning, stacklevel=2)
    return name


def derive_host_groups(
        fingerprints: Sequence[str],
) -> Tuple[Dict[str, List[int]], List[int]]:
    """Host grouping + leader election from per-process host fingerprints
    (index = process index).

    Returns ``(groups, leaders)``: ``groups`` maps each fingerprint to the
    ascending list of process indices on that host; ``leaders`` is the
    per-host leader -- the lowest process index of each host -- ordered
    ascending, which IS the inter-host ring order of the hierarchical
    allreduce (both sides must elect identically or the data plane
    deadlocks).
    """
    groups: Dict[str, List[int]] = {}
    for pidx, fp in enumerate(fingerprints):
        groups.setdefault(fp, []).append(pidx)
    leaders = [procs[0] for procs in groups.values()]
    leaders.sort()
    return groups, leaders
