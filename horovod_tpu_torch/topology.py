"""Job topology from the launcher's environment.

Port of ``horovod_tpu/topology.py`` (``Topology`` :37, ``resolve`` :293),
for one process per GPU.  The JAX package reads the rank space from the
same launcher variables (``topology.py:87,318-325``) and otherwise asks the
JAX runtime for its devices; the port has no such runtime, so without the
variables the job is one rank.  Host groups and rank subsets are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable snapshot of the job topology at init time.

    * ``size``       -- total ranks in the job;
    * ``rank``       -- this process's global rank;
    * ``local_rank`` -- this process's index among the processes of its
      host, which is also the index of its GPU;
    * ``local_size`` -- ranks driven by this process (1: one GPU each).
    """

    size: int
    rank: int
    local_rank: int
    local_size: int


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def resolve() -> Topology:
    """Read ``HOROVOD_TPU_SIZE``, ``HOROVOD_TPU_RANK``,
    ``HOROVOD_TPU_LOCAL_RANK`` and ``HOROVOD_TPU_LOCAL_SIZE``; without them
    the job is a single rank."""
    size = _env_int("HOROVOD_TPU_SIZE", 1)
    rank = _env_int("HOROVOD_TPU_RANK", 0)
    local_rank = _env_int("HOROVOD_TPU_LOCAL_RANK", 0)
    local_size = _env_int("HOROVOD_TPU_LOCAL_SIZE", 1)
    if size < 1 or not 0 <= rank < size:
        raise RuntimeError(
            f"horovod_tpu_torch: rank {rank} is outside a job of size "
            f"{size}")
    if local_rank < 0 or local_size < 1:
        raise RuntimeError(
            f"horovod_tpu_torch: bad local layout (local_rank "
            f"{local_rank}, local_size {local_size})")
    return Topology(size=size, rank=rank, local_rank=local_rank,
                    local_size=local_size)
