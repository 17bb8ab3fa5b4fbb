"""Process-global framework state: init / shutdown / rank queries.

Port of ``horovod_tpu/basics.py:23-160``: every query raises before
``init()``, ``init()`` is idempotent, and ``shutdown()`` is registered with
``atexit``.  With more than one rank, ``init()`` creates the
``torch.distributed`` world group (NCCL on ``cuda``, gloo on ``cpu``) that
the gradient reduction runs over; on ``cuda`` it also selects the GPU of
this process's local rank.  ``hierarchical_mesh`` (:175) and
``get_topology`` (:185) follow the reference.  The negotiated eager plane
and its native controller are not ported yet.
"""

from __future__ import annotations

import atexit
import threading
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch import topology as _topology_mod


class NotInitializedError(RuntimeError):
    """Raised when a query runs before ``init()``."""

    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; use hvd.init().")


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.topology: Optional[_topology_mod.Topology] = None
        self.device: Optional[torch.device] = None
        self.atexit_registered = False


_state = _GlobalState()


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def init(*, device: str = "cuda", init_method: Optional[str] = None) -> None:
    """Initialize the framework (later calls are no-ops).

    ``device``: ``"cuda"`` (default) selects GPU ``local_rank`` and an NCCL
    world group; ``"cpu"`` a gloo group.  ``init_method``: rendezvous of the
    world group when the job has more than one rank, e.g.
    ``"tcp://host:port"``; default ``"env://"`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).
    """
    with _state.lock:
        if _state.initialized:
            return
        topo = _topology_mod.resolve()
        if topo.local_size != 1:
            raise ValueError(
                f"horovod_tpu_torch runs one rank per process; "
                f"HOROVOD_TPU_LOCAL_SIZE={topo.local_size}")
        kind = torch.device(device).type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        if kind == "cuda":
            torch.cuda.set_device(topo.local_rank)
            _state.device = torch.device("cuda", topo.local_rank)
        else:
            _state.device = torch.device("cpu")
        if topo.size > 1:
            dist.init_process_group(
                backend="nccl" if kind == "cuda" else "gloo",
                init_method=init_method or "env://",
                world_size=topo.size, rank=topo.rank)
        _state.topology = topo
        if not _state.atexit_registered:
            atexit.register(shutdown)
            _state.atexit_registered = True
        _state.initialized = True


def shutdown() -> None:
    """Shut the framework down (idempotent; registered with atexit)."""
    with _state.lock:
        if not _state.initialized:
            return
        try:
            if _state.topology.size > 1:
                dist.destroy_process_group()
        finally:
            _state.topology = None
            _state.device = None
            _state.initialized = False


def is_initialized() -> bool:
    return _state.initialized


def size() -> int:
    """Total number of ranks (one GPU each)."""
    return _require_init().topology.size


def local_size() -> int:
    """Number of ranks driven by this process (always 1 in the port)."""
    return _require_init().topology.local_size


def rank() -> int:
    """Global rank of this process; rank 0 is the coordinator."""
    return _require_init().topology.rank


def local_rank() -> int:
    """Index of this process among the processes of its host."""
    return _require_init().topology.local_rank


def get_topology() -> _topology_mod.Topology:
    """The resolved job topology snapshot."""
    return _require_init().topology


def hierarchical_mesh(ici_size: Optional[int] = None):
    """The two-tier ``(dcn, ici)`` layout of the ranks
    (:class:`horovod_tpu_torch.parallel.mesh.HierarchicalMesh`): ``ici``
    groups are the ranks of one host (by host fingerprint), ``ici_size``
    forces a fixed split -- the analogue of the reference's local/cross
    communicator pair (``operations.cc:1499-1532``).  Every rank must
    call it.  Pass it to ``make_train_step(..., mesh=)`` or
    :func:`horovod_tpu_torch.parallel.hierarchical
    .hierarchical_allreduce`."""
    from horovod_tpu_torch.parallel import mesh as _mesh_mod
    return _mesh_mod.build_hierarchical_mesh(_require_init().topology,
                                             ici_size)
