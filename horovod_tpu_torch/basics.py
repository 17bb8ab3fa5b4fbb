"""Process-global framework state: init / shutdown / rank queries.

Port of ``horovod_tpu/basics.py:23-254``: every query raises before
``init()``, ``init()`` is idempotent, and ``shutdown()`` is registered with
``atexit``.  With more than one rank, ``init()`` creates the
``torch.distributed`` world group (NCCL on ``cuda``, gloo on ``cpu``) that
the gradient reduction runs over.  It then builds the background
controller of the eager plane (:class:`horovod_tpu_torch.core.Controller`,
``basics.py:58-150``), whose host discovery gives ``local_rank`` when the
launcher does not set ``HOROVOD_TPU_LOCAL_RANK``; only then does it pick
this process's GPU (``cuda:local_rank``) and start the controller.
``shutdown()`` stops the controller first.  ``hierarchical_mesh`` (:175),
``get_topology`` (:185), ``controller`` (:194), ``metrics`` (:198),
``wire_dtype`` (:209), ``mpi_threads_supported`` (:219),
``process_index`` (:154) and ``process_count`` (:158) follow the
reference.
"""

from __future__ import annotations

import atexit
import dataclasses
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
        self.controller = None          # horovod_tpu_torch.core.Controller
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
    ``MASTER_PORT``).  The eager collectives of a job of several ranks also
    need ``HOROVOD_TPU_COORD_ADDR=<host>:<port>`` (the native control
    plane's coordinator); without it they raise and the in-step path works
    as before.
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
        if topo.size > 1:
            dist.init_process_group(
                backend="nccl" if kind == "cuda" else "gloo",
                init_method=init_method or "env://",
                world_size=topo.size, rank=topo.rank)
        from horovod_tpu_torch import core as _core_mod
        controller = None
        try:
            controller = _core_mod.Controller(topo, kind)
            # The controller's host discovery found which processes share
            # this host (reference: the shared-memory comm split,
            # operations.cc:1499-1509); an explicit HOROVOD_TPU_LOCAL_RANK
            # wins.
            if (controller.host_local_rank is not None
                    and not _topology_mod.local_rank_is_explicit()):
                topo = dataclasses.replace(
                    topo, local_rank=controller.host_local_rank)
            device = torch.device("cpu")
            if kind == "cuda":
                torch.cuda.set_device(topo.local_rank)
                device = torch.device("cuda", topo.local_rank)
            controller.bind_device(device)
            controller.start()
        except BaseException:
            if controller is not None:
                controller.stop()
            if topo.size > 1:
                dist.destroy_process_group()
            raise
        from horovod_tpu_torch import metrics as _metrics_mod
        _metrics_mod.start_exporters(topo.rank)
        _state.topology = topo
        _state.device = device
        _state.controller = controller
        if not _state.atexit_registered:
            atexit.register(shutdown)
            _state.atexit_registered = True
        _state.initialized = True


def shutdown() -> None:
    """Shut the framework down (idempotent; registered with atexit): the
    controller first, then the metrics exporters and the world group."""
    with _state.lock:
        if not _state.initialized:
            return
        try:
            _state.controller.stop()
        finally:
            from horovod_tpu_torch import metrics as _metrics_mod
            _metrics_mod.stop_exporters()
            try:
                if _state.topology.size > 1:
                    dist.destroy_process_group()
            finally:
                _state.controller = None
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


def process_index() -> int:
    """Index of this process (its rank: one rank per process)."""
    return _require_init().topology.process_index


def process_count() -> int:
    """Number of processes (the size: one rank per process)."""
    return _require_init().topology.process_count


def get_topology() -> _topology_mod.Topology:
    """The resolved job topology snapshot."""
    return _require_init().topology


def controller():
    """The background controller of the eager plane."""
    return _require_init().controller


def metrics() -> dict:
    """One merged metrics snapshot: the native core's registry (ring bytes
    per wire dtype, tick/gather/negotiation latency, aborts, stalls) plus
    the controller-side series (enqueues/ops by type, handle wait time,
    fusion-buffer utilization, response-cache hits), as ``{"counters",
    "gauges", "histograms", "ts", "rank"}``.  Works before init too."""
    from horovod_tpu_torch import metrics as _metrics_mod
    return _metrics_mod.snapshot()


def wire_dtype() -> str:
    """Effective process-wide default for the host ring's wire compression
    (``HOROVOD_TPU_WIRE_DTYPE``): "" = raw fp32, or "bf16"/"fp16"/"int8".
    Per-call ``allreduce(..., compression=...)`` overrides it; all ranks
    must agree per tensor or negotiation raises a coordinated error."""
    from horovod_tpu_torch.core import default_wire_dtype
    return default_wire_dtype()


def mpi_threads_supported() -> bool:
    """Parity shim for ``hvd.mpi_threads_supported()`` (reference
    ``horovod/common/__init__.py:140-154``): there is no MPI; the control
    plane is thread-safe, so this reports True once initialized."""
    _require_init()
    return True


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
