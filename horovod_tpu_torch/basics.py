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
``check_mesh_async_ordering`` (:230),
``process_index`` (:154) and ``process_count`` (:158), ``local_devices``
(:162), ``devices`` (:166) and ``ranks_mesh`` (:170) follow the
reference.

Rank subsets (``init(ranks=[...])``, reference :58): the launched ranks
listed form the job, in the order given (:func:`.topology.resolve`); a
launched process outside the list raises before it touches any
rendezvous, and a job with a control plane refuses a subset.

Elastic membership (``HOROVOD_TPU_ELASTIC=1``): the world group is made
per membership generation on the rendezvous store that
``python -m horovod_tpu_torch.run`` hosts (``MASTER_ADDR``,
``MASTER_PORT``, ``TORCHELASTIC_USE_AGENT_STORE=True``), under the prefix
``htpu/gen<G>/``, so it outlives any worker; :func:`_rebuild_world`
aborts the old group and makes the next one when the membership changes.
A parked standby (``HOROVOD_TPU_STANDBY=1``) makes none until the
controller adopts the seat it is admitted to.

Process sets (``HOROVOD_TPU_PROCESS_SETS``): right after the world group,
every process makes every set's group, in set-id order, and its members
keep it (:func:`horovod_tpu_torch.process_set.build_groups`); each
generation's world rebuild makes them again, its abort drops them, and
``shutdown`` resets the registry (reference ``basics.py:121-122``).
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import sys
import threading
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import process_set as _process_set_mod
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
        self.kind = "cpu"               # the device type of the job
        self.owns_world = False         # init() made the world group
        self.store = None               # the launcher's store (elastic)


_state = _GlobalState()


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def _launcher_store():
    """A client of the rendezvous store the launcher hosts, made once per
    process; it outlives every worker, rank 0 included."""
    if _state.store is None:
        addr = os.environ.get("MASTER_ADDR", "")
        port = os.environ.get("MASTER_PORT", "")
        if (os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
                or not addr or not port):
            raise RuntimeError(
                "horovod_tpu_torch: elastic membership (HOROVOD_TPU_ELASTIC"
                "=1) with more than one rank needs a rendezvous store that "
                "outlives every worker: launch with python -m "
                "horovod_tpu_torch.run --elastic, which hosts one and "
                "exports MASTER_ADDR, MASTER_PORT and "
                "TORCHELASTIC_USE_AGENT_STORE=True")
        timeout_s = float(os.environ.get("HOROVOD_TPU_CONTROL_TIMEOUT_S",
                                         "60"))
        _state.store = dist.TCPStore(
            addr, int(port), is_master=False,
            timeout=datetime.timedelta(seconds=timeout_s))
    return _state.store


def _init_world(kind: str, size: int, rank: int, init_method,
                generation: Optional[int]) -> None:
    """The world group: on ``init_method`` (default ``env://``), or, for
    membership ``generation`` of an elastic job, on the launcher's store
    under ``htpu/gen<generation>/``."""
    backend = "nccl" if kind == "cuda" else "gloo"
    if generation is None:
        dist.init_process_group(backend=backend,
                                init_method=init_method or "env://",
                                world_size=size, rank=rank)
    else:
        # The old generation's communicators are aborted, never waited
        # on: the watchdog must not tear the survivor down meanwhile
        # (torch's abort API asks for its error handling to be off).
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        store = dist.PrefixStore(f"htpu/gen{generation}/", _launcher_store())
        dist.init_process_group(backend=backend, store=store,
                                world_size=size, rank=rank)
    _state.owns_world = True


def _warm_world(device: torch.device) -> None:
    """One collective on the new world group: NCCL makes its
    communicators at the first one, so every member meets here."""
    t = torch.zeros(1, device=device)
    dist.all_reduce(t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _abort_world() -> None:
    """Abort the world group's communicators, never waiting on them (a
    peer of theirs is gone, or this process left the membership)."""
    if dist.is_initialized() and _state.owns_world:
        # Aborts every group of this world, the process sets' included.
        dist.distributed_c10d._abort_process_group()
    _process_set_mod._groups.clear()
    _state.owns_world = False


def _rebuild_world(generation: int, size: int, rank: int) -> float:
    """Replace the world group for membership ``generation`` (the
    controller's reconfigure, before it wakes the training threads):
    abort the old group's communicators -- a peer of theirs is gone, and
    may have died inside a collective -- then make and warm the new one
    (none at size 1).  Returns the seconds it took.  Raises on failure:
    a CUDA job never goes on over gloo or the host."""
    t0 = time.perf_counter()
    _abort_world()
    if size > 1:
        _init_world(_state.kind, size, rank, None, generation)
        _warm_world(_state.device)
        _process_set_mod.build_groups(_state.kind, rank, size,
                                      _state.device)
    seconds = time.perf_counter() - t0
    from horovod_tpu_torch import metrics as _metrics_mod
    _metrics_mod.registry.observe("elastic.rebuild_seconds", seconds)
    print(f"horovod_tpu_torch elastic: rebuilt the "
          f"{'nccl' if _state.kind == 'cuda' else 'gloo'} world group for "
          f"generation {generation} (size {size}, rank {rank}) in "
          f"{seconds * 1e3:.1f} ms", file=sys.stderr)
    return seconds


def init(ranks: Optional[Sequence[int]] = None, *, device: str = "cuda",
         init_method: Optional[str] = None) -> None:
    """Initialize the framework (later calls are no-ops).

    ``ranks``: a subset of the launched ranks to form the job, as the
    reference's ``init(ranks=)``: rank r of the job is the launched rank
    ``ranks[r]``, so ``[3, 1, 2]`` makes launched rank 3 rank 0; a
    launched process outside the subset raises the reference's
    ``RuntimeError`` and makes no process group.  Only a job without a
    control plane takes a subset (``HOROVOD_TPU_COORD_ADDR`` unset, as
    under an env launch); under ``python -m horovod_tpu_torch.run`` it is
    refused with the reference's ``ValueError``.  The members make a world
    group of ``len(ranks)`` ranks: under ``env://`` its store is hosted by
    the subset's first member, so ``MASTER_ADDR`` must name that
    member's host.  Each member keeps the GPU of its launch
    (``HOROVOD_TPU_LOCAL_RANK``; without it, host discovery ranks the
    members of a host by their launched ranks).  ``HOROVOD_TPU_PROCESS_SETS``
    names ranks of the subset (its rank space, as the reference seeds its
    registry after ``resolve``).

    ``device``: ``"cuda"`` (default) selects GPU ``local_rank`` and an NCCL
    world group; ``"cpu"`` a gloo group.  ``init_method``: rendezvous of the
    world group when the job has more than one rank, e.g.
    ``"tcp://host:port"``; default ``"env://"`` (``MASTER_ADDR`` and
    ``MASTER_PORT``; under ``python -m horovod_tpu_torch.run``, the store
    it hosts).  The eager collectives of a job of several ranks also
    need ``HOROVOD_TPU_COORD_ADDR=<host>:<port>`` (the native control
    plane's coordinator); without it they raise and the in-step path works
    as before.  An elastic job (``HOROVOD_TPU_ELASTIC=1``) makes its world
    group on the launcher's store (module docstring).
    """
    with _state.lock:
        if _state.initialized:
            return
        topo = _topology_mod.resolve(ranks)
        if topo.local_size != 1:
            raise ValueError(
                f"horovod_tpu_torch runs one rank per process; "
                f"HOROVOD_TPU_LOCAL_SIZE={topo.local_size}")
        kind = torch.device(device).type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        elastic = os.environ.get("HOROVOD_TPU_ELASTIC", "") == "1"
        standby = elastic and os.environ.get("HOROVOD_TPU_STANDBY") == "1"
        _state.kind = kind
        if topo.size > 1 and not standby:
            _init_world(kind, topo.size, topo.rank, init_method,
                        0 if elastic else None)
        from horovod_tpu_torch import core as _core_mod
        controller = None
        try:
            controller = _core_mod.Controller(topo, kind)
            # An admitted standby's seat (rank, size) is the one the
            # coordinator assigned; the environment's was a placeholder.
            topo = controller.topology
            # The controller's host discovery found which processes share
            # this host (reference: the shared-memory comm split,
            # operations.cc:1499-1509); an explicit HOROVOD_TPU_LOCAL_RANK
            # wins.
            if (controller.host_local_rank is not None
                    and not _topology_mod.local_rank_is_explicit()):
                topo = dataclasses.replace(
                    topo, local_rank=controller.host_local_rank)
            elif (standby and kind == "cuda"
                  and not _topology_mod.local_rank_is_explicit()):
                raise RuntimeError(
                    "horovod_tpu_torch: an admitted standby skips the "
                    "layout exchange, so it cannot discover its GPU: set "
                    "HOROVOD_TPU_LOCAL_RANK (python -m horovod_tpu_torch.run "
                    "does)")
            device = torch.device("cpu")
            if kind == "cuda":
                torch.cuda.set_device(topo.local_rank)
                device = torch.device("cuda", topo.local_rank)
            _state.device = device
            controller.bind_device(device)
            if standby and topo.size > 1:
                # The survivors make and warm this generation's group in
                # their reconfigure; the admitted standby joins it here.
                _init_world(kind, topo.size, topo.rank, None,
                            controller.generation)
                _warm_world(device)
            elif _state.owns_world and kind == "cuda":
                # NCCL binds the group to the device of its first
                # collective; a barrier issued first would guess the
                # device from the rank (rank % device count), which a
                # rank subset's member (rank 0 on launched rank 3's GPU)
                # does not match: the barrier then hangs.
                _warm_world(device)
            # The process sets' groups, after the world's: a set group
            # that cannot form fails init with its cause.
            _process_set_mod.build_groups(kind, topo.rank, topo.size,
                                          device)
            controller.start()
        except BaseException:
            if controller is not None:
                controller.stop()
            if _state.owns_world and dist.is_initialized():
                dist.destroy_process_group()
            _state.owns_world = False
            _process_set_mod.reset()
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
                if _state.owns_world and dist.is_initialized():
                    dist.destroy_process_group()
            finally:
                _process_set_mod.reset()
                _state.owns_world = False
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


def devices() -> Tuple[torch.device, ...]:
    """The devices of the job that this process can address: its own
    (one process a GPU, as the reference's multi-process topology,
    ``horovod_tpu/topology.py:342-350``)."""
    return (_require_init().device,)


def local_devices() -> Tuple[torch.device, ...]:
    """This process's device, as a one-element tuple."""
    return (_require_init().device,)


def ranks_mesh():
    """The world's 1-D ``("ranks",)`` mesh
    (:func:`horovod_tpu_torch.parallel.mesh.ranks_mesh`), the default
    mesh of the in-step collectives and the parallel modules."""
    _require_init()
    from horovod_tpu_torch.parallel import mesh as _mesh_mod
    return _mesh_mod.ranks_mesh()


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


def check_mesh_async_ordering(what: str) -> None:
    """Raise when dispatching a train step would race outstanding async
    eager collectives on the shared NCCL world group (reference
    ``basics.py:230-253``): the eager executor's thread issues their
    collectives on the group the step's gradient reduction uses, so two
    processes could order them differently and hang.  A no-op before
    init, on the TCP data plane and in single-process jobs
    (:meth:`.core.Controller.mesh_async_hazard` is 0 there).  Called by
    every call of :func:`horovod_tpu_torch.spmd.make_train_step`'s step."""
    c = _state.controller
    if c is None:
        return
    n = c.mesh_async_hazard()
    if n:
        raise RuntimeError(
            f"{what} would dispatch a jitted collective program while "
            f"{n} async eager collective(s) are still outstanding on a "
            f"shared multi-controller runtime.  Call synchronize() (or "
            f"poll() until done) on every *_async handle before "
            f"dispatching jitted steps, so all processes launch mesh "
            f"programs in the same order (see docs/running.md).")


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
