"""Data plane of the eager collectives: runs negotiated responses.

Port of ``horovod_tpu/ops/executor.py`` (``Executor`` :230,
``DistributedExecutor`` :418).  The reference's ``PerformOperation``
(``horovod/common/operations.cc:714-1362``) copies tensors into a fusion
buffer, calls MPI/NCCL, and copies back; so does this module:

* fused ALLREDUCE  -> each entry flattened into one fusion buffer -> one
  collective -> split back, each tensor averaged on its own (floats divide
  and cast back, integers floor-divide, ``:512-520``) -- so tensors with
  different ``average`` flags share a buffer;
* ALLGATHER        -> rank-ordered concat along dim0, sizes taken from the
  negotiated ``tensor_sizes``;
* BROADCAST        -> the root rank's value on every rank;
* ERROR            -> callbacks fired with PRECONDITION_ERROR carrying the
  coordinator's message (``operations.cc:1354-1361``).

:class:`Executor` serves a job of one rank, where every collective is
local.  :class:`DistributedExecutor` serves one rank per process with two
transports, chosen per tensor as the reference chooses per runtime shape
(``_mesh_is_global``, :446-448): CUDA tensors ride the ``torch.distributed``
NCCL world group that every rank shares -- ``dist.all_reduce`` /
``all_gather_into_tensor`` / ``broadcast`` on one device-resident fusion
buffer, the reference's ``_mesh_allreduce`` :523, ``_mesh_allgather`` :633
and ``_mesh_broadcast`` :681 -- and host tensors ride the native TCP ring
of the control plane with the negotiated wire dtype and algorithm
(``_tcp_allreduce`` :565), as the reference's launcher-spawned processes
do.  Results come back on the input's device.

CUDA work runs on the background thread, on the default stream of this
process's device: it follows everything the framework thread queued there
before ``enqueue`` (and a tensor made on another stream is waited for by
its ``ready_event``); :func:`horovod_tpu_torch.ops.eager.synchronize`
orders the caller's stream after it.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.core import (Response, ResponseType, Status,
                                    StatusType, TensorTableEntry)


def _flat_rows(entries: List[TensorTableEntry], dtype: torch.dtype,
               device) -> List[torch.Tensor]:
    """One fusion row per controlled rank: its contributions flattened and
    concatenated (the staging the reference does with memcpys,
    ``operations.cc:1239-1258``)."""
    rows = []
    for r in range(len(entries[0].per_rank)):
        parts = [e.per_rank[r].to(device=device, dtype=dtype).reshape(-1)
                 for e in entries]
        rows.append(parts[0].clone() if len(parts) == 1
                    else torch.cat(parts))
    return rows


def _sum_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    """Dtype-preserving sum of the rows: MPI_Allreduce keeps the element
    type (small ints wrap), unlike torch.sum's promotion."""
    out = rows[0]
    for row in rows[1:]:
        out.add_(row)
    return out


def _average(out: torch.Tensor, nranks: int) -> torch.Tensor:
    """The reference's per-tensor average: floats divide and cast back,
    integers floor-divide (``executor.py:512-520``)."""
    if out.is_floating_point():
        return (out / nranks).to(out.dtype)
    return torch.div(out, nranks, rounding_mode="floor")


def _unpack(reduced: torch.Tensor, entries: List[TensorTableEntry],
            nranks: int, device) -> None:
    """Split the reduced fusion buffer back into the entries' shapes,
    average those that asked for it, and complete each on its input's
    device."""
    offset = 0
    for e in entries:
        like = e.per_rank[0]
        n = like.numel()
        out = reduced[offset:offset + n].reshape(like.shape)
        offset += n
        if e.average:
            out = _average(out, nranks)
        e.callback(Status.OK(), out.to(like.device))


class Executor:
    """The data plane of a job of one rank: every collective is local."""

    def __init__(self, topology, timeline=None):
        self.topology = topology
        self.timeline = timeline
        self.nranks = topology.size
        self.device = torch.device("cpu")

    def bind_thread(self) -> None:
        """Called first on the background thread: CUDA work of this thread
        goes to this process's device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # ----------------------------------------------------------------- entry

    def execute(self, response: Response, entries: List[TensorTableEntry]):
        if self.timeline:
            for e in entries:
                self.timeline.start(e.name, response.response_type)
        try:
            if response.response_type == ResponseType.ERROR:
                status = Status(StatusType.PRECONDITION_ERROR,
                                response.error_message)
                for e in entries:
                    e.callback(status, None)
                return
            for e in entries:
                if e.ready_event is not None:
                    torch.cuda.current_stream().wait_event(e.ready_event)
            if response.response_type == ResponseType.ALLREDUCE:
                self._allreduce(response, entries)
            elif response.response_type == ResponseType.ALLGATHER:
                self._allgather(response, entries)
            elif response.response_type == ResponseType.BROADCAST:
                self._broadcast(response, entries)
            else:
                raise ValueError(f"bad response type {response.response_type}")
        except Exception as exc:   # noqa: BLE001 — propagate as status
            status = self._failure_status(exc)
            for e in entries:
                e.callback(status, None)
        finally:
            if self.timeline:
                for e in entries:
                    self.timeline.end(e.name)

    def _failure_status(self, exc: Exception) -> Status:
        return Status(StatusType.UNKNOWN_ERROR, repr(exc))

    def _span(self, entries, activity: str) -> None:
        if self.timeline:
            self.timeline.activity_start_all(entries, activity)

    def _end(self, entries) -> None:
        if self.timeline:
            self.timeline.activity_end_all(entries)

    # ------------------------------------------------------------- allreduce

    def _allreduce(self, response: Response, entries: List[TensorTableEntry]):
        """Fused allreduce of all entries in ``response.tensor_names``."""
        like = entries[0].per_rank[0]
        self._span(entries, "MEMCPY_IN_FUSION_BUFFER")
        rows = _flat_rows(entries, like.dtype, like.device)
        self._end(entries)
        self._span(entries, "LOCAL_ALLREDUCE")
        reduced = _sum_rows(rows)
        self._end(entries)
        self._span(entries, "MEMCPY_OUT_FUSION_BUFFER")
        _unpack(reduced, entries, self.nranks, like.device)
        self._end(entries)

    # ------------------------------------------------------------- allgather

    def _allgather(self, response: Response, entries: List[TensorTableEntry]):
        """Rank-ordered concat along dim0; per-rank dim0 sizes come from the
        negotiated response (ragged shapes are legal)."""
        for e in entries:
            self._span([e], "LOCAL_ALLGATHER")
            out = torch.cat([p.to(e.per_rank[0].device) for p in e.per_rank])
            self._end([e])
            e.callback(Status.OK(), out)

    # ------------------------------------------------------------- broadcast

    def _broadcast(self, response: Response, entries: List[TensorTableEntry]):
        first_rank = self.topology.rank
        for e in entries:
            self._span([e], "LOCAL_BROADCAST")
            root_local = e.root_rank - first_rank
            if not 0 <= root_local < len(e.per_rank):
                raise ValueError(
                    f"root rank {e.root_rank} not controlled by this process")
            out = e.per_rank[root_local].clone()
            self._end([e])
            e.callback(Status.OK(), out)


class DistributedExecutor(Executor):
    """Multi-process data plane, one rank per process: CUDA tensors on the
    shared NCCL world group (``device_kind="cuda"``), host tensors on the
    native TCP ring of :class:`horovod_tpu_torch.cpp_core.CppControlPlane`
    (``operations.cc:1232-1353``).  Negotiation orders responses
    identically on every process, so all processes enter the same
    collectives in the same order, and the coordinator refuses a tensor
    that is on the GPU on one rank and on the host on another."""

    # Fused allreduce compositions kept for inspection (the names of each
    # executed allreduce response, newest last).
    RECENT_FUSIONS = 64

    def __init__(self, topology, timeline, control, rank_to_process,
                 device_kind: str = "cpu"):
        super().__init__(topology, timeline)
        self._control = control
        self._rank_to_process = rank_to_process
        # CUDA tensors of every rank share one NCCL world group: the
        # reference's shared-runtime case, where payloads stay on the
        # device and only negotiation metadata crosses TCP.
        self._mesh_is_global = device_kind == "cuda"
        self.recent_fusions: collections.deque = collections.deque(
            maxlen=self.RECENT_FUSIONS)

    def _on_nccl(self, t: torch.Tensor) -> bool:
        return self._mesh_is_global and t.is_cuda

    def _failure_status(self, exc: Exception) -> Status:
        """A TCP data-plane failure means a peer process died mid-collective:
        attribute it to the ring neighbour the native core recorded, so this
        rank's error carries the same (rank, reason) every other rank will
        get from the coordinator's ABORT broadcast."""
        if isinstance(exc, ConnectionError):
            try:
                rank, reason = self._control.last_error()
            except Exception:   # noqa: BLE001 — attribution is best-effort
                rank, reason = -1, ""
            if rank >= 0 and reason:
                return Status.aborted(
                    f"Horovod job aborted: rank {rank} failed: {reason}")
            return Status.aborted(str(exc) or repr(exc))
        return super()._failure_status(exc)

    # ------------------------------------------------------------- allreduce

    def _allreduce(self, response: Response, entries: List[TensorTableEntry]):
        like = entries[0].per_rank[0]
        self.recent_fusions.append(tuple(e.name for e in entries))
        if self._on_nccl(like):
            self._span(entries, "MEMCPY_IN_FUSION_BUFFER")
            buf = _sum_rows(_flat_rows(entries, like.dtype, self.device))
            self._end(entries)
            self._span(entries, "NCCL_ALLREDUCE")
            dist.all_reduce(buf)
            self._end(entries)
        else:
            buf = self._tcp_allreduce(entries, like.dtype,
                                      getattr(response, "algo", ""))
        self._span(entries, "MEMCPY_OUT_FUSION_BUFFER")
        _unpack(buf, entries, self.nranks, like.device)
        self._end(entries)

    def _tcp_allreduce(self, entries, dtype, algo=""):
        """Host data plane: the fusion buffer staged on the host, then the
        coordinator-selected collective ("" = chunked TCP ring; "hier" =
        two-level hierarchical; "small" = latency-optimal small-tensor
        path) with the negotiated wire compression, which is uniform
        across the fused entries (the planner only merges matching wire
        dtypes)."""
        from horovod_tpu_torch.core import dtype_name
        from horovod_tpu_torch.timeline import wire_activity
        self._span(entries, "MEMCPY_IN_FUSION_BUFFER")
        buf = _sum_rows(_flat_rows(entries, dtype, torch.device("cpu")))
        wire_dtype = getattr(entries[0], "wire_dtype", "")
        self._end(entries)
        # Span name carries the resolved algorithm so traces show which
        # data-plane path each fused payload took.
        activity = wire_activity("TCP_ALLREDUCE", wire_dtype)
        if algo:
            activity += f"[{algo}]"
        self._span(entries, activity)
        # Name the in-flight tensors for the integrity layer: a checked
        # transfer that exhausts its retransmit budget folds this into the
        # attributed abort (HOROVOD_TPU_INTEGRITY).
        names = ",".join(e.name for e in entries[:3])
        if len(entries) > 3:
            names += f",+{len(entries) - 3}"
        self._control.set_xfer_context(names)
        reduced = self._control.allreduce(dtype_name(dtype), _host_view(buf),
                                          wire_dtype, algo)
        self._end(entries)
        return _from_bytes(reduced, dtype, buf.shape)

    # ------------------------------------------------------------- allgather

    def _allgather(self, response: Response,
                   entries: List[TensorTableEntry]):
        sizes = list(response.tensor_sizes)   # rows per global rank
        for e in entries:
            mine = e.per_rank[0]
            row_shape = tuple(mine.shape[1:])
            if self._on_nccl(mine):
                self._span([e], "NCCL_ALLGATHER")
                out = self._nccl_allgather(mine, sizes, row_shape)
            else:
                self._span([e], "TCP_ALLGATHER")
                local = mine.detach().to("cpu").contiguous()
                data = self._control.allgather(_host_view(local).tobytes())
                out = _from_bytes(data, mine.dtype,
                                  (sum(sizes),) + row_shape).to(mine.device)
            self._end([e])
            e.callback(Status.OK(), out)

    def _nccl_allgather(self, mine: torch.Tensor, sizes, row_shape):
        """Ragged allgather on the NCCL group: pad each rank's rows to the
        negotiated maximum, gather the (ranks, max_rows, ...) buffer in
        one collective, then concat the true sizes back -- all on the
        device."""
        max_rows = max(sizes)
        buf = torch.zeros((max_rows,) + row_shape, dtype=mine.dtype,
                          device=self.device)
        buf[:mine.shape[0]] = mine
        out = torch.empty((len(sizes) * max_rows,) + row_shape,
                          dtype=mine.dtype, device=self.device)
        dist.all_gather_into_tensor(out, buf)
        if all(s == max_rows for s in sizes):
            return out
        out = out.view((len(sizes), max_rows) + row_shape)
        return torch.cat([out[r, :s] for r, s in enumerate(sizes)])

    # ------------------------------------------------------------- broadcast

    def _broadcast(self, response: Response,
                   entries: List[TensorTableEntry]):
        first_rank = self.topology.rank
        for e in entries:
            mine = e.per_rank[0]
            if self._on_nccl(mine):
                self._span([e], "NCCL_BROADCAST")
                out = mine.to(self.device).clone()
                dist.broadcast(out, src=e.root_rank)
            else:
                self._span([e], "TCP_BROADCAST")
                root_process = self._rank_to_process[e.root_rank]
                root_local = e.root_rank - first_rank
                payload = (_host_view(mine.detach().to("cpu").contiguous())
                           .tobytes()
                           if 0 <= root_local < len(e.per_rank) else b"")
                data = self._control.broadcast(root_process, payload)
                out = _from_bytes(data, mine.dtype,
                                  tuple(mine.shape)).to(mine.device)
            self._end([e])
            e.callback(Status.OK(), out)


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A contiguous host tensor as the numpy array the native core reads:
    bfloat16 (which numpy lacks) as its 16-bit patterns, the dtype named
    to the core separately."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_bytes(data: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """A new host tensor of ``dtype`` and ``shape`` over a copy of
    ``data``."""
    if not data:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)
