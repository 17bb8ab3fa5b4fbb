"""Eager named-tensor collectives with async handles.

Port of ``horovod_tpu/ops/eager.py`` (:37-288), the dynamic half of the
framework: any rank may submit named tensors in any order and negotiation
reconciles them.  These functions mirror the torch op layer
(``horovod/torch/mpi_ops.py:86-438``): sync (``allreduce``), async
(``allreduce_async`` -> handle), plus ``poll``/``synchronize``::

    import horovod_tpu_torch as hvd
    hvd.init()
    h = hvd.allreduce_async(grad, name="grad.0")
    ...
    grad = hvd.synchronize(h)

The port runs one rank per process, so an input is that rank's tensor.
:class:`PerRank` and :func:`scatter_ranks` keep the reference's surface for
processes that own several ranks: here a ``PerRank`` holds exactly one
value.  Results are new tensors on the input's device.  Inside a training
step use :mod:`horovod_tpu_torch.ops.injit` instead: it issues the
collectives directly, with no negotiation at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.core import (RequestType, Status, StatusType,
                                    TensorTableEntry, default_wire_dtype,
                                    dtype_name, normalize_wire_dtype)


@dataclasses.dataclass
class PerRank:
    """Explicit per-rank contributions (one per rank this process
    controls: one in the port)."""
    values: Sequence


class CollectiveError(RuntimeError):
    """A negotiated collective failed validation or was aborted; carries the
    coordinator's error message (reference raises framework-level
    errors with the same text, e.g. ``tf.errors.FailedPreconditionError``)."""


class HorovodAbortedError(CollectiveError):
    """The job was aborted -- a rank died, hung past the heartbeat deadline,
    or dropped its connections -- and the coordinator broadcast the failure
    to every surviving rank.  The message names the failed rank and the
    root cause; every rank raises the same text.  Subclasses
    :class:`CollectiveError` so existing handlers keep working."""


class HorovodRetryableError(CollectiveError):
    """The collective was quiesced by an elastic membership change: the op
    did NOT run -- restore model state from the latest checkpoint and
    re-submit under the new membership.  Elastic membership is not ported
    yet, so the port raises it only for a RETRYABLE status.  Subclasses
    :class:`CollectiveError` so existing handlers keep working."""


_name_counter = [0]


def _auto_name(prefix: str) -> str:
    _name_counter[0] += 1
    return f"{prefix}.noname.{_name_counter[0]}"


def _as_contribution(v) -> torch.Tensor:
    """Tensors stay where they are (the executor consumes CUDA tensors in
    place, with no host round-trip); anything else becomes a host
    tensor."""
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _normalize(tensor, name_prefix: str, name: Optional[str]):
    if isinstance(tensor, PerRank):
        vals = [_as_contribution(v) for v in tensor.values]
        if len(vals) != 1:
            raise ValueError(
                f"PerRank needs 1 value (one per controlled rank): "
                f"horovod_tpu_torch runs one rank per process, got "
                f"{len(vals)}")
    else:
        vals = [_as_contribution(tensor)]
    return vals, (name if name is not None else _auto_name(name_prefix))


def _wire_dtype_for(compression, dtype, request_type: RequestType) -> str:
    """Resolve the ring wire compression for a submission.

    ``compression`` is a :class:`horovod_tpu_torch.compression.Compressor`
    (class or instance), a wire-dtype string, or ``None`` -> the process
    default (``HOROVOD_TPU_WIRE_DTYPE``).  Compressed wires only apply to
    float32 allreduces -- everything else rides the wire raw (the codecs in
    cpp/htpu/quantize.cc are fp32-in/fp32-out)."""
    if request_type != RequestType.ALLREDUCE or dtype != torch.float32:
        return ""
    if compression is None:
        return default_wire_dtype()
    if isinstance(compression, str):
        return normalize_wire_dtype(compression)
    from horovod_tpu_torch import compression as _comp
    cls = compression if isinstance(compression, type) else type(compression)
    # NoneCompressor means "no explicit choice" -- the env default still
    # applies; force a raw wire despite the env with compression="none".
    wire = {_comp.NoneCompressor: default_wire_dtype(),
            _comp.BF16Compressor: "bf16",
            _comp.FP16Compressor: "fp16",
            _comp.Int8Compressor: "int8"}.get(cls)
    if wire is None:
        raise ValueError(f"Unknown compression {compression!r}: expected "
                         "Compression.none/bf16/fp16/int8 or a wire dtype "
                         "string.")
    return wire


def _ready_event(t: torch.Tensor):
    """An event after the work that produced ``t``, when that work is on a
    stream other than the device's default one (where the background
    thread queues behind it anyway); None otherwise."""
    if not t.is_cuda:
        return None
    stream = torch.cuda.current_stream(t.device)
    if stream == torch.cuda.default_stream(t.device):
        return None
    t.record_stream(torch.cuda.default_stream(t.device))
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _submit(request_type: RequestType, tensor, name: Optional[str],
            name_prefix: str, *, average: bool = False,
            root_rank: int = -1, compression=None,
            process_set=None) -> int:
    if process_set is not None and process_set != 0:
        from horovod_tpu_torch.core import _not_ported
        raise _not_ported("non-default process sets", "Queue 1 item 4")
    ctrl = basics.controller()
    per_rank, resolved = _normalize(tensor, name_prefix, name)
    handle = ctrl.handle_manager.allocate(mesh_hazard=per_rank[0].is_cuda,
                                          name=resolved)

    def callback(status: Status, result):
        ctrl.handle_manager.mark_done(handle, status, result)

    entry = TensorTableEntry(
        name=resolved,
        request_type=request_type,
        per_rank=per_rank,
        dtype=dtype_name(per_rank[0].dtype),
        root_rank=root_rank,
        average=average,
        callback=callback,
        wire_dtype=_wire_dtype_for(compression, per_rank[0].dtype,
                                   request_type),
        ready_event=_ready_event(per_rank[0]),
    )
    status = ctrl.enqueue(entry)
    if not status.ok():
        ctrl.handle_manager.mark_done(handle, status, None)
    return handle


# ------------------------------------------------------------------- public

def allreduce_async(tensor, *, average: bool = True,
                    name: Optional[str] = None, compression=None,
                    process_set=None) -> int:
    """Start an allreduce; returns a handle for ``poll``/``synchronize``
    (reference ``horovod/torch/mpi_ops.py:86-135``).

    ``compression`` selects the host ring's wire format
    (``Compression.bf16``/``Compression.int8``, or a string like
    ``"int8"``): float32 payloads of host tensors are compressed per hop
    and materialized back to fp32 -- the result dtype is unchanged.
    Default (``None``) honours ``HOROVOD_TPU_WIRE_DTYPE``; all ranks must
    agree or negotiation raises a coordinated :class:`CollectiveError`.
    CUDA tensors ride NCCL, which moves them raw whatever the wire dtype.
    ``process_set`` other than the default raises ``NotImplementedError``
    (not ported yet)."""
    return _submit(RequestType.ALLREDUCE, tensor, name, "allreduce",
                   average=average, compression=compression,
                   process_set=process_set)


def allreduce(tensor, *, average: bool = True,
              name: Optional[str] = None, compression=None,
              process_set=None):
    return synchronize(allreduce_async(tensor, average=average, name=name,
                                       compression=compression,
                                       process_set=process_set))


def allgather_async(tensor, *, name: Optional[str] = None,
                    process_set=None) -> int:
    """Start an allgather: concat across ranks on dim0; ranks may contribute
    different dim0 sizes (reference ``mpi_ops.py:200-260``)."""
    return _submit(RequestType.ALLGATHER, tensor, name, "allgather",
                   process_set=process_set)


def allgather(tensor, *, name: Optional[str] = None, process_set=None):
    return synchronize(allgather_async(tensor, name=name,
                                       process_set=process_set))


def broadcast_async(tensor, root_rank: int, *,
                    name: Optional[str] = None, process_set=None) -> int:
    """Start a broadcast of rank ``root_rank``'s value to all ranks
    (reference ``mpi_ops.py:284-360``)."""
    return _submit(RequestType.BROADCAST, tensor, name, "broadcast",
                   root_rank=root_rank, process_set=process_set)


def broadcast(tensor, root_rank: int, *, name: Optional[str] = None,
              process_set=None):
    return synchronize(broadcast_async(tensor, root_rank, name=name,
                                       process_set=process_set))


def poll(handle: int) -> bool:
    """True when the async op behind ``handle`` is complete -- ``synchronize``
    will not block (reference ``mpi_ops.py:400-412``)."""
    return basics.controller().handle_manager.poll(handle)


def synchronize(handle: int, timeout: Optional[float] = 300.0,
                abandon_on_timeout: bool = True):
    """Wait for an async op; returns its output tensor or raises
    :class:`CollectiveError` with the coordinator's message
    (reference ``mpi_ops.py:422-438``).

    On timeout the handle is *abandoned* by default -- a late completion is
    dropped rather than leaking in the handle table.  Pass
    ``abandon_on_timeout=False`` to keep it alive for a retry.  A CUDA
    result was made on the device's default stream; the caller's current
    stream is ordered after it."""
    hm = basics.controller().handle_manager
    try:
        status, result = hm.wait(handle, timeout)
    except TimeoutError:
        if abandon_on_timeout:
            hm.abandon(handle)
        raise
    else:
        hm.release(handle)
    if not status.ok():
        if status.type == StatusType.ABORTED:
            raise HorovodAbortedError(status.reason)
        if status.type == StatusType.RETRYABLE:
            raise HorovodRetryableError(status.reason)
        raise CollectiveError(status.reason)
    if isinstance(result, torch.Tensor) and result.is_cuda:
        stream = torch.cuda.current_stream(result.device)
        default = torch.cuda.default_stream(result.device)
        if stream != default:
            stream.wait_stream(default)
    return result


def scatter_ranks(values) -> PerRank:
    """Convenience: mark a tensor stacked on axis 0 (or a list) as per-rank
    contributions, one per rank this process controls (one in the
    port)."""
    if isinstance(values, (list, tuple)):
        return PerRank(list(values))
    t = _as_contribution(values)
    return PerRank([t[i] for i in range(t.shape[0])])
