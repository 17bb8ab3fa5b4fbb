"""Background controller: negotiation, fusion planning, handle management.

Port of ``horovod_tpu/core.py``, the re-design of the reference's C++ core
(``horovod/common/operations.cc``), for one rank per process on one GPU:

* A per-process **background thread** owns all control-plane state; framework
  threads only enqueue work and receive callbacks -- the reference's key
  architectural invariant (``operations.cc:106-111, 1414-1433``).
* **Negotiation**: a message table counts per-tensor readiness across ranks;
  when every rank has submitted a tensor, a response is constructed with full
  cross-rank validation (mismatched dtype / op / shape / root-rank errors,
  message text matching ``ConstructMPIResponse``,
  ``operations.cc:315-517``), byte for byte the JAX package's.
* **Fusion planner**: consecutive same-dtype allreduce responses are merged
  while their payload stays under the fusion threshold
  (``operations.cc:1807-1842``; default 64 MB, ``operations.cc:151``).
* **Data plane**: ready responses run in :mod:`horovod_tpu_torch.ops.executor`:
  one NCCL collective on one fused CUDA buffer per response, or the native
  TCP ring for CPU tensors.

The control-plane state machine also exists as a C++ library (``cpp/``,
bound in :mod:`horovod_tpu_torch.cpp_core`); when the shared library loads it
replaces the pure-Python message table / fusion / timeline / stall-check
logic below.  Behaviour is identical; the Python path is the fallback and
the executable specification.  Multi-process jobs negotiate over the native
TCP control plane (``HOROVOD_TPU_COORD_ADDR``).  Elastic membership
(``HOROVOD_TPU_ELASTIC=1``) follows the reference: a parked standby adopts
the seat it is admitted to, and a RECONFIGURE re-ranks the controller,
rebuilds the world group of the CUDA data plane
(:func:`horovod_tpu_torch.basics._rebuild_world`) and completes every
in-flight entry RETRYABLE.  Under the precision autopilot
(``HOROVOD_TPU_PRECISION=auto``) each request frame carries the residual
reports queued since the last tick (``FLAG_PRECISION_EXT``), and the
coordinator's stamped ``wire_dtype`` reaches the host data plane through
the response.  The fleet policy's other actuators act inside the native
coordinator (``HOROVOD_TPU_EVICT_THRESHOLD``, ``HOROVOD_TPU_AUTOSCALE``,
``HOROVOD_TPU_AUTOSCALE_FILE``): a demoted straggler or a process a
shrink parks finds itself out of the member table and latches the
native "evicted from the membership" abort, on which this controller
also aborts its world group, so that the process exits without waiting
on a collective of the old generation; the survivors reconfigure in the
order the native plane gives them (fastest first under
``HOROVOD_TPU_POLICY_RERANK``).  Non-default process sets
(:mod:`horovod_tpu_torch.process_set`, ``HOROVOD_TPU_PROCESS_SETS``)
negotiate in their own namespaces on the same tick -- the local loop's
``_negotiate_sets``, the native coordinator's per-set tables -- and run
over their members' groups (``_execute_set``); a set must sit on one
host.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from horovod_tpu_torch import metrics as _metrics


# --------------------------------------------------------------------------
# Status (mirrors horovod/common/common.h:37-53)
# --------------------------------------------------------------------------

class StatusType(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    # Elastic membership changed while this collective was in flight: the
    # operation did NOT complete, but the job survives — restore from the
    # latest checkpoint and resubmit (HorovodRetryableError, not
    # HorovodAbortedError).
    RETRYABLE = 5


@dataclasses.dataclass(frozen=True)
class Status:
    type: StatusType = StatusType.OK
    reason: str = ""

    def ok(self) -> bool:
        return self.type == StatusType.OK

    @staticmethod
    def OK() -> "Status":
        return Status()

    @staticmethod
    def precondition_error(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def retryable(msg: str) -> "Status":
        return Status(StatusType.RETRYABLE, msg)

    @staticmethod
    def invalid_argument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)


def env_flag(name: str) -> bool:
    """0/1-convention env flag (the reference treats any set value as true
    but documents 0/1; '0'/'false'/'' stay false here to avoid surprises)."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false")


SHUT_DOWN_ERROR = Status.aborted(
    "Horovod has been shut down. This has been caused by an exception on one "
    "of the ranks or an attempt to allreduce, allgather or broadcast a tensor "
    "after one of the ranks has finished execution.")
# (error text parity: reference operations.cc:258-263)


# --------------------------------------------------------------------------
# Fault injection (HOROVOD_TPU_FAULT) — test-only failure triggers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed HOROVOD_TPU_FAULT=<mode>:rank=<R>:tick=<T> spec (or
    ``crash_in_save:rank=<R>:epoch=<E>``, the checkpoint-writer fault,
    or ``slow:rank=<R>:ms=<M>[:tick=<T>]``, the planted straggler).

    The native core parses the same env var itself (control.cc) and fires
    the tick-based faults on the tick thread; ``crash_in_save`` is
    Python-owned (ckpt_stream.py fires it mid-commit) and the native
    parser skips it.  ``slow`` fires in whichever controller runs the
    tick — the native plane in multi-process jobs, the local Python loop
    otherwise — delaying the target's tick by M ms from tick T onward
    (every tick when tick= is omitted).  This Python-side parse exists to
    reject malformed specs loudly at init() instead of silently never
    firing.
    """
    mode: str      # "crash" | "hang" | "drop_conn" | "rejoin"
                   # | "crash_in_save" | "slow" | "corrupt" | "corrupt_ckpt"
    rank: int      # first global rank of the target process
    tick: int      # 1-based negotiation tick on which the fault fires;
                   # for crash_in_save/corrupt_ckpt, the 0-based snapshot
                   # epoch; for slow, the first delayed tick (-1 = from
                   # the start)
    ms: int = 0    # slow only: per-tick delay in milliseconds
    leg: str = "classic"  # corrupt only: which data-plane leg to mangle
                          # ("classic" | "shm" | "uring" | "ctrl")
    count: int = 1        # corrupt only: how many frames/chunks to flip

    @property
    def epoch(self) -> int:
        """crash_in_save's trigger: first committed snapshot epoch >= this
        value kills the writer mid-commit.  For corrupt_ckpt, the epoch
        whose committed shard file gets its bytes flipped."""
        return self.tick


_FAULT_MODES = ("crash", "hang", "drop_conn", "rejoin", "crash_in_save",
                "slow", "corrupt", "corrupt_ckpt")

_CORRUPT_LEGS = ("classic", "shm", "uring", "ctrl")


def parse_fault_spec(spec: str) -> Optional[FaultSpec]:
    """Strictly parse ONE fault spec; None for empty, ValueError on
    malformed.  ``rejoin`` arms the coordinator to admit parked standby
    workers at the first tick >= T (elastic mode's deterministic readmit
    trigger); ``crash_in_save`` takes ``epoch=`` instead of ``tick=``
    (epochs are step numbers, counted from 0) and kills the async
    checkpoint writer between staging its shards and committing them;
    ``corrupt`` flips a payload byte post-checksum pre-send on the chosen
    data-plane leg; ``corrupt_ckpt`` flips bytes in a committed shard
    file (Python-owned, like crash_in_save — the native parser skips
    both)."""
    spec = (spec or "").strip()
    if not spec:
        return None
    parts = spec.split(":")
    if parts[0] == "slow":
        # slow:rank=<R>:ms=<M>[:tick=<T>] — a planted straggler: delay
        # the target process's tick by M milliseconds, from tick T
        # onward (every tick when tick= is omitted).
        if len(parts) not in (3, 4):
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: expected "
                "'slow:rank=<R>:ms=<M>[:tick=<T>]'.")
        kv = {}
        for part in parts[1:]:
            key, sep, val = part.partition("=")
            if not sep or key not in ("rank", "ms", "tick") or key in kv:
                raise ValueError(
                    f"Malformed HOROVOD_TPU_FAULT {spec!r}: expected "
                    "'slow:rank=<R>:ms=<M>[:tick=<T>]'.")
            try:
                kv[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"Malformed HOROVOD_TPU_FAULT {spec!r}: {key!r} must "
                    f"be an integer, got {val!r}.") from None
        if "rank" not in kv or "ms" not in kv:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: both rank= and "
                "ms= are required.")
        if kv["rank"] < 0:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: rank must be >= 0.")
        if kv["ms"] <= 0:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: ms must be >= 1.")
        if "tick" in kv and kv["tick"] <= 0:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: tick must be >= 1 "
                "(ticks are counted from 1).")
        return FaultSpec("slow", kv["rank"], kv.get("tick", -1), kv["ms"])
    if parts[0] == "corrupt":
        # corrupt:rank=<R>:tick=<T>[:leg=<L>][:count=<N>] — flip a byte in
        # a data-plane payload post-checksum, pre-send, on the chosen leg
        # (classic socket ring by default), starting at tick T, N times.
        if len(parts) not in (3, 4, 5):
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: expected "
                "'corrupt:rank=<R>:tick=<T>[:leg=<L>][:count=<N>]'.")
        kv = {}
        for part in parts[1:]:
            key, sep, val = part.partition("=")
            if not sep or key not in ("rank", "tick", "leg", "count") \
                    or key in kv:
                raise ValueError(
                    f"Malformed HOROVOD_TPU_FAULT {spec!r}: expected "
                    "'corrupt:rank=<R>:tick=<T>[:leg=<L>][:count=<N>]'.")
            if key == "leg":
                kv[key] = val
                continue
            try:
                kv[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"Malformed HOROVOD_TPU_FAULT {spec!r}: {key!r} must "
                    f"be an integer, got {val!r}.") from None
        if "rank" not in kv or "tick" not in kv:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: both rank= and "
                "tick= are required.")
        if kv["rank"] < 0:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: rank must be >= 0.")
        if kv["tick"] <= 0:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: tick must be >= 1 "
                "(ticks are counted from 1).")
        leg = kv.get("leg", "classic")
        if leg not in _CORRUPT_LEGS:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: leg must be one of "
                f"{'|'.join(_CORRUPT_LEGS)}, got {leg!r}.")
        if kv.get("count", 1) <= 0:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: count must be >= 1.")
        return FaultSpec("corrupt", kv["rank"], kv["tick"], 0, leg,
                         kv.get("count", 1))
    if len(parts) != 3 or parts[0] not in _FAULT_MODES:
        raise ValueError(
            f"Malformed HOROVOD_TPU_FAULT {spec!r}: expected "
            "'<crash|hang|drop_conn|rejoin>:rank=<R>:tick=<T>', "
            "'crash_in_save:rank=<R>:epoch=<E>', "
            "'corrupt_ckpt:rank=<R>:epoch=<E>', "
            "'corrupt:rank=<R>:tick=<T>[:leg=<L>][:count=<N>]' or "
            "'slow:rank=<R>:ms=<M>[:tick=<T>]'.")
    when_key = ("epoch" if parts[0] in ("crash_in_save", "corrupt_ckpt")
                else "tick")
    kv = {}
    for part in parts[1:]:
        key, sep, val = part.partition("=")
        if not sep or key not in ("rank", when_key) or key in kv:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: expected "
                f"'{parts[0]}:rank=<R>:{when_key}=<N>'.")
        try:
            kv[key] = int(val)
        except ValueError:
            raise ValueError(
                f"Malformed HOROVOD_TPU_FAULT {spec!r}: {key!r} must be an "
                f"integer, got {val!r}.") from None
    if "rank" not in kv or when_key not in kv:
        raise ValueError(
            f"Malformed HOROVOD_TPU_FAULT {spec!r}: both rank= and "
            f"{when_key}= are required.")
    if kv["rank"] < 0:
        raise ValueError(
            f"Malformed HOROVOD_TPU_FAULT {spec!r}: rank must be >= 0.")
    if when_key == "tick" and kv["tick"] <= 0:
        raise ValueError(
            f"Malformed HOROVOD_TPU_FAULT {spec!r}: tick must be >= 1 "
            "(ticks are counted from 1).")
    if when_key == "epoch" and kv["epoch"] < 0:
        raise ValueError(
            f"Malformed HOROVOD_TPU_FAULT {spec!r}: epoch must be >= 0.")
    return FaultSpec(parts[0], kv["rank"], kv[when_key])


def parse_fault_specs(value: str) -> List[FaultSpec]:
    """Parse a full HOROVOD_TPU_FAULT value: one spec, or several separated
    by ';' (elastic scenarios script a kill and a later readmit together,
    e.g. ``crash:rank=1:tick=30;rejoin:rank=0:tick=60``)."""
    out: List[FaultSpec] = []
    for piece in (value or "").split(";"):
        parsed = parse_fault_spec(piece)
        if parsed is not None:
            out.append(parsed)
    return out


# --------------------------------------------------------------------------
# Wire message equivalents (reference horovod/common/mpi_message.{h,cc})
# --------------------------------------------------------------------------

class RequestType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ERROR = 3


_REQUEST_TYPE_NAME = {
    RequestType.ALLREDUCE: "ALLREDUCE",
    RequestType.ALLGATHER: "ALLGATHER",
    RequestType.BROADCAST: "BROADCAST",
}


def request_type_name(t: RequestType) -> str:
    return _REQUEST_TYPE_NAME.get(t, "<unknown>")


def dtype_name(dtype) -> str:
    """numpy-style dtype names match the reference's MPIDataType_Name
    (``mpi_message.cc:24-60``): uint8, int8, ..., float32, float64, bool;
    a torch dtype gives the same name (``torch.bfloat16``: bfloat16)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".", 1)[1]
    return np.dtype(dtype).name


def dtype_itemsize(name: str) -> int:
    """Bytes of one element of the dtype called ``name`` (numpy's names,
    and torch's for what numpy lacks, such as bfloat16); 0 when neither
    knows it."""
    try:
        return np.dtype(name).itemsize
    except TypeError:
        t = getattr(torch, name, None)
        return t.itemsize if isinstance(t, torch.dtype) else 0


def shape_debug_string(shape: Sequence[int]) -> str:
    """Format parity with ``TensorShape::DebugString`` (common.cc)."""
    return "[" + ", ".join(str(d) for d in shape) + "]"


def normalize_wire_dtype(wire_dtype: str) -> str:
    """Canonicalize a wire-compression name; raises on unknown names.

    Delegates to the shared canonicalizer in
    :mod:`horovod_tpu_torch.compression` so the eager ring and the in-jit
    plane accept the same names with the same rejection message."""
    from horovod_tpu_torch.compression import canonical_wire_dtype
    return canonical_wire_dtype(wire_dtype, source="wire dtype")


def default_wire_dtype() -> str:
    """Process-wide ring compression default from HOROVOD_TPU_WIRE_DTYPE
    ("" when unset → raw fp32 wire)."""
    from horovod_tpu_torch.compression import canonical_wire_dtype
    return canonical_wire_dtype(
        os.environ.get("HOROVOD_TPU_WIRE_DTYPE", ""),
        source="HOROVOD_TPU_WIRE_DTYPE")


# Canonical allreduce algorithm names.  "" = flat ring (the canonical form
# of "ring"); "hier" = two-level hierarchical; "small" = latency-optimal
# small-tensor path; "auto" = coordinator picks per payload (request-side
# only — responses always carry a resolved concrete algorithm).  Mirrors
# ResolveAlgo in cpp/htpu/message_table.cc.
_ALGO_ALIASES = {
    "": "", "ring": "", "flat": "",
    "hier": "hier", "hierarchical": "hier",
    "small": "small", "latency": "small",
    "auto": "auto",
}

# Payload size at/below which "auto" picks the small-tensor path
# (kDefaultAlgoCrossoverBytes, cpp/htpu/message_table.h); override with
# HOROVOD_TPU_ALLREDUCE_CROSSOVER, measure with `bench.py --tcp-allreduce`.
DEFAULT_ALGO_CROSSOVER_BYTES = 64 * 1024


def normalize_allreduce_algo(algo: str) -> str:
    """Canonicalize an allreduce algorithm name; raises on unknown names."""
    key = (algo or "").strip().lower()
    if key not in _ALGO_ALIASES:
        raise ValueError(
            f"Unknown allreduce algorithm {algo!r}: expected one of "
            "ring, hier, small, auto.")
    return _ALGO_ALIASES[key]


def default_allreduce_algo() -> str:
    """Process-wide allreduce algorithm preference from
    HOROVOD_TPU_ALLREDUCE_ALGO ("auto" when unset/empty)."""
    raw = os.environ.get("HOROVOD_TPU_ALLREDUCE_ALGO", "").strip()
    return "auto" if not raw else normalize_allreduce_algo(raw)


def algo_crossover_bytes() -> int:
    """Small-path crossover from HOROVOD_TPU_ALLREDUCE_CROSSOVER (bytes);
    malformed/negative values fall back to the default — same leniency as
    the native parser in control.cc."""
    raw = os.environ.get("HOROVOD_TPU_ALLREDUCE_CROSSOVER", "")
    try:
        v = int(raw)
        return v if v >= 0 else DEFAULT_ALGO_CROSSOVER_BYTES
    except ValueError:
        return DEFAULT_ALGO_CROSSOVER_BYTES


@dataclasses.dataclass
class Request:
    """One rank's announcement that a named tensor is ready
    (reference ``MPIRequest``, ``mpi_message.h``)."""
    request_rank: int
    request_type: RequestType
    tensor_name: str
    tensor_type: str                       # numpy dtype name
    tensor_shape: Tuple[int, ...]
    root_rank: int = -1
    device: int = -1                       # global device rank (or -1 host)
    # Requested ring wire compression ("" = raw fp32; "bf16"/"fp16"/"int8"
    # — cpp/htpu/quantize.h).  Validated across ranks like tensor_type.
    wire_dtype: str = ""
    # Requested allreduce algorithm preference ("" = ring, "hier", "small",
    # or "auto" for coordinator selection).  Validated across ranks like
    # wire_dtype; resolved to a concrete algorithm in the response.
    algo: str = ""
    # Process set this request negotiates in (0 = the default/world set).
    # Non-default sets carry SET-LOCAL request_rank (device stays the
    # global rank) and route to that set's message table.  Serialized only
    # when the enclosing list sets FLAG_SET_EXT.
    process_set: int = 0


@dataclasses.dataclass
class Response:
    """Coordinator's instruction to execute (possibly fused) collectives
    (reference ``MPIResponse``)."""
    response_type: ResponseType
    tensor_names: List[str]
    error_message: str = ""
    devices: List[int] = dataclasses.field(default_factory=list)
    # For allgather: dim0 size contributed by each rank, indexed by rank
    # (reference mpi_message.h tensor_sizes).
    tensor_sizes: List[int] = dataclasses.field(default_factory=list)
    # Negotiated wire compression (uniform across ranks by validation);
    # fusion only merges responses with equal wire dtypes.
    wire_dtype: str = ""
    # Resolved allreduce algorithm ("" = ring, "hier", "small" — never
    # "auto"); fusion only merges responses with equal algorithms, and the
    # response cache replays the resolution byte-exactly.
    algo: str = ""
    # Process set this response belongs to (0 = default/world).  Receivers
    # only pop entries whose process_set matches, so two tenants reusing a
    # tensor name never cross-execute.  Serialized only under FLAG_SET_EXT.
    process_set: int = 0


# --------------------------------------------------------------------------
# Message table: negotiation + cross-rank validation
# --------------------------------------------------------------------------

class MessageTable:
    """Tracks per-tensor readiness across ranks (coordinator side).

    Mirrors ``IncrementTensorCount`` / ``ConstructMPIResponse``
    (``operations.cc:282-517``) including error-message text.
    """

    def __init__(self, size: int, timeline=None):
        self._size = size
        self._table: Dict[str, Tuple[List[Request], float]] = {}
        self._timeline = timeline
        # Allreduce algorithm-selection inputs (configure_algo_selection);
        # defaults describe a single-host, single-process job, under which
        # "auto" resolves to small/ring only.
        self._algo_num_hosts = 1
        self._algo_num_procs = 1
        self._algo_crossover = DEFAULT_ALGO_CROSSOVER_BYTES

    def __len__(self):
        return len(self._table)

    def configure_algo_selection(self, num_hosts: int, num_procs: int,
                                 crossover_bytes: int) -> None:
        """Topology + crossover inputs for allreduce algorithm resolution
        (mirrors MessageTable::ConfigureAlgoSelection, message_table.cc)."""
        self._algo_num_hosts = max(1, num_hosts)
        self._algo_num_procs = max(1, num_procs)
        self._algo_crossover = max(0, crossover_bytes)

    def _resolve_algo(self, pref: str, nbytes: int) -> str:
        """Concrete algorithm for one allreduce (ResolveAlgo parity):
        explicit preferences pass through; "auto" picks the small path at or
        below the crossover, the hierarchical path when the job spans
        multiple hosts with co-located processes, else the flat ring."""
        from horovod_tpu_torch import scheduler as _scheduler
        return _scheduler.resolve_algo(
            pref, nbytes, self._algo_num_hosts, self._algo_num_procs,
            self._algo_crossover)

    def clear(self):
        self._table.clear()

    def increment(self, msg: Request) -> bool:
        """Record one rank's request; True when all ranks have reported."""
        name = msg.tensor_name
        entry = self._table.get(name)
        if entry is None:
            self._table[name] = ([msg], time.monotonic())
            if self._timeline:
                self._timeline.negotiate_start(name, msg.request_type)
        else:
            entry[0].append(msg)
        if self._timeline:
            self._timeline.negotiate_rank_ready(name, msg.request_rank)
        ready = len(self._table[name][0]) == self._size
        if ready and self._timeline:
            self._timeline.negotiate_end(name)
        return ready

    def pending_names_older_than(
            self, age_s: float) -> List[Tuple[str, float, List[int]]]:
        """(name, age_s, missing_ranks) for entries older than ``age_s`` —
        the stall detector's input (``CheckForStalledTensors``,
        ``operations.cc:1366-1412``).  Same record shape as the native
        table's stall report (cpp/htpu/message_table.h StallInfo)."""
        now = time.monotonic()
        out = []
        for name, (reqs, t0) in self._table.items():
            if now - t0 > age_s:
                have = {r.request_rank for r in reqs}
                missing = [r for r in range(self._size) if r not in have]
                out.append((name, now - t0, missing))
        return out

    def construct_response(self, name: str) -> Response:
        """Validate all ranks' requests for ``name`` and build the response.

        Validation order and error text mirror ``ConstructMPIResponse``
        (``operations.cc:315-517``): dtype, op, shape (allreduce/broadcast),
        allgather rank/ dims, broadcast root rank.
        """
        requests, _ = self._table[name]
        assert requests
        error = None

        data_type = requests[0].tensor_type
        for r in requests[1:]:
            if r.tensor_type != data_type:
                error = (f"Mismatched data types: One rank had type {data_type}, "
                         f"but another rank had type {r.tensor_type}.")
                break

        # Wire compression must be uniform too: the ring's hops re-encode
        # with the negotiated wire dtype, so disagreeing ranks would desync
        # the byte stream.  Same coordinated-error style as the dtype check.
        if error is None:
            wire0 = requests[0].wire_dtype
            for r in requests[1:]:
                if r.wire_dtype != wire0:
                    error = ("Mismatched wire compression: One rank requested "
                             f"wire dtype {wire0 or 'fp32'}, but another rank "
                             f"requested wire dtype {r.wire_dtype or 'fp32'}.")
                    break

        # The allreduce algorithm must be uniform for the same reason: hop
        # schedules differ per algorithm, so disagreeing ranks would
        # deadlock the data plane.  Coordinated error, like wire dtype.
        if error is None:
            algo0 = requests[0].algo
            for r in requests[1:]:
                if r.algo != algo0:
                    error = ("Mismatched allreduce algorithm: One rank "
                             f"requested algorithm {algo0 or 'ring'}, but "
                             "another rank requested algorithm "
                             f"{r.algo or 'ring'}.")
                    break

        message_type = requests[0].request_type
        if error is None:
            for r in requests[1:]:
                if r.request_type != message_type:
                    error = ("Mismatched MPI operations: One rank did an "
                             f"{request_type_name(message_type)}, but another "
                             f"rank did an {request_type_name(r.request_type)}.")
                    break

        if error is None and message_type in (RequestType.ALLREDUCE,
                                              RequestType.BROADCAST):
            shape0 = requests[0].tensor_shape
            for r in requests[1:]:
                if r.tensor_shape != shape0:
                    error = (f"Mismatched {request_type_name(message_type)} "
                             "tensor shapes: One rank sent a tensor of shape "
                             f"{shape_debug_string(shape0)}, but another rank "
                             "sent a tensor of shape "
                             f"{shape_debug_string(r.tensor_shape)}.")
                    break

        tensor_sizes = [0] * len(requests)
        if error is None and message_type == RequestType.ALLGATHER:
            shape0 = requests[0].tensor_shape
            if len(shape0) == 0:
                error = (f"Rank zero tried to {request_type_name(message_type)} "
                         "a rank-zero tensor.")
            else:
                tensor_sizes[requests[0].request_rank] = shape0[0]
                for r in requests[1:]:
                    shp = r.tensor_shape
                    if len(shp) != len(shape0):
                        error = (f"Mismatched {request_type_name(message_type)} "
                                 "tensor shapes: One rank sent a tensor of rank "
                                 f"{len(shape0)}, but another rank sent a tensor "
                                 f"of rank {len(shp)}.")
                        break
                    dim_mismatch = False
                    for dim in range(1, len(shape0)):
                        if shape0[dim] != shp[dim]:
                            error = (
                                f"Mismatched {request_type_name(message_type)} "
                                f"tensor shapes: One rank sent a tensor with "
                                f"dimension {dim} equal to {shape0[dim]}, but "
                                f"another rank sent a tensor with dimension "
                                f"{dim} equal to {shp[dim]}.")
                            dim_mismatch = True
                            break
                    if dim_mismatch:
                        break
                    tensor_sizes[r.request_rank] = shp[0]

        if error is None and message_type == RequestType.BROADCAST:
            root0 = requests[0].root_rank
            for r in requests[1:]:
                if r.root_rank != root0:
                    error = (f"Mismatched {request_type_name(message_type)} "
                             f"root ranks: One rank specified root rank "
                             f"{root0}, but another rank specified root rank "
                             f"{r.root_rank}.")
                    break

        # Device-placement consistency: every rank must agree on host (-1)
        # vs accelerator placement, mirroring the CPU-vs-GPU check in
        # ConstructMPIResponse (reference operations.cc:470-487).  The text
        # is the JAX package's and the native table's, byte for byte.
        if error is None:
            first_is_host = requests[0].device < 0
            for r in requests[1:]:
                this_is_host = r.device < 0
                if this_is_host != first_is_host:
                    error = (f"Mismatched {request_type_name(message_type)} "
                             "CPU/TPU device selection: One rank specified "
                             f"device {'CPU' if first_is_host else 'TPU'}, "
                             "but another rank specified device "
                             f"{'CPU' if this_is_host else 'TPU'}.")
                    break

        devices = [0] * len(requests)
        for r in requests:
            devices[r.request_rank] = r.device

        del self._table[name]

        wire_dtype = requests[0].wire_dtype
        if error is not None:
            return Response(ResponseType.ERROR, [name], error_message=error,
                            devices=devices, wire_dtype=wire_dtype)
        if message_type == RequestType.ALLGATHER:
            return Response(ResponseType.ALLGATHER, [name],
                            tensor_sizes=tensor_sizes, devices=devices,
                            wire_dtype=wire_dtype)
        if message_type == RequestType.ALLREDUCE:
            # Resolve the (uniform) preference to a concrete algorithm by
            # this payload's size — the data plane never sees "auto".
            nbytes = dtype_itemsize(data_type)
            for d in requests[0].tensor_shape:
                nbytes *= d
            return Response(ResponseType.ALLREDUCE, [name], devices=devices,
                            wire_dtype=wire_dtype,
                            algo=self._resolve_algo(requests[0].algo, nbytes))
        return Response(ResponseType.BROADCAST, [name], devices=devices,
                        wire_dtype=wire_dtype)


# --------------------------------------------------------------------------
# Fusion planner (reference operations.cc:1807-1842)
# --------------------------------------------------------------------------

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024   # bytes (operations.cc:151)
FUSION_BUFFER_ATOMIC_UNIT = 64                # bytes (operations.h:48-50)


def plan_fusion(responses: List[Response],
                entry_bytes: Callable[[str], int],
                entry_dtype: Callable[[str], str],
                threshold: int) -> List[Response]:
    """Greedily merge consecutive ALLREDUCE responses of the same dtype while
    the combined payload stays ≤ ``threshold`` bytes.

    Mirrors the coordinator's fusion loop (``operations.cc:1807-1842``):
    only allreduces fuse; a threshold of 0 disables fusion.
    """
    fused: List[Response] = []
    i = 0
    while i < len(responses):
        r = responses[i]
        if r.response_type != ResponseType.ALLREDUCE or threshold <= 0:
            fused.append(r)
            i += 1
            continue
        names = list(r.tensor_names)
        total = sum(entry_bytes(n) for n in names)
        dtype = entry_dtype(names[0])
        j = i + 1
        while j < len(responses):
            nxt = responses[j]
            if nxt.response_type != ResponseType.ALLREDUCE:
                break
            nbytes = sum(entry_bytes(n) for n in nxt.tensor_names)
            if entry_dtype(nxt.tensor_names[0]) != dtype:
                break
            # A fused buffer rides the ring as one payload with one wire
            # format — only merge entries that negotiated the same one.
            if nxt.wire_dtype != r.wire_dtype:
                break
            # Likewise one collective algorithm per fused payload: the
            # data plane walks a single hop schedule for the whole buffer.
            if nxt.algo != r.algo:
                break
            if total + nbytes > threshold:
                break
            names.extend(nxt.tensor_names)
            total += nbytes
            j += 1
        fused.append(Response(ResponseType.ALLREDUCE, names,
                              devices=r.devices, wire_dtype=r.wire_dtype,
                              algo=r.algo))
        i = j
    return fused


# --------------------------------------------------------------------------
# Handle manager (reference horovod/torch/handle_manager.{h,cc})
# --------------------------------------------------------------------------

DEFAULT_OP_TIMEOUT_S = 600.0


def default_op_timeout() -> Optional[float]:
    """Deadline for HandleManager.wait when the caller passes no timeout
    (HOROVOD_TPU_OP_TIMEOUT_S; <= 0 restores the old infinite wait)."""
    t = float(os.environ.get("HOROVOD_TPU_OP_TIMEOUT_S",
                             str(DEFAULT_OP_TIMEOUT_S)))
    return t if t > 0 else None


class HandleManager:
    """Thread-safe int-handle → Status map for async ops."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next = 0
        self._results: Dict[int, Optional[Tuple[Status, object]]] = {}
        # Handles whose payload may launch collectives on the shared NCCL
        # world group -- the set the ordering guard counts.
        self._mesh_hazard: set = set()
        # Op name per live handle, for wait-timeout diagnostics.
        self._names: Dict[int, str] = {}

    def allocate(self, mesh_hazard: bool = False, name: str = "") -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = None
            if mesh_hazard:
                self._mesh_hazard.add(h)
            if name:
                self._names[h] = name
            return h

    def mark_done(self, handle: int, status: Status, result=None) -> None:
        with self._cv:
            # No-op for unknown handles — covers results arriving after the
            # caller abandoned a timed-out handle.
            if handle in self._results:
                self._results[handle] = (status, result)
                self._mesh_hazard.discard(handle)
                self._cv.notify_all()

    def abandon(self, handle: int) -> None:
        """Give up on a handle: drop it now; a completion arriving later
        hits the unknown-handle no-op in ``mark_done`` and is discarded."""
        with self._lock:
            self._results.pop(handle, None)
            self._mesh_hazard.discard(handle)
            self._names.pop(handle, None)

    def poll(self, handle: int) -> bool:
        with self._lock:
            self._check_known(handle)
            return self._results[handle] is not None

    def wait(self, handle: int, timeout: Optional[float] = None):
        """Block until the handle completes.

        ``timeout=None`` no longer means "wait forever": it resolves to the
        HOROVOD_TPU_OP_TIMEOUT_S deadline (default 600 s; <= 0 restores the
        infinite wait).  On that default deadline the handle is ABANDONED
        (a late completion is discarded by mark_done's unknown-handle
        no-op) and a TimeoutError naming the op is raised — a wedged
        collective surfaces as a diagnosable error instead of a silent
        hang.  An explicit caller-supplied timeout keeps the old contract:
        TimeoutError without abandoning, so the caller decides.
        """
        abandon_on_timeout = False
        if timeout is None:
            timeout = default_op_timeout()
            abandon_on_timeout = timeout is not None
        t0 = time.monotonic()
        try:
            with self._cv:
                self._check_known(handle)
                if not self._cv.wait_for(
                        lambda: self._results[handle] is not None, timeout):
                    name = self._names.get(handle, "")
                    op = f" (op '{name}')" if name else ""
                    # Capture the last N ticks of control/transport events
                    # before abandoning: a wedged collective is exactly the
                    # moment post-hoc state is needed and live inspection is
                    # impossible.
                    from horovod_tpu_torch import cpp_core
                    cpp_core.flight_record("op.timeout", name, 0, handle,
                                           int(timeout or 0))
                    flight = cpp_core.flight_dump("op_timeout")
                    flight_note = (f" [flight recorder: {flight}]"
                                   if flight else "")
                    if abandon_on_timeout:
                        self._results.pop(handle, None)
                        self._mesh_hazard.discard(handle)
                        self._names.pop(handle, None)
                        raise TimeoutError(
                            f"handle {handle}{op} did not complete within "
                            f"{timeout:.0f}s (HOROVOD_TPU_OP_TIMEOUT_S); the "
                            "handle has been abandoned. A peer rank likely "
                            "never submitted this collective — check for "
                            "stall warnings on rank 0." + flight_note)
                    raise TimeoutError(
                        f"handle {handle}{op} did not complete" + flight_note)
                return self._results[handle]
        finally:
            # Time-to-result from the framework thread's point of view —
            # recorded on timeouts too, so stalls show in the tail.
            _metrics.registry.observe("controller.handle_wait_seconds",
                                      time.monotonic() - t0)

    def release(self, handle: int):
        with self._lock:
            self._results.pop(handle, None)
            self._mesh_hazard.discard(handle)
            self._names.pop(handle, None)

    def outstanding(self) -> int:
        """Handles allocated but not yet completed (still in flight)."""
        with self._lock:
            return sum(1 for v in self._results.values() if v is None)

    def outstanding_mesh_hazard(self) -> int:
        """In-flight handles flagged as possibly launching collectives on
        the shared NCCL world group (host-path ops are excluded: they ride
        the TCP ring and never touch that group)."""
        with self._lock:
            return sum(1 for h in self._mesh_hazard
                       if self._results.get(h) is None)

    def _check_known(self, handle: int):
        if handle not in self._results:
            raise ValueError(f"unknown handle: {handle}")


# --------------------------------------------------------------------------
# Tensor table entry + controller
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TensorTableEntry:
    """Tensor data + callback held while a collective is in flight
    (reference ``TensorTableEntry``, ``operations.cc:60-100``)."""
    name: str
    request_type: RequestType
    # One contribution per participating rank this process controls: one
    # tensor, as the port runs one rank per process.
    per_rank: List[torch.Tensor]
    dtype: str
    root_rank: int
    average: bool
    callback: Callable[[Status, object], None]
    # Ring wire compression for the cross-process data plane ("" = raw
    # fp32; "bf16"/"fp16"/"int8").  Negotiated across ranks like dtype.
    wire_dtype: str = ""
    # Process set this entry negotiates in (0 = default/world).
    process_set: int = 0
    # CUDA event recorded on the caller's stream at enqueue when that is
    # not the device's default stream; the executor waits on it before it
    # reads the tensors.
    ready_event: Optional[object] = None


def cache_capacity_from_env() -> int:
    """HOROVOD_TPU_CACHE_CAPACITY: response-cache slots (default 1024;
    0 disables the cache entirely).  Malformed values fall back to the
    default — same leniency as the native parser in control.cc."""
    raw = os.environ.get("HOROVOD_TPU_CACHE_CAPACITY", "")
    try:
        v = int(raw)
        return v if v >= 0 else 1024
    except ValueError:
        return 1024


class _LocalResponseCache:
    """Single-process half of the negotiation response cache.

    The multi-process cache lives inside the native control plane
    (cpp/htpu: bitvector ticks on the wire); this class gives the local
    loop the same skip: a tick whose pending request batch serializes
    byte-identically to an earlier fully-successful tick replays that
    tick's fused responses without touching the MessageTable or the
    fusion planner.  Replay is bit-identical by construction — the stored
    responses ARE the ones the uncached path built, handed out as fresh
    copies.  Shape / dtype / wire-dtype changes alter the serialized
    batch, so they miss naturally and the stale entry ages out by LRU.
    """

    # Full response sets kept per distinct batch shape; small — steady
    # training loops replay one or two shapes (matches the native client's
    # cache_set_ bound).
    MAX_SETS = 16

    def __init__(self, capacity: int):
        self.capacity = capacity
        # name -> serialized request group (byte-exact per-name hit test,
        # LRU-bounded by `capacity` for knob parity with the native cache).
        self._names: "collections.OrderedDict[str, bytes]" = \
            collections.OrderedDict()
        # batch key -> fused response list of the tick that negotiated it.
        self._sets: "collections.OrderedDict[bytes, List[Response]]" = \
            collections.OrderedDict()

    @staticmethod
    def _batch_key(pending: List[Request]) -> bytes:
        from horovod_tpu_torch import wire
        # with_algo so an algorithm-preference change misses (and the
        # replayed responses keep their resolved algo) — matches the
        # native cache's signature (control.cc CompressRequestFrame).
        return b"".join(
            wire.serialize_request(r, with_algo=True) for r in pending)

    def _account(self, pending: List[Request]) -> None:
        """Per-name hit/miss/eviction metrics, mirroring the native
        counters (control.cache_hits / _misses / _evictions)."""
        from horovod_tpu_torch import wire
        groups: "collections.OrderedDict[str, bytes]" = \
            collections.OrderedDict()
        for r in pending:
            groups[r.tensor_name] = (groups.get(r.tensor_name, b"")
                                     + wire.serialize_request(
                                         r, with_algo=True))
        hits = misses = 0
        for name, sig in groups.items():
            if self._names.get(name) == sig:
                hits += 1
                self._names.move_to_end(name)
            else:
                misses += 1
                self._names[name] = sig
                self._names.move_to_end(name)
        evicted = 0
        while len(self._names) > self.capacity:
            self._names.popitem(last=False)
            evicted += 1
        _metrics.registry.inc("control.cache_hits", hits)
        _metrics.registry.inc("control.cache_misses", misses)
        if evicted:
            _metrics.registry.inc("control.cache_evictions", evicted)

    def lookup(self, pending: List[Request],
               table_empty: bool) -> Optional[List[Response]]:
        """Fused responses to replay for this batch, or None to negotiate
        in full.  Replay requires an empty message table: a stored set
        only equals the uncached result when no straggler from an earlier
        tick could have contributed to it."""
        if self.capacity <= 0 or not pending:
            return None
        self._account(pending)
        if not table_empty:
            return None
        stored = self._sets.get(self._batch_key(pending))
        if stored is None:
            return None
        self._sets.move_to_end(self._batch_key(pending))
        return [dataclasses.replace(
                    r, tensor_names=list(r.tensor_names),
                    devices=list(r.devices),
                    tensor_sizes=list(r.tensor_sizes))
                for r in stored]

    def store(self, pending: List[Request], fused: List[Response]) -> None:
        """Record a fully-successful tick (every pending name constructed,
        no ERROR responses, table drained) for later replay."""
        if self.capacity <= 0:
            return
        key = self._batch_key(pending)
        self._sets[key] = [dataclasses.replace(
                               r, tensor_names=list(r.tensor_names),
                               devices=list(r.devices),
                               tensor_sizes=list(r.tensor_sizes))
                           for r in fused]
        self._sets.move_to_end(key)
        while len(self._sets) > self.MAX_SETS:
            self._sets.popitem(last=False)

    def flush(self) -> None:
        """Abort/restart: drop everything (counted as evictions, like the
        native cache's flush)."""
        if self._names:
            _metrics.registry.inc("control.cache_evictions",
                                  len(self._names))
        self._names.clear()
        self._sets.clear()


# The native abort text of a process the elastic coordinator left out of
# a new generation (control.cc ApplyReconfigure).
EVICTED_PREFIX = "evicted from the membership at generation "

# The share of a tick's time at the coordinator (its wait for the other
# processes and the round trip) that counts against the next tick's cycle
# in the multi-process loop; see ``_background_loop_distributed``.
TICK_PHASE_PULL = 0.5


class Controller:
    """Per-process background controller.

    Owns: message queue (framework threads push), tensor table, message
    table (negotiation), fusion planner, stall checker, timeline, handle
    manager, and the data-plane executor.  One daemon thread runs
    ``_run_loop_once`` every ``cycle_time`` -- the reference's
    ``RunLoopOnce`` tick (``operations.cc:1694-1903``).

    ``device_kind`` is the job's device type (``"cuda"``: the NCCL world
    group carries the payload of CUDA tensors; ``"cpu"``: the native TCP
    ring carries it).  :meth:`bind_device` names this process's device
    before :meth:`start`; the controller is built before it, because its
    host discovery decides ``local_rank`` and with it the GPU.
    """

    def __init__(self, topology, device_kind: str = "cpu"):
        self.topology = topology
        self.size = topology.size
        self.cycle_time_s = float(
            os.environ.get("HOROVOD_TPU_CYCLE_TIME_MS", "1.0")) / 1e3
        # When the coordinator's response to the last tick arrived: every
        # process receives it at about the same moment, so the
        # multi-process loop paces its next tick from it.
        self._response_at = 0.0
        self.fusion_threshold = int(
            os.environ.get("HOROVOD_TPU_FUSION_THRESHOLD",
                           str(DEFAULT_FUSION_THRESHOLD)))
        self.stall_warning_time_s = 60.0
        self.stall_check_disabled = env_flag(
            "HOROVOD_TPU_STALL_CHECK_DISABLE")

        # Fail fast on malformed fault specs: the native core parses the
        # same variable leniently (warn + ignore), which would make a typo'd
        # injection test silently pass.  The parsed specs are kept for the
        # Python-owned injections (the local loop's `slow` straggler).
        self._fault_specs = parse_fault_specs(
            os.environ.get("HOROVOD_TPU_FAULT", ""))
        self._fault_tick = 0
        self._slow_announced: set = set()

        # Native core (cpp/htpu): message table, fusion planner and timeline
        # run in C++ when the shared library is available; the Python classes
        # above remain the executable specification and fallback.
        from horovod_tpu_torch import cpp_core
        self._use_cpp = cpp_core.available()

        # Multi-process mode: negotiation + eager data plane ride the native
        # TCP control plane (reference: MPI gather/bcast + CPU data plane).
        self._control = None
        self._rank_to_process: Dict[int, int] = {}
        # The membership generation the controller adopted last (elastic
        # only): published after rank()/size() report the new world, for
        # elastic.generation().
        self._adopted_generation: Optional[int] = None
        # The generation the training code runs in (``run_elastic`` sets
        # it at each entry of ``train``; None outside it), and the status
        # of the last reconfigure: a collective submitted from an older
        # generation completes with it at once (see enqueue).
        self.expected_generation: Optional[int] = None
        self._reconfigure_status: Optional[Status] = None
        # Host grouping (None = not discovered; single-process jobs don't
        # need it).
        self.host_local_rank: Optional[int] = None
        self.host_local_size: Optional[int] = None
        # Host fingerprint of each global rank (the layout exchange's):
        # a process set must sit on one host.
        self._rank_host: Dict[int, str] = {}
        # Distinct host count across the job (refined by the layout
        # exchange below); feeds allreduce algorithm selection.
        self.num_hosts = 1
        coord_addr = os.environ.get("HOROVOD_TPU_COORD_ADDR", "")
        # Multi-process job with no control plane configured: jit-only
        # mode.  The in-step path needs no negotiation (torch.distributed
        # carries its collectives); the eager API is unavailable and fails
        # fast at enqueue() instead of stall-deadlocking.
        self.jit_only = topology.process_count > 1 and not coord_addr
        if coord_addr and topology.process_count > 1:
            if not self._use_cpp:
                raise RuntimeError(
                    "multi-process mode requires the native core "
                    "(unset HOROVOD_TPU_NO_CPP)")
            host, _, port = coord_addr.rpartition(":")
            timeout_ms = int(float(os.environ.get(
                "HOROVOD_TPU_CONTROL_TIMEOUT_S", "60")) * 1000)
            self._control = cpp_core.CppControlPlane(
                topology.process_index, topology.process_count,
                host or "127.0.0.1", int(port), topology.rank,
                topology.size, timeout_ms)
            if (os.environ.get("HOROVOD_TPU_STANDBY") == "1"
                    and self._control.elastic()):
                # Admitted standby (reference core.py:1097-1121): the
                # native Create() blocked until the elastic coordinator
                # seated this process into a live generation -- adopt the
                # identity it assigned.  The layout exchange below is
                # impossible here (the survivors are mid-training), so
                # the rank map is the dense re-rank arithmetic.
                pidx, pcount, first_rank, generation = (
                    self._control.membership())
                topology = dataclasses.replace(topology, rank=first_rank,
                                               size=pcount)
                self.topology = topology
                self.size = topology.size
                for r in range(pcount):
                    self._rank_to_process[r] = r
                self._adopted_generation = generation
                _metrics.registry.set_gauge("membership.generation",
                                            generation)
                print(f"horovod_tpu elastic: standby admitted at "
                      f"generation {generation} as rank {first_rank} "
                      f"of {topology.size} (process {pidx} of {pcount})",
                      file=sys.stderr)
            else:
                self._exchange_layout()
        elif self.jit_only:
            self._discover_hosts_over_store()

        self.timeline = None
        timeline_path = os.environ.get("HOROVOD_TPU_TIMELINE", "")
        if timeline_path:
            # Every rank traces; the env value is a path template -- resolve
            # this rank's file from it.
            from horovod_tpu_torch.timeline import per_rank_trace_path
            rank_path = per_rank_trace_path(
                timeline_path, topology.rank, topology.size)
            if self._use_cpp:
                self.timeline = cpp_core.CppTimeline(
                    rank_path, topology.rank)
            else:
                from horovod_tpu_torch.timeline import Timeline
                self.timeline = Timeline(rank_path, topology.rank)
        if (self._control is not None and self.timeline is not None
                and hasattr(self.timeline, "attach_to_control")):
            # Multi-process mode negotiates inside the C++ coordinator;
            # wire the native timeline in so NEGOTIATE_* spans (with
            # per-rank ready instants) appear exactly as in the
            # single-process mode.
            self.timeline.attach_to_control(self._control)
        if self.timeline is not None:
            # Durability guard: a process that dies without shutdown()
            # still gets its trace closed into loadable JSON.  close() is
            # idempotent, so the normal stop() path is unaffected.
            import atexit
            atexit.register(self._close_timeline)

        self.handle_manager = HandleManager()
        # Both planners route through the plane-agnostic scheduler's
        # per-tick policy (fusion + first-ready issue order).
        if self._use_cpp:
            self._message_table = cpp_core.CppMessageTable(
                self.size, self.timeline)
            self._plan_fusion = cpp_core.cpp_plan_tick
        else:
            self._message_table = MessageTable(self.size, self.timeline)
            from horovod_tpu_torch import scheduler as _scheduler
            self._plan_fusion = _scheduler.plan_tick
        # Topology + crossover for "auto" algorithm resolution.  The native
        # control plane configures its own internal table the same way
        # (control.cc Create); this covers the local negotiation loop.
        self._message_table.configure_algo_selection(
            self.num_hosts, topology.process_count, algo_crossover_bytes())
        # Response cache for the single-process negotiation loop.  The
        # multi-process equivalent lives inside the native control plane's
        # Tick (bitvector wire ticks), so the Python cache stays off there
        # -- the two never double-count metrics.
        self._local_cache = None
        if self._control is None and not self.jit_only:
            capacity = cache_capacity_from_env()
            if capacity > 0:
                self._local_cache = _LocalResponseCache(capacity)
        # Non-default process sets (multi-tenant negotiation namespaces):
        # the registry owns each set's scoped MessageTable + cache; the
        # controller only routes by ``entry.process_set``.  Seeded from
        # HOROVOD_TPU_PROCESS_SETS so ids agree with the native
        # coordinator, which parses the same spec (control.cc Create).
        from horovod_tpu_torch import process_set as _process_set_mod
        self._process_sets = _process_set_mod.registry()
        self._tensor_table: Dict[str, TensorTableEntry] = {}
        self._message_queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False      # start() ran: the first enqueue may
        #                            start the local loop
        self._last_stall_check = time.monotonic()
        # Stall-warning dedupe: name -> frozenset(missing ranks) at the
        # last warning.
        self._stall_warned: Dict[str, frozenset] = {}
        # Last timeline counter-track values -- counter events are emitted
        # only on change so idle ticks don't bloat the trace.
        self._last_counters: Dict[str, int] = {}
        # Job-wide abort latch.  Once set, every outstanding handle has
        # completed with this ABORTED status and enqueue() fails fast with
        # the same attributed cause.
        self._abort_status: Optional[Status] = None
        # Failure observed locally (native data-plane error) waiting to ride
        # the next tick's request list to the coordinator, which turns it
        # into the job-wide ABORT broadcast.
        self._pending_report: Optional[Tuple[int, str]] = None
        self._last_reported: Optional[Tuple[int, str]] = None

        from horovod_tpu_torch.ops import executor as _executor_mod
        if self._control is not None:
            self._executor = _executor_mod.DistributedExecutor(
                topology, self.timeline, self._control,
                self._rank_to_process, device_kind)
        else:
            self._executor = _executor_mod.Executor(topology, self.timeline)

    def _exchange_layout(self) -> None:
        """Exchange the process layout once: (process_index, first_rank,
        local_size, host fingerprint) per process -> global rank->process
        map plus host grouping (the reference gets both from MPI comm
        splits, operations.cc:1499-1532; boot-id fingerprint equality
        stands in for MPI_Comm_split_type(SHARED) -- see
        topology.host_fingerprint)."""
        import struct
        from horovod_tpu_torch.topology import host_fingerprint
        topology = self.topology
        my_host = host_fingerprint(warn_truncation=True).encode()[:64]
        mine = struct.pack("<3i64s", topology.process_index,
                           topology.rank, topology.local_size, my_host)
        blob = self._control.allgather(mine)
        host_procs = []
        all_hosts = set()
        for off in range(0, len(blob), 76):
            pidx, frank, lsize, host = struct.unpack_from(
                "<3i64s", blob, off)
            for r in range(frank, frank + lsize):
                self._rank_to_process[r] = pidx
                self._rank_host[r] = host.rstrip(b"\0").decode(
                    errors="replace")
            all_hosts.add(host.rstrip(b"\0"))
            if host.rstrip(b"\0") == my_host.rstrip(b"\0"):
                host_procs.append(pidx)
        host_procs.sort()
        self.host_local_rank = host_procs.index(topology.process_index)
        self.host_local_size = len(host_procs)
        self.num_hosts = len(all_hosts)

    @property
    def generation(self) -> int:
        """The membership generation this controller runs in (0 until the
        first reconfiguration)."""
        return self._adopted_generation or 0

    def _discover_hosts_over_store(self) -> None:
        """Host grouping without a control plane (jit-only mode): each
        process publishes a digest of its host fingerprint under its index
        in the ``torch.distributed`` store and reads everyone's -- the
        port's stand-in for the reference's ``process_allgather`` over the
        pod runtime (``core.py:1154-1203``).  Without it every co-located
        process would silently report ``local_rank() == 0`` and pick the
        same GPU.  Bounded like the control-plane exchange: a peer that
        never reaches ``init()`` raises instead of hanging."""
        import datetime
        import hashlib
        import torch.distributed as dist
        from horovod_tpu_torch.topology import host_fingerprint
        topology = self.topology
        store = dist.distributed_c10d._get_default_store()
        digest = hashlib.sha256(host_fingerprint().encode()).hexdigest()[:16]
        # A rank subset's member ranks among its host's members by the
        # rank it was launched with, never by its subset rank.
        launched = (topology.process_index if topology.launched_rank is None
                    else topology.launched_rank)
        store.set(f"htpu/host/{topology.process_index}",
                  f"{digest}:{launched}")
        keys = [f"htpu/host/{i}" for i in range(topology.process_count)]
        timeout_s = float(os.environ.get(
            "HOROVOD_TPU_CONTROL_TIMEOUT_S", "60"))
        try:
            store.wait(keys, datetime.timedelta(seconds=timeout_s))
        except Exception:   # noqa: BLE001 -- re-raised with the diagnosis
            raise RuntimeError(
                f"horovod_tpu_torch: host-grouping exchange did not "
                f"complete within {timeout_s:.0f}s -- some process in this "
                f"{topology.process_count}-process job never reached "
                "hvd.init() (init is collective across processes). "
                "Raise HOROVOD_TPU_CONTROL_TIMEOUT_S if startup is "
                "legitimately slow.") from None
        hosts, order = zip(*(store.get(k).decode().split(":")
                             for k in keys))
        host_procs = sorted((int(order[i]), i) for i, h in enumerate(hosts)
                            if h == digest)
        self.host_local_rank = [i for _, i in host_procs].index(
            topology.process_index)
        self.host_local_size = len(host_procs)
        self.num_hosts = len(set(hosts))

    # ------------------------------------------------------------------ API

    def bind_device(self, device) -> None:
        """The torch device this process's eager data plane runs on."""
        self._executor.device = torch.device(device)

    def mesh_async_hazard(self) -> int:
        """Outstanding async eager handles whose collectives ride the
        SHARED NCCL world group -- the count that makes launching another
        collective on that group from the framework thread unsafe (each
        process could interleave the background collectives differently;
        the ordering invariant the reference's coordinator enforces,
        ``operations.cc:1414-1433``).  0 on the TCP data plane and in
        single-process jobs, where background execution is
        process-local.  Read by :func:`.basics.check_mesh_async_ordering`
        at every call of :func:`.spmd.make_train_step`'s step."""
        ex = getattr(self, "_executor", None)
        if ex is None or not getattr(ex, "_mesh_is_global", False):
            return 0
        return self.handle_manager.outstanding_mesh_hazard()

    def start(self):
        """Start the background tick loop.  The processes of a job of
        several tick in lockstep from here; a job of one process starts
        its loop at the first enqueue instead, so that a job that calls no
        eager collective (the in-step path) runs no thread beside its
        steps.  In jit-only mode there is no loop: the eager plane, which
        it serves, is gated off."""
        if self.jit_only:
            return
        self._started = True
        if self._control is not None:
            self._start_thread()

    def _start_thread(self):
        self._thread = threading.Thread(
            target=self._background_loop, name="horovod_tpu_torch-controller",
            daemon=True)
        self._thread.start()

    def stop(self):
        """Coordinated shutdown: outstanding entries get SHUT_DOWN_ERROR
        (reference ``operations.cc:1647-1662``).  In multi-process mode the
        shutdown flag rides the next request list, so every process exits
        its loop together (``operations.cc:1780-1784, 1896-1899``)."""
        with self._lock:
            self._shutdown.set()
        thread_exited = True
        if self._thread is not None:
            self._thread.join(timeout=90.0)
            thread_exited = not self._thread.is_alive()
            self._thread = None
        with self._lock:
            entries = list(self._tensor_table.values())
            self._tensor_table.clear()
            self._message_queue.clear()
        for e in entries:
            e.callback(SHUT_DOWN_ERROR, None)
        if self._control is not None and not thread_exited:
            # The background thread is wedged inside a control-plane call
            # (e.g. a dead peer): destroying the native objects under it
            # would be a use-after-free — leak them instead (the wrappers'
            # __del__ would otherwise still destroy at GC); the process
            # is tearing down anyway.  The control plane holds a raw
            # pointer to the native timeline, so both leak together.
            if hasattr(self._control, "leak"):
                self._control.leak()
            if self.timeline and hasattr(self.timeline, "leak"):
                self.timeline.leak()
        else:
            if self._control is not None:
                self._control.close()
            if self.timeline:
                self.timeline.close()

    def enqueue(self, entry: TensorTableEntry) -> Status:
        """Framework-thread side: register tensor data and queue one request
        per controlled rank (reference ``EnqueueTensorAllreduce`` et al.,
        ``operations.cc:2025-2141``)."""
        if self.jit_only:
            return Status.precondition_error(
                f"horovod_tpu_torch: eager collective '{entry.name}' needs "
                f"the TCP control plane, but this job spans "
                f"{self.topology.process_count} processes with none "
                "configured (jit-only mode). The in-step path "
                "(make_train_step, horovod_tpu_torch.ops.injit, "
                "DistributedOptimizer) works without it. For eager "
                "collectives, export HOROVOD_TPU_COORD_ADDR=<host>:<port> "
                "beside HOROVOD_TPU_SIZE and HOROVOD_TPU_RANK on every "
                "process before hvd.init().")
        first_rank = self.topology.rank
        # Allreduces carry the process-wide algorithm preference (read per
        # enqueue so HOROVOD_TPU_ALLREDUCE_ALGO changes take effect without
        # reinit); other collectives have a single data-plane path.
        algo = (default_allreduce_algo()
                if entry.request_type == RequestType.ALLREDUCE else "")
        requests: List[Request] = []
        if entry.process_set:
            err = self._build_set_requests(entry, algo, requests)
            if err is not None:
                return err
        else:
            for i, contrib in enumerate(entry.per_rank):
                requests.append(Request(
                    request_rank=first_rank + i,
                    request_type=entry.request_type,
                    tensor_name=entry.name,
                    tensor_type=dtype_name(contrib.dtype),
                    tensor_shape=tuple(contrib.shape),
                    root_rank=entry.root_rank,
                    # The global rank for a CUDA tensor, -1 for a host one:
                    # the coordinator refuses a mix, whose ranks would
                    # enter different transports.
                    device=first_rank + i if contrib.is_cuda else -1,
                    wire_dtype=entry.wire_dtype,
                    algo=algo,
                ))
        with self._lock:
            # Abort outranks plain shutdown: after a job-wide abort every
            # enqueue fails fast with the ORIGINAL attributed cause, not the
            # generic shut-down text.
            if self._abort_status is not None:
                return self._abort_status
            # Shutdown is checked under the same lock stop() takes while
            # draining, so an entry can never land in a dead controller.
            if self._shutdown.is_set():
                return SHUT_DOWN_ERROR
            if (self.expected_generation is not None
                    and self.generation != self.expected_generation):
                # The caller began its step in an older membership
                # generation (a planned reconfigure can land between two
                # of its collectives, none of them in flight): the new
                # world's members never submit this one, so it completes
                # RETRYABLE like an entry the reconfigure found in flight.
                # Checked under the lock _fail_all sweeps the table with,
                # after the new generation is published: no entry falls
                # between the two.
                return self._reconfigure_status
            if entry.name in self._tensor_table:
                return Status.invalid_argument(
                    f"Duplicate tensor name in queue: {entry.name}. "
                    "A collective for this tensor is already in progress.")
            self._tensor_table[entry.name] = entry
            self._message_queue.extend(requests)
            if self._thread is None and self._started:
                self._start_thread()
        _metrics.registry.inc(
            "controller.enqueued#type="
            f"{request_type_name(entry.request_type).lower()},"
            f"dtype={entry.dtype}", len(requests))
        return Status.OK()

    def _host_of(self, rank: int) -> Optional[str]:
        """The host fingerprint of global ``rank`` (None outside the
        world): the layout exchange's, or this host's in a job on one
        host."""
        if not 0 <= rank < self.size:
            return None
        if rank in self._rank_host:
            return self._rank_host[rank]
        if self.num_hosts == 1:
            from horovod_tpu_torch.topology import host_fingerprint
            return host_fingerprint()
        return None

    def _build_set_requests(self, entry: TensorTableEntry, algo: str,
                            requests: List[Request]) -> Optional[Status]:
        """The request of this process's rank in a non-default process
        set: SET-LOCAL request_rank, the global rank in ``device`` (-1 for
        a host tensor, as on the world route), so the coordinator's
        per-set table -- sized to the set -- indexes correctly while
        frames stay globally attributable.  Returns an error Status, or
        None on success.

        The reference refuses a set whose ranks span processes
        (``horovod_tpu/core.py:1441-1450``): its set data plane is
        process-local.  One process drives one GPU here, so the port's
        rule is one host: the members' processes reach each other over
        the set's group (NCCL over NVLink for CUDA tensors, gloo for host
        ones), as a TPU host's chips reach each other in one process."""
        ps = self._process_sets.get(entry.process_set)
        if ps is None:
            return Status.invalid_argument(
                f"Unknown process set id {entry.process_set} for tensor "
                f"{entry.name}: register it with hvd.add_process_set() or "
                "HOROVOD_TPU_PROCESS_SETS (see docs/process-sets.md).")
        hosts = {g: self._host_of(g) for g in ps.ranks}
        if None in hosts.values() or len(set(hosts.values())) != 1:
            where = ", ".join(
                f"rank {g} on {h!r}" if h is not None
                else f"rank {g} outside this {self.size}-rank world"
                for g, h in hosts.items())
            return Status.precondition_error(
                f"process set '{ps.name}' spans ranks {list(ps.ranks)} on "
                f"more than one host ({where}): every member rank of a "
                "set must live on one host -- the set-scoped eager data "
                "plane is host-local (see docs/process-sets.md).")
        rank = self.topology.rank
        if not ps.included(rank):
            return Status.precondition_error(
                f"process set '{ps.name}' has ranks {list(ps.ranks)} and "
                f"this process is rank {rank}: only a set's members "
                "submit its collectives.")
        if self._control is not None and ps.generation > 0:
            # The native coordinator's registry is sealed at Create and
            # never reconfigured: it would wait for the lost rank forever.
            return Status.precondition_error(
                f"process set '{ps.name}' was reconfigured to generation "
                f"{ps.generation} (ranks {list(ps.ranks)}), but the "
                "coordinator of this multi-process job keeps the sets of "
                "HOROVOD_TPU_PROCESS_SETS as they were at init: relaunch "
                "with the new membership in the spec.")
        contrib = entry.per_rank[0]
        requests.append(Request(
            request_rank=ps.local_rank(rank),
            request_type=entry.request_type,
            tensor_name=entry.name,
            tensor_type=dtype_name(contrib.dtype),
            tensor_shape=tuple(contrib.shape),
            root_rank=entry.root_rank,
            device=rank if contrib.is_cuda else -1,
            wire_dtype=entry.wire_dtype,
            algo=algo,
            process_set=ps.id,
        ))
        return None

    # ------------------------------------------------------- background loop

    def _background_loop(self):
        # CUDA work of this thread (the fusion buffer, NCCL calls) goes to
        # this process's device, ordered on its default stream.
        self._executor.bind_thread()
        if self._control is not None:
            self._background_loop_distributed()
            return
        while not self._shutdown.is_set():
            t0 = time.monotonic()
            try:
                self._run_loop_once()
            except Exception as exc:   # noqa: BLE001 — fail entries, not thread
                self._fail_all(Status(StatusType.UNKNOWN_ERROR, repr(exc)))
            elapsed = time.monotonic() - t0
            remaining = self.cycle_time_s - elapsed
            if remaining > 0:
                self._shutdown.wait(remaining)

    def _background_loop_distributed(self):
        """Multi-process tick loop.  Unlike the local loop, the final tick
        after ``_shutdown`` is set still runs — it carries the shutdown flag
        to the coordinator so every process exits together."""
        while True:
            t0 = time.monotonic()
            shutting = self._shutdown.is_set()
            try:
                remote_shutdown = self._run_loop_once_distributed(shutting)
            except Exception as exc:   # noqa: BLE001
                # The tick loop is dying — without it every later enqueue
                # fails with the generic shut-down text, so name the real
                # cause here (outstanding entries get it attributed too).
                traceback.print_exc()
                print(f"horovod_tpu_torch: control tick loop failed: {exc!r}",
                      file=sys.stderr)
                self._fail_all(Status(StatusType.UNKNOWN_ERROR, repr(exc)))
                self._shutdown.set()
                return
            if shutting or remote_shutdown:
                if remote_shutdown and not shutting:
                    # Another process shut down; fail outstanding work here
                    # (stop() may never be called locally).
                    self._shutdown.set()
                    self._fail_all(SHUT_DOWN_ERROR)
                return
            # The next tick starts a cycle after this one, pulled back
            # toward the coordinator's response.  Ticks are lockstep at
            # the coordinator, so a process that started early waited
            # there: timed from its own start alone (the reference's
            # pacing), it would tick again at once while its peers slept,
            # and tick phases would never line up.  A collective whose
            # result a user thread turns into the next request (a
            # replayed allreduce) then reaches the early process's frame
            # too late and splits across two ticks on every replay, so
            # no response-cache slot is ever assigned.  Timed from the
            # response alone, the round trip would lengthen every
            # period.  Counting TICK_PHASE_PULL of this tick's time at
            # the coordinator against the cycle shrinks the spread of
            # start times to that share of itself each tick, and leaves
            # the rest of the round trip in the period.
            waited = self._response_at - t0
            remaining = (self.cycle_time_s - TICK_PHASE_PULL * waited
                         - (time.monotonic() - self._response_at))
            if remaining > 0:
                self._shutdown.wait(remaining)

    def _run_loop_once_distributed(self, shutting: bool) -> bool:
        """One negotiation tick over the TCP control plane; returns True if
        the coordinator announced job shutdown (or the job aborted)."""
        from horovod_tpu_torch import wire
        with self._lock:
            pending = list(self._message_queue)
            self._message_queue.clear()
            report = self._pending_report
            self._pending_report = None
        abort_rank, abort_reason = report if report is not None else (-1, "")
        if pending:
            # Flight-recorder breadcrumb naming what this rank is about to
            # negotiate: an abort dump then shows WHICH tensors were in
            # flight on the stalled tick, not just that a tick stalled.
            from horovod_tpu_torch import cpp_core
            names = ",".join(r.tensor_name for r in pending[:4])
            if len(pending) > 4:
                names += f",+{len(pending) - 4}"
            cpp_core.flight_record("negotiate.pending", names,
                                   0, len(pending))
            # Per-tenant request accounting (the local loop's analogue
            # lives in _negotiate_sets; the coordinator adds its own
            # control.negotiate_seconds#process_set= series natively).
            for r in pending:
                if r.process_set:
                    ps = self._process_sets.get(r.process_set)
                    tag = ps.name if ps is not None else str(r.process_set)
                    _metrics.registry.inc(
                        f"control.set_requests#process_set={tag}")
        precision_ext = None
        if not shutting:
            # Adaptive-precision autopilot: piggyback the residual-norm
            # reports measured since the last tick onto this request frame
            # (FLAG_PRECISION_EXT).  Off (the default) contributes no
            # bytes: frames stay byte-identical.
            from horovod_tpu_torch import precision as _precision
            pilot = _precision.get_autopilot()
            if pilot.enabled:
                reports = pilot.drain_reports()
                if reports:
                    precision_ext = wire.RequestPrecisionExt(reports=reports)
        blob = wire.serialize_request_list(
            pending, shutdown=shutting,
            abort_rank=abort_rank, abort_reason=abort_reason,
            precision_ext=precision_ext)
        resp_blob = self._control.tick(blob, self.fusion_threshold)
        self._response_at = time.monotonic()
        (responses, remote_shutdown, abort, _cache_ext,
         elastic_ext) = wire.parse_response_list_elastic(resp_blob)
        if abort is not None:
            # Coordinator-broadcast ABORT (or a locally synthesized one when
            # the coordinator link itself died).  Latch, fail everything
            # with the attributed cause, and leave the tick loop.
            self._handle_abort(*abort)
            return True
        if elastic_ext is not None and elastic_ext.reconfigure:
            self._handle_reconfigure(elastic_ext)
            return False
        ready = []
        for resp in responses:
            with self._lock:
                # Pop only entries whose process set matches: two tenants
                # reusing a tensor name must never cross-execute (the
                # coordinator stamps set responses, wire FLAG_SET_EXT),
                # and a process holds none of a set it is not in.
                entries = [self._tensor_table.pop(n)
                           for n in resp.tensor_names
                           if n in self._tensor_table
                           and (self._tensor_table[n].process_set
                                == resp.process_set)]
            if entries:
                ready.append((resp, entries))
        if self.timeline:
            # QUEUE: response constructed -> executor picks it up (the
            # reference brackets the same wait, operations.h:35 +
            # operations.cc:951).
            for _, entries in ready:
                self.timeline.activity_start_all(entries, "QUEUE")
        self._execute_ready(ready)
        self._maybe_check_stalls_distributed()
        self._tick_telemetry()
        return remote_shutdown

    def _execute_ready(self, ready):
        """Run each popped (response, entries) pair; a raising executor
        (normally impossible -- execute converts failures to ERROR
        callbacks) must not strand the LATER responses' already-popped
        entries: their callbacks would never fire and no stall scan could
        see them, so convert the failure and keep going."""
        for resp, entries in ready:
            _metrics.registry.inc(
                "controller.ops#type="
                + ResponseType(resp.response_type).name.lower())
            if (resp.response_type == ResponseType.ALLREDUCE
                    and resp.process_set == 0
                    and self.fusion_threshold > 0 and entries):
                nbytes = sum(int(e.per_rank[0].nbytes) for e in entries)
                _metrics.registry.observe(
                    "controller.fusion_fill_ratio",
                    min(1.0, nbytes / self.fusion_threshold),
                    bounds=_metrics.RATIO_BOUNDS)
            if self.timeline:
                self.timeline.activity_end_all(entries)
            try:
                if resp.process_set:
                    self._execute_set(resp, entries)
                else:
                    self._executor.execute(resp, entries)
            except Exception as exc:   # noqa: BLE001 -- see docstring
                status = Status(StatusType.UNKNOWN_ERROR, repr(exc))
                for e in entries:
                    try:
                        e.callback(status, None)
                    except Exception:   # noqa: BLE001 -- best-effort
                        pass
        if ready and self._control is not None:
            self._note_data_plane_failure()

    def _execute_set(self, resp: Response, entries):
        """The set data plane (:func:`horovod_tpu_torch.process_set
        .execute`): each entry's collective over its set's group, on this
        thread and, for CUDA tensors, on the device's default stream, as
        the world route's -- set and training collectives are serialized
        on a card and never interleave across communicators.  The
        negotiated response ordered and validated them."""
        from horovod_tpu_torch import process_set as _process_set_mod
        if resp.response_type == ResponseType.ERROR:
            status = Status(StatusType.PRECONDITION_ERROR,
                            resp.error_message)
            for e in entries:
                e.callback(status, None)
            return
        ps = self._process_sets.get(resp.process_set)
        for e in entries:
            try:
                if ps is None:
                    raise ValueError(
                        f"process set {resp.process_set} was removed")
                if e.ready_event is not None:
                    torch.cuda.current_stream().wait_event(e.ready_event)
                out = _process_set_mod.execute(e, ps, resp.tensor_sizes)
            except Exception as exc:   # noqa: BLE001 -- propagate as status
                e.callback(Status(StatusType.UNKNOWN_ERROR, repr(exc)),
                           None)
            else:
                e.callback(Status.OK(), out)

    def _note_data_plane_failure(self):
        """Pick up a native ring data-plane failure recorded by the C++ core
        (attributed to the ring neighbour whose socket died) and queue it to
        ride the next tick's request list; the coordinator converts the
        report into the job-wide ABORT broadcast."""
        try:
            rank, reason = self._control.last_error()
        except Exception:   # noqa: BLE001 — diagnostics must not kill the loop
            return
        if rank < 0 or not reason or reason.startswith("job aborted:"):
            return
        with self._lock:
            if (self._abort_status is None
                    and self._last_reported != (rank, reason)):
                self._pending_report = (rank, reason)
                self._last_reported = (rank, reason)

    def _handle_abort(self, rank: int, reason: str):
        """Latch a job-wide abort.  The coordinator broadcast the identical
        (rank, reason) payload to every process, so all ranks fail their
        outstanding and future eager work with the SAME attributed ABORTED
        status — no stranded waiters, no divergent error text."""
        status = Status.aborted(
            f"Horovod job aborted: rank {rank} failed: {reason}")
        with self._lock:
            if self._abort_status is None:
                self._abort_status = status
                _metrics.registry.inc("controller.aborts")
            else:
                status = self._abort_status
            self._shutdown.set()
        if reason.startswith(EVICTED_PREFIX):
            # Demoted or parked by the elastic coordinator (control.cc
            # ApplyReconfigure): the others already left this
            # generation's world group, so abort it here too -- the
            # process exits without waiting on it.  All CUDA collectives
            # run on this thread, so none is in flight.
            from horovod_tpu_torch import basics
            if basics._state.controller is self:
                basics._abort_world()
        self._fail_all(status)

    def _handle_reconfigure(self, ext):
        """Adopt a membership change broadcast by the elastic coordinator
        (reference ``core.py:1673-1775``).

        By the time Tick returned the RECONFIGURE frame, the native plane
        has already re-ranked the survivors, re-bootstrapped its TCP data
        plane and flushed its response cache.  The Python side quiesces
        in the reference's order, after one step of the port's own: the
        world group of the CUDA data plane is rebuilt for the new
        generation (the old group's communicators include the lost rank);
        then the controller re-reads its identity from the native plane so
        ``hvd.rank()``/``size()`` report the post-reconfigure world, the
        adopted generation is published, and only then every in-flight
        entry completes RETRYABLE (``run_elastic`` restores from the
        latest checkpoint and re-submits).  Every process set holding the
        lost rank reconfigures first (its generation advances on its own),
        and the world's rebuild makes the sets' groups again."""
        from horovod_tpu_torch import basics, cpp_core
        from horovod_tpu_torch import process_set as _process_set_mod
        if ext.lost_rank >= 0:
            cause = (f"rank {ext.lost_rank} was lost "
                     f"({ext.lost_reason or 'no reason recorded'})")
        else:
            cause = ext.lost_reason or "membership changed"
        status = Status.retryable(
            f"Horovod membership reconfigured at generation "
            f"{ext.generation}: {cause}. Restore from the latest "
            "checkpoint and retry.")
        with self._lock:
            # Failure reports attributed under the OLD generation must not
            # ride the next tick -- the coordinator already acted on them.
            self._pending_report = None
            self._last_reported = None
            self._stall_warned.clear()
            self._reconfigure_status = status
        old_pidx = self.topology.process_index
        pidx, pcount, first_rank, generation = self._control.membership()
        new_size = pcount
        # Per-set elastic rides the pod event: every registered set
        # containing the lost rank reconfigures itself (generation bump +
        # tagged-series retirement) -- the other tenants are untouched.
        try:
            _process_set_mod.on_pod_reconfigure(ext.lost_rank)
        except Exception:   # noqa: BLE001 -- tenant bookkeeping must not
            pass            # block pod survival
        # The ranks are dense again: the layout's rank -> host map is gone
        # (a job on one host still maps every rank to it).
        self._rank_host.clear()
        if basics._state.controller is self:
            # The data plane of CUDA tensors first, while every framework
            # query still reports the old world: abort the old
            # generation's world group and make this one's.  All CUDA
            # collectives run on this thread, so none can reach the group
            # in between.  A failure raises out of the tick loop, which
            # fails every entry and stops: the job never goes on over a
            # dead group, gloo or the host.
            basics._rebuild_world(generation, new_size, first_rank)
        # basics' snapshot carries the discovered local_rank; keep it.
        base = (basics._state.topology
                if basics._state.controller is self else self.topology)
        self.topology = dataclasses.replace(base, rank=first_rank,
                                            size=new_size)
        self.size = new_size
        # The order is the native plane's (survivors fastest first under
        # the fleet policy's re-rank, admitted standbys after them), and
        # first_rank above is this process's seat in it, as is its rank
        # in the rebuilt group.  One rank per process, so the rank map is
        # the identity -- no layout re-exchange over a ring whose peers
        # are mid-training.
        self._rank_to_process.clear()
        for r in range(new_size):
            self._rank_to_process[r] = r
        ex = getattr(self, "_executor", None)
        if ex is not None:
            ex.topology = self.topology
            ex.nranks = new_size
        if self._use_cpp:
            self._message_table = cpp_core.CppMessageTable(
                new_size, self.timeline)
        else:
            self._message_table = MessageTable(new_size, self.timeline)
        self._message_table.configure_algo_selection(
            self.num_hosts, pcount, algo_crossover_bytes())
        if basics._state.controller is self:
            basics._state.topology = self.topology
        _metrics.registry.set_gauge("membership.generation", generation)
        # Published after rank()/size() describe the new world: the seam
        # elastic.generation() reads.
        self._adopted_generation = generation
        # Quiesce LAST: the woken training threads immediately rebuild
        # their requests from the framework identity.
        self._fail_all(status)
        cpp_core.flight_record(
            "elastic.adopted", f"gen={generation}", first_rank, new_size)
        if pidx == 0 and old_pidx != 0:
            print(f"horovod_tpu elastic: this process (was process "
                  f"{old_pidx}) took over as coordinator", file=sys.stderr)
        print(f"horovod_tpu elastic: continuing at generation {generation} "
              f"as rank {first_rank} of {new_size} "
              f"(process {pidx} of {pcount})", file=sys.stderr)

    def _maybe_check_stalls_distributed(self):
        if self.stall_check_disabled or not self.topology.is_coordinator:
            return
        now = time.monotonic()
        if now - self._last_stall_check < self.stall_warning_time_s:
            return
        self._last_stall_check = now
        self._warn_stalled(self._control.stalled(self.stall_warning_time_s))

    def _maybe_inject_slow_fault(self):
        """Python-controller half of the ``slow`` fault: a deterministic
        per-tick delay in the local negotiation loop.  Multi-process
        ticks delegate to the native plane, which injects the same delay
        there (control.cc MaybeInjectFault) — never both, so the stall
        lands exactly once per tick."""
        self._fault_tick += 1
        for i, fs in enumerate(self._fault_specs):
            if fs.mode != "slow" or not 0 <= fs.rank < self.size:
                continue
            if fs.tick >= 0 and self._fault_tick < fs.tick:
                continue
            if i not in self._slow_announced:
                self._slow_announced.add(i)
                print(f"horovod_tpu_torch fault injection: slowing rank "
                      f"{fs.rank} by {fs.ms}ms per tick from tick "
                      f"{self._fault_tick}", file=sys.stderr)
            time.sleep(fs.ms / 1e3)

    def _run_loop_once(self):
        if self._fault_specs:
            self._maybe_inject_slow_fault()
        with self._lock:
            pending = list(self._message_queue)
            self._message_queue.clear()

        # Non-default process sets negotiate on the SAME tick but in their
        # own namespaces: partition first, run each set's pass, and keep
        # the default path below byte-identical when only set 0 exists.
        if any(r.process_set for r in pending):
            set_pending: Dict[int, List[Request]] = {}
            default_pending: List[Request] = []
            for r in pending:
                if r.process_set:
                    set_pending.setdefault(r.process_set, []).append(r)
                else:
                    default_pending.append(r)
            pending = default_pending
            self._negotiate_sets(set_pending)

        # Response cache: a batch byte-identical to an earlier
        # fully-successful tick replays that tick's fused responses,
        # skipping the table and the fusion planner.  Only sound when the
        # table is empty on both sides of the original tick -- a straggler
        # could otherwise have contributed to the stored responses.
        cache = self._local_cache
        t0 = time.monotonic()
        table_was_empty = bool(cache is not None and pending
                               and len(self._message_table) == 0)
        fused = None
        if cache is not None and pending:
            fused = cache.lookup(pending, table_empty=table_was_empty)
        cached_tick = fused is not None

        if not cached_tick:
            # Negotiation.  Single-process: this process speaks for every
            # rank, so readiness resolves locally.  Multi-process: local
            # requests are forwarded to the rank-0 coordinator over the
            # control plane (C++ core), which gathers/validates and
            # broadcasts responses.
            responses: List[Response] = []
            for req in pending:
                if self._message_table.increment(req):
                    responses.append(
                        self._message_table.construct_response(
                            req.tensor_name))

            if not responses:
                self._maybe_check_stalls()
                self._tick_telemetry()
                return

            def entry_bytes(name: str) -> int:
                e = self._tensor_table[name]
                return e.per_rank[0].numel() * dtype_itemsize(e.dtype)

            def entry_dtype(name: str) -> str:
                return self._tensor_table[name].dtype

            fused = self._plan_fusion(responses, entry_bytes, entry_dtype,
                                      self.fusion_threshold)
            if (cache is not None and table_was_empty
                    and len(self._message_table) == 0
                    and all(r.response_type != ResponseType.ERROR
                            for r in fused)
                    and {n for r in fused for n in r.tensor_names}
                        == {req.tensor_name for req in pending}):
                cache.store(pending, fused)
            _metrics.registry.observe("control.tick_seconds#cached=0",
                                      time.monotonic() - t0)
        else:
            dur = time.monotonic() - t0
            _metrics.registry.observe("control.tick_seconds#cached=1", dur)
            tl = self.timeline
            if tl is not None and hasattr(tl, "cache_hit_tick"):
                tl.cache_hit_tick(int(dur * 1e6))

        ready = []
        for resp in fused:
            with self._lock:
                entries = [self._tensor_table.pop(n) for n in resp.tensor_names]
            ready.append((resp, entries))
        if self.timeline:
            # QUEUE span per negotiated tensor: response constructed →
            # executor start (reference operations.h:35, cc:951).
            for _, entries in ready:
                self.timeline.activity_start_all(entries, "QUEUE")
        self._execute_ready(ready)

        self._maybe_check_stalls()
        self._tick_telemetry()

    def _negotiate_sets(self, set_pending: Dict[int, List[Request]]):
        """Local negotiation for non-default process sets.

        Each set runs its own table pass and its OWN planner invocation --
        responses never fuse across sets (native parity: the coordinator
        appends set responses after PlanTick), and the default response
        cache never sees set traffic.  Per-tenant observability: request
        and tick-latency series tagged ``#process_set=<name>``."""
        for sid in sorted(set_pending):
            reqs = set_pending[sid]
            ps = self._process_sets.get(sid)
            tag = ps.name if ps is not None else str(sid)
            t0 = time.monotonic()
            responses: List[Response] = []
            for req in reqs:
                rc = self._process_sets.increment(sid, req)
                if rc < 0:
                    responses.append(Response(
                        response_type=ResponseType.ERROR,
                        tensor_names=[req.tensor_name],
                        error_message="Request rank out of range.",
                        process_set=sid))
                elif rc == 1:
                    responses.append(
                        self._process_sets.construct_response(
                            sid, req.tensor_name))
            _metrics.registry.inc(
                f"control.set_requests#process_set={tag}", len(reqs))
            if not responses:
                continue

            def entry_bytes(name: str) -> int:
                e = self._tensor_table[name]
                return e.per_rank[0].numel() * dtype_itemsize(e.dtype)

            def entry_dtype(name: str) -> str:
                return self._tensor_table[name].dtype

            fused = self._plan_fusion(responses, entry_bytes, entry_dtype,
                                      self.fusion_threshold)
            # The planner predates sets; re-stamp so pop guards and the
            # execution branch route by the right namespace.
            for resp in fused:
                resp.process_set = sid
            ready = []
            for resp in fused:
                with self._lock:
                    entries = [self._tensor_table.pop(n)
                               for n in resp.tensor_names
                               if n in self._tensor_table
                               and self._tensor_table[n].process_set == sid]
                ready.append((resp, entries))
            if self.timeline:
                for _, entries in ready:
                    self.timeline.activity_start_all(entries, "QUEUE")
            self._execute_ready(ready)
            _metrics.registry.observe(
                f"control.tick_seconds#process_set={tag}",
                time.monotonic() - t0)

    def _maybe_check_stalls(self):
        """Warn (once per minute) about tensors some ranks never submitted
        (reference ``CheckForStalledTensors``, ``operations.cc:1366-1412``)."""
        if self.stall_check_disabled:
            return
        now = time.monotonic()
        if now - self._last_stall_check < self.stall_warning_time_s:
            return
        self._last_stall_check = now
        self._warn_stalled(self._message_table.pending_names_older_than(
            self.stall_warning_time_s))

    def _warn_stalled(self, stalled):
        """``stalled`` is a list of (name, age_s, missing_ranks) records —
        the shape both the Python table and the native control plane
        report.  Identical warnings dedupe on the missing-rank set: a
        long-lived stall prints once, and re-warns only when the set of
        absent ranks changes; resolved tensors drop out so they may warn
        again on a later stall."""
        import sys
        _metrics.registry.set_gauge("controller.stalled_tensors",
                                    len(stalled))
        fresh = []
        current: Dict[str, frozenset] = {}
        for name, age, missing in stalled:
            key = frozenset(missing)
            current[name] = key
            if self._stall_warned.get(name) != key:
                fresh.append((name, age, missing))
        self._stall_warned = current
        if not fresh:
            return
        msg = ["WARNING: One or more tensors were submitted to be "
               "reduced, gathered or broadcasted by subset of ranks and "
               "are waiting for remainder of ranks for more than "
               f"{int(self.stall_warning_time_s)} seconds. This may "
               "indicate that different ranks are trying to submit "
               "different tensors or that only subset of ranks is "
               "submitting tensors, which will cause deadlock."]
        for name, age, missing in fresh:
            msg.append(f"Stalled op: {name} [waiting {age:.0f}s; "
                       f"missing ranks: {', '.join(map(str, missing))}]")
        print("\n".join(msg), file=sys.stderr)

    def _fail_all(self, status: Status):
        with self._lock:
            entries = list(self._tensor_table.values())
            self._tensor_table.clear()
            self._message_queue.clear()
            # Stale negotiation state would poison later reuse of the same
            # tensor names (the readiness count could overshoot `size`).
            self._message_table.clear()
        # Cached response sets are dead with the job — a restarted loop
        # must renegotiate from scratch (the native control plane flushes
        # its own cache in LatchAbort).
        if self._local_cache is not None:
            self._local_cache.flush()
        # Per-set negotiation state is scoped the same way: stale
        # set-local readiness counts would poison later reuse of the same
        # tensor names inside a tenant.
        self._process_sets.clear_negotiation_state()
        for e in entries:
            e.callback(status, None)
        # Keep the trace on disk usable while the job is failing: this
        # covers both the abort-broadcast path and tick-loop exceptions
        # (the atexit guard closes the JSON on process death).
        tl = self.timeline
        if tl is not None and hasattr(tl, "flush"):
            try:
                tl.flush()
            except Exception:   # noqa: BLE001 — best-effort on failure path
                pass

    def _tick_telemetry(self):
        """Per-tick observability: queue-depth / outstanding-handle gauges
        in the metrics registry plus Chrome-trace counter tracks (queue
        depth, bytes in flight) on the timeline.  Counter events are
        emitted only when the value changes so idle ticks cost nothing in
        the trace."""
        with self._lock:
            depth = len(self._tensor_table)
            in_flight = sum(int(c.nbytes)
                            for e in self._tensor_table.values()
                            for c in e.per_rank)
        _metrics.registry.set_gauge("controller.queue_depth", depth)
        _metrics.registry.set_gauge("controller.outstanding_handles",
                                    self.handle_manager.outstanding())
        tl = self.timeline
        if tl is not None and hasattr(tl, "counter"):
            for name, val in (("queue_depth", depth),
                              ("bytes_in_flight", in_flight)):
                if self._last_counters.get(name) != val:
                    self._last_counters[name] = val
                    tl.counter(name, val)

    def _close_timeline(self):
        """atexit / teardown hook: close the timeline into loadable JSON
        if it is still open.  Safe after stop() — close() is idempotent in
        both implementations, and a leaked native timeline (wedged
        shutdown) makes this a no-op."""
        tl = self.timeline
        if tl is None:
            return
        try:
            tl.close()
        except Exception:   # noqa: BLE001 — best-effort at interpreter exit
            pass

