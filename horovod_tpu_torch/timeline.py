"""Chrome-tracing timeline of the eager plane.

Port of ``horovod_tpu/timeline.py`` (``Timeline`` :64,
``per_rank_trace_path`` :35, ``wire_activity`` :56), verbatim: the same
events, names and trace layout, so ``tools/trace_merge.py`` merges the
port's traces.  It mirrors ``horovod/common/timeline.{h,cc}``: each named
tensor is modelled as a trace "process" (metadata event naming it); spans
cover the negotiation phase (NEGOTIATE_ALLREDUCE etc. with per-rank
instant events), a QUEUE span (response constructed -> executor start,
``operations.h:35``), the top-level operation, and nested activities
(MEMCPY_IN_FUSION_BUFFER, NCCL_ALLREDUCE, TCP_ALLREDUCE[int8], ...).
Opened on EVERY rank when ``HOROVOD_TPU_TIMELINE`` is set: the value is a
path template (a literal ``{rank}`` placeholder, or ``.rank<R>`` inserted
before the extension in multi-rank jobs -- ``per_rank_trace_path``), each
trace opens with a ``trace_t0`` wall-clock anchor.  Output loads in
``chrome://tracing`` / Perfetto.

It complements ``torch.profiler``: it shows the control-plane life cycle
of every named tensor, which device-side profiles cannot see.  The native
core's writer (``cpp/htpu/timeline.{h,cc}``, bound in
:class:`horovod_tpu_torch.cpp_core.CppTimeline`) has identical output and
is used when the library loads; this module is the fallback and the
format specification.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


def per_rank_trace_path(template: str, rank: int, size: int = None) -> str:
    """Resolve the ``HOROVOD_TPU_TIMELINE`` path template for one rank.

    A literal ``{rank}`` placeholder is always substituted.  Without a
    placeholder, multi-rank jobs (``size`` > 1 or unknown) get ``.rank<R>``
    inserted before the extension — ``/tmp/t.json`` → ``/tmp/t.rank1.json``
    — while single-rank jobs keep the literal path (back-compat with the
    rank-0-only tracing of earlier rounds).  Idempotent: a path already
    carrying this rank's suffix passes through unchanged (run.py fills the
    template per child AND the controller resolves it again locally).
    """
    if "{rank}" in template:
        return template.replace("{rank}", str(rank))
    if size is not None and size <= 1:
        return template
    root, ext = os.path.splitext(template)
    if root.endswith(f".rank{rank}"):
        return template
    return f"{root}.rank{rank}{ext}"


def wire_activity(base: str, wire_dtype: str) -> str:
    """Activity name for a data-plane transfer, tagged with the negotiated
    ring wire compression — ``TCP_ALLREDUCE[int8]`` — so traces show what
    actually rode the wire.  Raw fp32 transfers keep the bare name (no
    ``[fp32]`` suffix: pre-compression traces stay comparable)."""
    return f"{base}[{wire_dtype}]" if wire_dtype else base


class Timeline:
    FLUSH_EVERY_S = 1.0   # reference timeline.h:32

    def __init__(self, path: str, rank: int = 0):
        self._file = open(path, "w")
        self._file.write("[")
        self._lock = threading.Lock()
        self._first_event = True
        self._t0 = time.monotonic()
        t0_wall_us = int(time.time() * 1e6)
        self._tensor_pids: Dict[str, int] = {}
        self._next_pid = 1
        self._last_flush = time.monotonic()
        self._closed = False
        self.rank = rank
        # Absolute anchor: ts 0 of this trace is t0_wall_us on this
        # process's wall clock.  trace_merge.py keys per-rank alignment
        # off this event.
        self._emit({"name": "trace_t0", "ph": "i", "s": "g", "pid": 0,
                    "ts": 0, "args": {"rank": rank,
                                      "t0_wall_us": t0_wall_us}})

    # ----------------------------------------------------------- primitives

    def _ts_us(self) -> int:
        return int((time.monotonic() - self._t0) * 1e6)

    def _emit(self, ev: dict):
        with self._lock:
            if self._closed:
                return
            # Comma BEFORE each event after the first: a process killed
            # mid-run leaves a file missing only the closing "]", which
            # trace_merge.py repairs trivially, while close() produces
            # strictly valid JSON (Perfetto's trace_processor rejects the
            # old trailing-comma form).
            self._file.write("\n" if self._first_event else ",\n")
            self._first_event = False
            self._file.write(json.dumps(ev))
            now = time.monotonic()
            if now - self._last_flush > self.FLUSH_EVERY_S:
                self._file.flush()
                self._last_flush = now

    def _pid(self, tensor_name: str) -> int:
        with self._lock:
            pid = self._tensor_pids.get(tensor_name)
            created = pid is None
            if created:
                pid = self._next_pid
                self._next_pid += 1
                self._tensor_pids[tensor_name] = pid
        if created:
            # Metadata event registering the tensor as a trace process
            # (reference timeline.cc:51-68); emitted exactly once per tensor.
            self._emit({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": tensor_name}})
            self._emit({"name": "process_sort_index", "ph": "M", "pid": pid,
                        "args": {"sort_index": pid}})
        return pid

    # ---------------------------------------------------------- negotiation

    def negotiate_start(self, tensor_name: str, request_type) -> None:
        from horovod_tpu_torch.core import request_type_name
        self._emit({"ph": "B", "pid": self._pid(tensor_name),
                    "ts": self._ts_us(),
                    "name": f"NEGOTIATE_{request_type_name(request_type)}"})

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        self._emit({"ph": "i", "pid": self._pid(tensor_name),
                    "ts": self._ts_us(), "s": "p", "name": str(rank)})

    def negotiate_end(self, tensor_name: str) -> None:
        self._emit({"ph": "E", "pid": self._pid(tensor_name),
                    "ts": self._ts_us()})

    # ------------------------------------------------------------ operation

    def start(self, tensor_name: str, response_type) -> None:
        name = {0: "ALLREDUCE", 1: "ALLGATHER", 2: "BROADCAST",
                3: "ERROR"}.get(int(response_type), "UNKNOWN")
        self._emit({"ph": "B", "pid": self._pid(tensor_name),
                    "ts": self._ts_us(), "name": name})

    def end(self, tensor_name: str) -> None:
        self._emit({"ph": "E", "pid": self._pid(tensor_name),
                    "ts": self._ts_us()})

    def activity_start_all(self, entries, activity: str) -> None:
        for e in entries:
            self._emit({"ph": "B", "pid": self._pid(e.name),
                        "ts": self._ts_us(), "name": activity})

    def activity_end_all(self, entries) -> None:
        for e in entries:
            self._emit({"ph": "E", "pid": self._pid(e.name),
                        "ts": self._ts_us()})

    def cache_hit_tick(self, dur_us: int) -> None:
        """Complete-event span (``"ph": "X"``) marking a negotiation tick
        served entirely from the response cache — visually distinct from
        NEGOTIATE_* spans; ``dur`` is the full tick latency."""
        self._emit({"ph": "X", "pid": 0, "ts": self._ts_us() - int(dur_us),
                    "dur": int(dur_us), "name": "CACHED_TICK"})

    def tick_span(self, tick: int, dur_us: int) -> None:
        """Complete-event span covering one negotiation tick, tagged with
        the tick id in ``args`` — the cross-rank alignment anchor
        ``trace_merge.py`` lines per-rank traces up by."""
        dur_us = max(0, int(dur_us))
        self._emit({"ph": "X", "pid": 0, "ts": self._ts_us() - dur_us,
                    "dur": dur_us, "name": "TICK",
                    "args": {"tick": int(tick)}})

    def instant(self, name: str, args: dict = None) -> None:
        """Global instant event on the control track (``clock_offset``
        metadata, markers)."""
        self._emit({"name": name, "ph": "i", "s": "g", "pid": 0,
                    "ts": self._ts_us(), "args": args or {}})

    # ------------------------------------------------------------- counters

    def counter(self, name: str, value: int) -> None:
        """Chrome-trace counter sample (``"ph": "C"``): Perfetto renders
        each named series as a rate track alongside the spans (queue
        depth, bytes in flight).  Counters live on pid 0 — they are
        job-level series, not per-tensor ones."""
        self._emit({"ph": "C", "pid": 0, "ts": self._ts_us(),
                    "name": name, "args": {"value": int(value)}})

    def flush(self) -> None:
        """Force buffered events to disk — abort paths call this so a
        trace survives even when the process dies mid-run."""
        with self._lock:
            if not self._closed:
                self._file.flush()

    def close(self):
        with self._lock:
            if not self._closed:
                self._file.write("\n]\n")
                self._file.close()
                self._closed = True
