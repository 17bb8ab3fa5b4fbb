"""ctypes binding of the framework-agnostic native core (``cpp/htpu``).

Port of ``horovod_tpu/cpp_core.py``, for what the eager plane calls:
``load`` / ``available`` / ``_configure`` (:35, :395, :438), the flight
recorder hooks, :class:`CppMessageTable` (:515), :func:`cpp_plan_fusion`
(:581), :func:`cpp_plan_tick` (:611), :func:`cpp_resolve_algo` (:632),
:class:`CppControlPlane` (:1202), :class:`CppTimeline` (:1383), the metrics
snapshot, CRC32C and the request-list round trip the tests hold frames
with.  The native bucket planner, the fleet policy, the process-set table
and the precision and observatory bindings are not ported yet (ROADMAP).

The library is the reference's own C++ core, built by the reference's
Makefile into a path this package owns::

    make -C cpp OUT=../horovod_tpu_torch/lib/libhtpu_core.so \
        CXXFLAGS="-O2 -Wall -Wextra -include stdexcept"

``load()`` runs that at first use, under a file lock so that concurrent
processes build once (the Makefile also renames its output atomically).
Where the build fails it warns and the controller takes the pure-Python
control path, as in the reference; set ``HOROVOD_TPU_NO_CPP=1`` to force
that path.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import warnings
from typing import List

from horovod_tpu_torch import wire
from horovod_tpu_torch.core import Request, Response, env_flag

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_PKG_DIR, "lib", "libhtpu_core.so")
_CPP_DIR = os.path.join(_PKG_DIR, os.pardir, "cpp")
# The Makefile's OUT, relative to the cpp/ directory it runs in, and its
# default flags plus <stdexcept> included in every source: c_api.cc
# catches std::out_of_range without including that header, which some
# libstdc++ versions do not pull in through the others.
_MAKE_ARGS = ("OUT=../horovod_tpu_torch/lib/libhtpu_core.so",
              "CXXFLAGS=-O2 -Wall -Wextra -include stdexcept")
_BUILD_TIMEOUT_S = 600

_lib = None
_lib_lock = threading.Lock()


def _configure(lib) -> None:
    lib.htpu_version.restype = ctypes.c_char_p
    lib.htpu_free.restype = None
    lib.htpu_free.argtypes = [ctypes.c_void_p]
    lib.htpu_table_create.restype = ctypes.c_void_p
    lib.htpu_table_create.argtypes = [ctypes.c_int]
    lib.htpu_table_destroy.restype = None
    lib.htpu_table_destroy.argtypes = [ctypes.c_void_p]
    lib.htpu_table_increment.restype = ctypes.c_int
    lib.htpu_table_increment.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.htpu_table_construct_response.restype = ctypes.c_int
    lib.htpu_table_construct_response.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_table_num_pending.restype = ctypes.c_int
    lib.htpu_table_num_pending.argtypes = [ctypes.c_void_p]
    lib.htpu_table_clear.restype = None
    lib.htpu_table_clear.argtypes = [ctypes.c_void_p]
    lib.htpu_table_stalled.restype = ctypes.c_int
    lib.htpu_table_stalled.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_table_configure_algo.restype = None
    lib.htpu_table_configure_algo.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.htpu_plan_fusion.restype = ctypes.c_int
    lib.htpu_plan_fusion.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_timeline_destroy.restype = None
    lib.htpu_timeline_destroy.argtypes = [ctypes.c_void_p]
    lib.htpu_timeline_create_rank.restype = ctypes.c_void_p
    lib.htpu_timeline_create_rank.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in ("negotiate_start", "start"):
        f = getattr(lib, f"htpu_timeline_{fn}")
        f.restype = None
        f.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.htpu_timeline_negotiate_rank_ready.restype = None
    lib.htpu_timeline_negotiate_rank_ready.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    for fn in ("negotiate_end", "end", "activity_end"):
        f = getattr(lib, f"htpu_timeline_{fn}")
        f.restype = None
        f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.htpu_timeline_activity_start.restype = None
    lib.htpu_timeline_activity_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.htpu_timeline_counter.restype = None
    lib.htpu_timeline_counter.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
    lib.htpu_timeline_cache_hit_tick.restype = None
    lib.htpu_timeline_cache_hit_tick.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong]
    lib.htpu_timeline_flush.restype = None
    lib.htpu_timeline_flush.argtypes = [ctypes.c_void_p]
    lib.htpu_timeline_close.restype = None
    lib.htpu_timeline_close.argtypes = [ctypes.c_void_p]
    lib.htpu_control_create.restype = ctypes.c_void_p
    lib.htpu_control_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.htpu_control_destroy.restype = None
    lib.htpu_control_destroy.argtypes = [ctypes.c_void_p]
    lib.htpu_control_tick.restype = ctypes.c_int
    lib.htpu_control_tick.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_control_allreduce_algo.restype = ctypes.c_int
    lib.htpu_control_allreduce_algo.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_control_allgather.restype = ctypes.c_int
    lib.htpu_control_allgather.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_control_broadcast.restype = ctypes.c_int
    lib.htpu_control_broadcast.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_control_stalled.restype = ctypes.c_int
    lib.htpu_control_stalled.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_control_last_error.restype = ctypes.c_int
    lib.htpu_control_last_error.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_control_data_bytes.restype = None
    lib.htpu_control_data_bytes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.htpu_control_set_timeline.restype = None
    lib.htpu_control_set_timeline.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.htpu_metrics_snapshot.restype = ctypes.c_int
    lib.htpu_metrics_snapshot.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_flight_record.restype = None
    lib.htpu_flight_record.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int]
    lib.htpu_flight_dump.restype = ctypes.c_int
    lib.htpu_flight_dump.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_plan_tick.restype = ctypes.c_int
    lib.htpu_plan_tick.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_resolve_algo.restype = ctypes.c_int
    lib.htpu_resolve_algo.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_wire_request_list_roundtrip.restype = ctypes.c_longlong
    lib.htpu_wire_request_list_roundtrip.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong]
    lib.htpu_crc32c.restype = ctypes.c_uint
    lib.htpu_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.htpu_control_set_xfer_context.restype = None
    lib.htpu_control_set_xfer_context.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p]


def _make() -> None:
    """Run the reference's Makefile into this package's lib/ under an
    exclusive file lock: it no-ops when the library is up to date and
    rebuilds a stale one; concurrent callers wait for one build."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    with open(_LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", _CPP_DIR, *_MAKE_ARGS], check=True,
                       capture_output=True, timeout=_BUILD_TIMEOUT_S)


def load():
    """Load the native core, building it from ``cpp/`` first; None (the
    pure-Python control path) when it cannot be built.  The library is
    always this tree's own build, so a missing symbol raises here."""
    global _lib
    if env_flag("HOROVOD_TPU_NO_CPP"):
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.isdir(_CPP_DIR):
            warnings.warn(
                "horovod_tpu_torch: the native core's sources (cpp/) are "
                "missing; using the pure-Python control path.",
                RuntimeWarning)
            return None
        try:
            _make()
        except subprocess.CalledProcessError as e:
            warnings.warn(
                "horovod_tpu_torch: native core build failed; using the "
                "pure-Python control path.\n--- make stderr ---\n"
                + e.stderr.decode(errors="replace")[-2000:],
                RuntimeWarning)
            return None
        except (subprocess.SubprocessError, OSError) as e:
            warnings.warn(
                f"horovod_tpu_torch: native core build did not run ({e}); "
                "using the pure-Python control path.", RuntimeWarning)
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        _configure(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _take_buffer(lib, out_ptr: ctypes.c_void_p, length: int) -> bytes:
    if length < 0:
        raise RuntimeError("native core returned an error")
    try:
        if length == 0:
            return b""
        return ctypes.string_at(out_ptr, length)
    finally:
        lib.htpu_free(out_ptr)


# ------------------------------------------------------- flight recorder

def flight_record(kind: str, detail: str = "", nbytes: int = 0,
                  a: int = 0, b: int = 0) -> None:
    """Append one event to the native flight-recorder ring (no-op without
    the native core).  Python-side callers use this to mark host-level
    context — op-timeout pending tensors, shutdown phases — so the abort
    dump interleaves them with the C++ tick/transfer events."""
    lib = load()
    if lib is not None:
        lib.htpu_flight_record(kind.encode("utf-8"), detail.encode("utf-8"),
                               int(nbytes), int(a), int(b))


def flight_dump(why: str = "manual") -> str:
    """Dump the ring to its per-rank JSON file; returns the path, or ""
    when the dump failed or the native core is absent."""
    lib = load()
    if lib is None:
        return ""
    out = ctypes.c_void_p()
    n = lib.htpu_flight_dump(why.encode("utf-8"), ctypes.byref(out))
    if n < 0:
        return ""
    return _take_buffer(lib, out, n).decode("utf-8", errors="replace")


class CppMessageTable:
    """Native MessageTable with the Python-class interface of
    :class:`horovod_tpu_torch.core.MessageTable`."""

    def __init__(self, size: int, timeline=None):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native core not available")
        self._ptr = self._lib.htpu_table_create(size)
        self._size = size
        self._timeline = timeline
        self._pending_names = set()   # for timeline negotiate_start hooks

    def __del__(self):
        lib, ptr = getattr(self, "_lib", None), getattr(self, "_ptr", None)
        if lib is not None and ptr:
            lib.htpu_table_destroy(ptr)
            self._ptr = None

    def __len__(self):
        return self._lib.htpu_table_num_pending(self._ptr)

    def clear(self):
        self._lib.htpu_table_clear(self._ptr)
        self._pending_names.clear()

    def increment(self, msg: Request) -> bool:
        # Single-message boundary frames always carry the algo field (the
        # C side parses with with_algo=true — no flag byte on this path).
        data = wire.serialize_request(msg, with_algo=True)
        rc = self._lib.htpu_table_increment(self._ptr, data, len(data))
        if rc < 0:
            raise RuntimeError("native core failed to parse request")
        if self._timeline:
            # The native table doesn't call back into Python; replicate the
            # negotiation hooks here, tracking first-appearance locally.
            if msg.tensor_name not in self._pending_names:
                self._pending_names.add(msg.tensor_name)
                self._timeline.negotiate_start(msg.tensor_name,
                                               msg.request_type)
            self._timeline.negotiate_rank_ready(msg.tensor_name,
                                                msg.request_rank)
            if rc == 1:
                self._timeline.negotiate_end(msg.tensor_name)
        return rc == 1

    def construct_response(self, name: str) -> Response:
        self._pending_names.discard(name)
        out = ctypes.c_void_p()
        n = self._lib.htpu_table_construct_response(
            self._ptr, name.encode("utf-8"), ctypes.byref(out))
        return wire.parse_single_response(_take_buffer(self._lib, out, n))

    def pending_names_older_than(self, age_s: float):
        out = ctypes.c_void_p()
        n = self._lib.htpu_table_stalled(self._ptr, age_s, ctypes.byref(out))
        return _parse_stall_records(_take_buffer(self._lib, out, n))

    def configure_algo_selection(self, num_hosts: int, num_procs: int,
                                 crossover_bytes: int) -> None:
        """Topology + crossover inputs for allreduce algorithm resolution
        ("auto" -> ring / hier / small per payload size)."""
        self._lib.htpu_table_configure_algo(
            self._ptr, num_hosts, num_procs, crossover_bytes)


def cpp_plan_fusion(responses: List[Response], entry_bytes, entry_dtype,
                    threshold: int) -> List[Response]:
    """Native fusion planner with the signature of
    :func:`horovod_tpu_torch.core.plan_fusion`."""
    lib = load()
    if lib is None:
        raise RuntimeError("native core not available")
    blob = wire.serialize_response_list(responses)
    names = sorted({n for r in responses for n in r.tensor_names})
    n = len(names)
    name_arr = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in names])
    bytes_arr = (ctypes.c_int64 * n)(*[entry_bytes(s) for s in names])
    dtype_arr = (ctypes.c_char_p * n)(
        *[entry_dtype(s).encode("utf-8") for s in names])
    out = ctypes.c_void_p()
    rc = lib.htpu_plan_fusion(blob, len(blob), name_arr, bytes_arr, dtype_arr,
                              n, threshold, ctypes.byref(out))
    fused, _, _ = wire.parse_response_list(_take_buffer(lib, out, rc))
    return fused


def cpp_plan_tick(responses: List[Response], entry_bytes, entry_dtype,
                  threshold: int) -> List[Response]:
    """Native per-tick policy (fusion + first-ready issue order) with the
    signature of :func:`horovod_tpu_torch.scheduler.plan_tick`."""
    lib = load()
    if lib is None:
        return cpp_plan_fusion(responses, entry_bytes, entry_dtype, threshold)
    blob = wire.serialize_response_list(responses)
    names = sorted({n for r in responses for n in r.tensor_names})
    n = len(names)
    name_arr = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in names])
    bytes_arr = (ctypes.c_int64 * n)(*[entry_bytes(s) for s in names])
    dtype_arr = (ctypes.c_char_p * n)(
        *[entry_dtype(s).encode("utf-8") for s in names])
    out = ctypes.c_void_p()
    rc = lib.htpu_plan_tick(blob, len(blob), name_arr, bytes_arr, dtype_arr,
                            n, threshold, ctypes.byref(out))
    fused, _, _ = wire.parse_response_list(_take_buffer(lib, out, rc))
    return fused


def cpp_resolve_algo(pref: str, nbytes: int, num_hosts: int, num_procs: int,
                     crossover_bytes: int) -> str:
    """Native allreduce-algorithm selection ("" = flat ring)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native scheduler not available")
    out = ctypes.c_void_p()
    rc = lib.htpu_resolve_algo(pref.encode("utf-8"), nbytes, num_hosts,
                               num_procs, crossover_bytes, ctypes.byref(out))
    return _take_buffer(lib, out, rc).decode("utf-8")


def wire_request_list_roundtrip(frame: bytes):
    """Parse + re-serialize a RequestList frame through the native codec
    (the py<->cpp framing parity hook; payload codecs have their own
    htpu_wire_encode/decode endpoints).  Returns the re-serialized bytes,
    or None without the native core.  Raises
    ValueError when the native parser rejects the frame."""
    lib = load()
    if lib is None:
        return None
    cap = len(frame) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.htpu_wire_request_list_roundtrip(frame, len(frame), out, cap)
    if n < 0:
        raise ValueError("native RequestList parse rejected the frame")
    return out.raw[:n]



def _parse_stall_records(data: bytes):
    """Decode the stall wire format (c_api.cc SerializeStallRecords):
    repeated { name_len:i32 name age:f64 n_missing:i32 ranks:i32[n] },
    little-endian.  Returns ``(name, age_s, missing_ranks)`` triples."""
    import struct
    result, pos = [], 0
    while pos < len(data):
        (nlen,) = struct.unpack_from("<i", data, pos)
        pos += 4
        name = data[pos:pos + nlen].decode("utf-8")
        pos += nlen
        (age,) = struct.unpack_from("<d", data, pos)
        pos += 8
        (nmiss,) = struct.unpack_from("<i", data, pos)
        pos += 4
        ranks = list(struct.unpack_from(f"<{nmiss}i", data, pos))
        pos += 4 * nmiss
        result.append((name, age, ranks))
    return result


def metrics_snapshot() -> dict:
    """JSON snapshot of the native metrics registry (cpp/htpu/metrics.h):
    ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``.
    Empty dict when the native core is unavailable."""
    import json
    lib = load()
    if lib is None:
        return {}
    out = ctypes.c_void_p()
    n = lib.htpu_metrics_snapshot(ctypes.byref(out))
    if n < 0:
        return {}
    return json.loads(_take_buffer(lib, out, n).decode("utf-8"))


def crc32c_native(data: bytes):
    """CRC32C (Castagnoli) via the native runtime-dispatched path (SSE4.2
    when available); ``None`` when the native core is unavailable —
    callers fall back to the pure-Python table in horovod_tpu_torch.wire."""
    lib = load()
    if lib is None:
        return None
    return int(lib.htpu_crc32c(data, len(data)))


class CppControlPlane:
    """Multi-process control + eager data plane (TCP, native).

    Replaces the reference's MPI gather/bcast negotiation and CPU MPI data
    plane (``operations.cc:1665-1903, 1232-1353``).  Process 0 is the
    coordinator; construction blocks until the whole job is connected.
    """

    def __init__(self, process_index: int, process_count: int, host: str,
                 port: int, first_rank: int, nranks_total: int,
                 timeout_ms: int = 60000):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native core not available")
        # Serializes destruction against an attached timeline's __del__
        # detach (CppTimeline.__del__): without it the detach could call
        # into a plane freed between its pointer snapshot and the ctypes
        # call.
        self._teardown_lock = threading.Lock()
        self._ptr = self._lib.htpu_control_create(
            process_index, process_count, host.encode("utf-8"), port,
            first_rank, nranks_total, timeout_ms)
        if not self._ptr:
            raise ConnectionError(
                f"control plane failed to form (coordinator {host}:{port}, "
                f"process {process_index}/{process_count})")

    def tick(self, request_list_blob: bytes,
             fusion_threshold: int) -> bytes:
        out = ctypes.c_void_p()
        n = self._lib.htpu_control_tick(
            self._ptr, request_list_blob, len(request_list_blob),
            fusion_threshold, ctypes.byref(out))
        if n < 0:
            raise ConnectionError("control-plane tick failed")
        return _take_buffer(self._lib, out, n)

    def allreduce(self, dtype: str, data, wire_dtype: str = "",
                  algo: str = "") -> bytes:
        """Allreduce ``data`` (bytes, or a C-contiguous numpy array —
        arrays are read straight from their buffer, skipping a
        ``tobytes`` copy; the payload path is copy-bound at multi-MB
        gradients).  ``wire_dtype`` selects the ring wire compression
        ("" = raw; "bf16"/"fp16"/"int8", float32 payloads only — see
        cpp/htpu/quantize.h).  ``algo`` is the coordinator-resolved
        collective algorithm ("" = flat ring; "hier" = two-level
        hierarchical; "small" = latency-optimal small-tensor path —
        cpp/htpu/control.h)."""
        import numpy as np
        if isinstance(data, np.ndarray):
            if not data.flags["C_CONTIGUOUS"]:
                data = np.ascontiguousarray(data)
            ptr, length = data.ctypes.data, data.nbytes
        else:
            ptr, length = data, len(data)
        out = ctypes.c_void_p()
        n = self._lib.htpu_control_allreduce_algo(
            self._ptr, dtype.encode("utf-8"), wire_dtype.encode("utf-8"),
            algo.encode("utf-8"), ptr, length, ctypes.byref(out))
        if n < 0:
            raise ConnectionError(
                "data-plane allreduce failed"
                + (f" (wire dtype {wire_dtype!r})" if wire_dtype else "")
                + (f" (algo {algo!r})" if algo else ""))
        return _take_buffer(self._lib, out, n)

    def allgather(self, data: bytes) -> bytes:
        out = ctypes.c_void_p()
        n = self._lib.htpu_control_allgather(
            self._ptr, data, len(data), ctypes.byref(out))
        if n < 0:
            raise ConnectionError("data-plane allgather failed")
        return _take_buffer(self._lib, out, n)

    def broadcast(self, root_process: int, data: bytes) -> bytes:
        out = ctypes.c_void_p()
        n = self._lib.htpu_control_broadcast(
            self._ptr, root_process, data, len(data), ctypes.byref(out))
        if n < 0:
            raise ConnectionError("data-plane broadcast failed")
        return _take_buffer(self._lib, out, n)

    def data_bytes(self):
        """(sent, received) cumulative eager data-plane payload bytes of
        this process — the ring keeps both O(payload) per collective
        regardless of process count."""
        sent = ctypes.c_longlong()
        recvd = ctypes.c_longlong()
        self._lib.htpu_control_data_bytes(self._ptr, ctypes.byref(sent),
                                          ctypes.byref(recvd))
        return sent.value, recvd.value

    def stalled(self, age_s: float):
        out = ctypes.c_void_p()
        n = self._lib.htpu_control_stalled(self._ptr, age_s,
                                           ctypes.byref(out))
        return _parse_stall_records(_take_buffer(self._lib, out, n))

    def set_xfer_context(self, tensors: str) -> None:
        """Name the tensors of the collective about to run; a checked
        transfer that exhausts its retransmit budget folds this into the
        attributed error (HOROVOD_TPU_INTEGRITY)."""
        self._lib.htpu_control_set_xfer_context(
            self._ptr, tensors.encode("utf-8", "replace"))

    def last_error(self):
        """Attribution of the most recent native failure on this process:
        ``(failed_first_rank, reason)`` — rank is -1 when nothing failed.
        Read after a ConnectionError from the data plane to build the
        worker's abort report."""
        rank = ctypes.c_int(-1)
        out = ctypes.c_void_p()
        n = self._lib.htpu_control_last_error(self._ptr, ctypes.byref(rank),
                                              ctypes.byref(out))
        reason = _take_buffer(self._lib, out, n).decode("utf-8", "replace")
        return rank.value, reason

    def close(self):
        if getattr(self, "_leaked", False):
            return   # pointer stays valid for the wedged thread; no free
        with self._teardown_lock:
            ptr, self._ptr = self._ptr, None
            if ptr:
                self._lib.htpu_control_destroy(ptr)

    def leak(self):
        """Disarm destruction WITHOUT invalidating the pointer — for
        shutdown with a wedged background thread still inside (or about
        to make) a control-plane call: destroying would be a
        use-after-free, and nulling the pointer would turn the thread's
        next ctypes call into a NULL dereference in C++.  The object is
        reclaimed by process exit."""
        self._leaked = True

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass


class CppTimeline:
    """Native Chrome-trace writer with the interface of
    :class:`horovod_tpu_torch.timeline.Timeline`.

    Every method tolerates a closed timeline (no-op) — the executor may race
    a late span against ``Controller.stop()``'s close, and calling into C++
    with a destroyed object would crash the interpreter where the Python
    fallback merely raises.
    """

    def __init__(self, path: str, rank: int = 0):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native core not available")
        self._ptr = self._lib.htpu_timeline_create_rank(
            path.encode("utf-8"), int(rank))
        if not self._ptr:
            raise OSError(f"cannot open timeline file: {path}")
        self.rank = rank

    def attach_to_control(self, control: "CppControlPlane") -> None:
        """Wire this writer into the native coordinator so its Tick loop
        emits NEGOTIATE_* spans (multi-process mode negotiates in C++,
        bypassing the Python MessageTable's timeline hooks).  Lifetime:
        the Controller closes the control plane before this timeline; for
        teardown paths that skip the Controller (no hvd.shutdown), the
        weakref lets ``__del__`` detach instead of destroying under the
        coordinator's raw pointer."""
        if self._ptr and control._ptr:
            import weakref
            self._lib.htpu_control_set_timeline(control._ptr, self._ptr)
            self._control_ref = weakref.ref(control)

    def negotiate_start(self, tensor_name: str, request_type) -> None:
        if not self._ptr:
            return
        self._lib.htpu_timeline_negotiate_start(
            self._ptr, tensor_name.encode("utf-8"), int(request_type))

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        if not self._ptr:
            return
        self._lib.htpu_timeline_negotiate_rank_ready(
            self._ptr, tensor_name.encode("utf-8"), rank)

    def negotiate_end(self, tensor_name: str) -> None:
        if not self._ptr:
            return
        self._lib.htpu_timeline_negotiate_end(
            self._ptr, tensor_name.encode("utf-8"))

    def start(self, tensor_name: str, response_type) -> None:
        if not self._ptr:
            return
        self._lib.htpu_timeline_start(
            self._ptr, tensor_name.encode("utf-8"), int(response_type))

    def end(self, tensor_name: str) -> None:
        if not self._ptr:
            return
        self._lib.htpu_timeline_end(self._ptr, tensor_name.encode("utf-8"))

    def activity_start_all(self, entries, activity: str) -> None:
        if not self._ptr:
            return
        for e in entries:
            self._lib.htpu_timeline_activity_start(
                self._ptr, e.name.encode("utf-8"), activity.encode("utf-8"))

    def activity_end_all(self, entries) -> None:
        if not self._ptr:
            return
        for e in entries:
            self._lib.htpu_timeline_activity_end(
                self._ptr, e.name.encode("utf-8"))

    def counter(self, name: str, value: int) -> None:
        """Chrome-trace counter sample ("ph": "C") — queue depth, bytes in
        flight — rendered by Perfetto as a rate track."""
        if not self._ptr:
            return
        self._lib.htpu_timeline_counter(
            self._ptr, name.encode("utf-8"), int(value))

    def cache_hit_tick(self, dur_us: int) -> None:
        """CACHED_TICK complete-event span — a negotiation tick served
        entirely from the response cache."""
        if not self._ptr:
            return
        self._lib.htpu_timeline_cache_hit_tick(self._ptr, int(dur_us))

    def flush(self) -> None:
        if self._ptr:
            self._lib.htpu_timeline_flush(self._ptr)

    def leak(self):
        """Abandon the native writer WITHOUT destroying it — for shutdown
        with a wedged background thread whose control plane still holds
        the raw Timeline pointer (see Controller.stop).  The file is
        finalized best-effort: ``htpu_timeline_close`` only closes the
        stream under the object's own mutex and every later write no-ops,
        so the wedged thread can still call through its stale pointer
        safely — only ``htpu_timeline_destroy`` is the use-after-free
        hazard, and that never runs for a leaked writer (``__del__`` sees
        a null ``_ptr``).  The close runs on a bounded-wait daemon
        thread: in the usual wedge (thread stuck in a control-plane recv)
        the timeline mutex is free and it finishes instantly, but a
        writer wedged INSIDE ``Emit`` (full disk, hung NFS) holds that
        mutex, and leak() must never convert a 90 s join timeout into an
        unbounded hang of shutdown itself."""
        ptr, self._ptr = self._ptr, None
        if ptr:
            import threading

            def _close():
                try:
                    self._lib.htpu_timeline_close(ptr)
                except Exception:   # noqa: BLE001 — best-effort finalize
                    pass

            t = threading.Thread(target=_close, daemon=True,
                                 name="htpu-timeline-leak-close")
            t.start()
            t.join(timeout=2.0)

    def close(self):
        # Close only finalizes the file; the C++ object stays alive (its
        # methods no-op once closed, under its own mutex) so a racing span
        # from the executor can never hit freed memory.  The object itself
        # is destroyed when this wrapper is garbage collected.
        if self._ptr:
            self._lib.htpu_timeline_close(self._ptr)

    def __del__(self):
        try:
            ptr, self._ptr = self._ptr, None
            if not ptr:
                return
            self._lib.htpu_timeline_close(ptr)
            ctrl = (self._control_ref()
                    if hasattr(self, "_control_ref") else None)
            if ctrl is not None:
                # Interpreter teardown without hvd.shutdown(): the native
                # coordinator may still hold this raw pointer while its
                # tick caller (a daemon thread) is mid-call.  Under the
                # plane's teardown lock — so a concurrent close() cannot
                # destroy the plane between the pointer read and the
                # call — detach so new ticks see no timeline, and LEAK
                # the object instead of destroying under a
                # possibly-in-flight span: a stale pointer into the
                # closed-but-alive writer is a locked no-op, a destroyed
                # one is a use-after-free.  Bounded acquire: this
                # finalizer can run via cyclic GC ON the thread currently
                # holding the lock inside close() — a blocking acquire
                # there would deadlock the interpreter; on timeout, leak
                # the writer without detaching (still safe: close() only
                # destroys the PLANE, and this writer is never destroyed).
                if not ctrl._teardown_lock.acquire(timeout=2.0):
                    return
                try:
                    ctrl_ptr = getattr(ctrl, "_ptr", None)
                    if ctrl_ptr:
                        self._lib.htpu_control_set_timeline(ctrl_ptr, None)
                        return
                finally:
                    ctrl._teardown_lock.release()
                # Plane already closed: nothing references the writer any
                # more — destroying it below is safe.
            self._lib.htpu_timeline_destroy(ptr)
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass
