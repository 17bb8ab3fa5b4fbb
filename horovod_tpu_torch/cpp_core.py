"""ctypes binding of the framework-agnostic native core (``cpp/htpu``).

Port of ``horovod_tpu/cpp_core.py``: ``load`` / ``available`` /
``_configure`` (:35, :395, :438), the flight recorder (:455-512: record,
dump, snapshot, capacity, rank), :class:`CppMessageTable` (:515),
:func:`cpp_plan_fusion` (:581), :func:`cpp_plan_tick` (:611),
:func:`cpp_resolve_algo` (:632), :class:`CppControlPlane` (:1202),
:class:`CppTimeline` (:1383), the metrics snapshot and reset, the wire
codec hooks (:941-993), ``sum_into`` (:995), CRC32C (:1174-1200), the
request-list round trip, the aggregation tier's ``agg_merge`` /
``agg_roundtrip`` (:1054-1083); :class:`NativeBucketPlanner` (:644) and
the observatory bindings (:1086-1171); the fleet policy's bindings
(:275-337) and :class:`NativeFleetPolicy` (:705) with its precision
ladder (:787-835); the multi-tenant process-set registry,
:class:`CppProcessSetTable` (:854-939).

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
    lib.htpu_control_membership.restype = None
    lib.htpu_control_membership.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.htpu_control_elastic.restype = ctypes.c_int
    lib.htpu_control_elastic.argtypes = [ctypes.c_void_p]
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
    # The multi-tenant process-set registry (cpp/htpu/process_set.h).
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, res, args in (
            ("create", vp, [ctypes.c_longlong]),
            ("destroy", None, [vp]),
            ("parse_spec", ci, [vp, ctypes.c_char_p]),
            ("add", ci, [vp, ctypes.c_char_p, ctypes.POINTER(ci), ci]),
            ("remove", ci, [vp, ci]),
            ("id_of", ci, [vp, ctypes.c_char_p]),
            ("count", ci, [vp]),
            ("size", ci, [vp, ci]),
            ("local_rank", ci, [vp, ci, ci]),
            ("generation", ci, [vp, ci]),
            ("reconfigure", ci, [vp, ci, ci]),
            ("increment", ci, [vp, ci, ctypes.c_char_p, ci]),
            ("construct", ci, [vp, ci, ctypes.c_char_p,
                               ctypes.POINTER(vp)])):
        f = getattr(lib, f"htpu_process_sets_{fn}")
        f.restype = res
        f.argtypes = args
    lib.htpu_sched_create.restype = ctypes.c_void_p
    lib.htpu_sched_create.argtypes = [ctypes.c_int64]
    lib.htpu_sched_destroy.restype = None
    lib.htpu_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.htpu_sched_register.restype = ctypes.c_int
    lib.htpu_sched_register.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    for fn in ("seal", "next_issue", "all_complete"):
        f = getattr(lib, f"htpu_sched_{fn}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p]
    for fn in ("bucket_of", "note_ready"):
        f = getattr(lib, f"htpu_sched_{fn}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.htpu_sched_bucket_bytes.restype = ctypes.c_int64
    lib.htpu_sched_bucket_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.htpu_sched_note_complete.restype = None
    lib.htpu_sched_note_complete.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.htpu_sched_reset.restype = None
    lib.htpu_sched_reset.argtypes = [ctypes.c_void_p]
    lib.htpu_observe_enabled.restype = ctypes.c_int
    lib.htpu_observe_enabled.argtypes = []
    lib.htpu_observe_set_enabled.restype = None
    lib.htpu_observe_set_enabled.argtypes = [ctypes.c_int]
    lib.htpu_observe_note_step.restype = None
    lib.htpu_observe_note_step.argtypes = [ctypes.c_double] * 5
    lib.htpu_observe_snapshot.restype = ctypes.c_int
    lib.htpu_observe_snapshot.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.htpu_observe_reset.restype = None
    lib.htpu_observe_reset.argtypes = []
    # The fleet policy (htpu::FleetPolicy): straggler state, per-set
    # state and the precision ladder.
    vp, ci, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    counts = ctypes.POINTER(ctypes.c_longlong)
    for fn, res, args in (
            ("create", vp, []),
            ("destroy", None, [vp]),
            ("active", ci, [vp]),
            ("observe", None, [vp, ctypes.c_int64, ctypes.POINTER(dbl), ci]),
            ("next_eviction", ci, [vp, ci, ci]),
            ("rerank", None, [vp, ctypes.POINTER(ci), ci]),
            ("autoscale_target", ci, [vp, ctypes.c_int64]),
            ("ewma", dbl, [vp, ci]),
            ("consecutive_slow", ci, [vp, ci]),
            ("observe_set", None, [vp, ci, ctypes.POINTER(dbl), ci]),
            ("ewma_set", dbl, [vp, ci, ci]),
            ("consecutive_slow_set", ci, [vp, ci, ci]),
            ("next_eviction_set", ci, [vp, ci, ci, ci]),
            ("precision_auto", ci, [vp]),
            ("precision_observe", None, [vp, ctypes.c_char_p, dbl]),
            ("precision_bandwidth", None, [vp, dbl]),
            ("precision_level", ci, [vp, ctypes.c_char_p]),
            ("precision_ewma", dbl, [vp, ctypes.c_char_p]),
            ("precision_counts", None, [vp, counts]),
            ("precision_dirty", ci, [vp])):
        f = getattr(lib, f"htpu_policy_{fn}")
        f.restype = res
        f.argtypes = args
    # The unit-test hooks and the rest of the reference's surface
    # (horovod_tpu/cpp_core.py), under the reference's guards.
    lib.htpu_wire_roundtrip.restype = ctypes.c_longlong
    lib.htpu_wire_roundtrip.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    for fn in ("htpu_wire_encode", "htpu_wire_decode"):
        f = getattr(lib, fn, None)
        if f is not None:
            f.restype = ctypes.c_longlong
            f.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_void_p]
    if hasattr(lib, "htpu_wire_bytes"):
        lib.htpu_wire_bytes.restype = ctypes.c_longlong
        lib.htpu_wire_bytes.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.htpu_sum_into.restype = ctypes.c_int
    lib.htpu_sum_into.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong]
    lib.htpu_metrics_reset.restype = None
    lib.htpu_metrics_reset.argtypes = []
    if hasattr(lib, "htpu_flight_record"):
        lib.htpu_flight_set_capacity.restype = None
        lib.htpu_flight_set_capacity.argtypes = [ctypes.c_longlong]
        lib.htpu_flight_set_rank.restype = None
        lib.htpu_flight_set_rank.argtypes = [ctypes.c_int]
        lib.htpu_flight_snapshot.restype = ctypes.c_int
        lib.htpu_flight_snapshot.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    if hasattr(lib, "htpu_observe_enabled"):
        lib.htpu_observe_record_xfer.restype = None
        lib.htpu_observe_record_xfer.argtypes = [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_double]
        lib.htpu_observe_trailer_encode.restype = ctypes.c_int
        lib.htpu_observe_trailer_encode.argtypes = [
            ctypes.POINTER(ctypes.c_void_p)]
        lib.htpu_observe_trailer_probe.restype = ctypes.c_int
        lib.htpu_observe_trailer_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    # The aggregation tier of the hierarchical control topology.
    if hasattr(lib, "htpu_agg_merge"):
        lib.htpu_agg_merge.restype = ctypes.c_int
        lib.htpu_agg_merge.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.htpu_agg_roundtrip.restype = ctypes.c_int
        lib.htpu_agg_roundtrip.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    if hasattr(lib, "htpu_crc32c"):
        lib.htpu_crc32c_sw.restype = ctypes.c_uint
        lib.htpu_crc32c_sw.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.htpu_crc32c_hw.restype = ctypes.c_int
        lib.htpu_crc32c_hw.argtypes = []


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


def _flight_lib():
    """The loaded library iff it exports the flight-recorder API, else
    None -- the helpers below are no-ops without the native core."""
    lib = load()
    if lib is None or not hasattr(lib, "htpu_flight_record"):
        return None
    return lib


def flight_set_capacity(events: int) -> None:
    """Resize the ring to ``events`` events (drops what it holds)."""
    lib = _flight_lib()
    if lib is not None:
        lib.htpu_flight_set_capacity(int(events))


def flight_set_rank(rank: int) -> None:
    lib = _flight_lib()
    if lib is not None:
        lib.htpu_flight_set_rank(int(rank))


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


def flight_snapshot(why: str = "snapshot") -> str:
    """The ring serialized as JSON (without touching disk); "" when the
    native core is absent.  Its ``events`` carry the fleet policy's
    ``policy.evict``, ``policy.rescale`` and ``policy.rerank`` records
    with the tick of each."""
    lib = _flight_lib()
    if lib is None:
        return ""
    out = ctypes.c_void_p()
    n = lib.htpu_flight_snapshot(why.encode("utf-8"), ctypes.byref(out))
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


class NativeBucketPlanner:
    """ctypes wrapper over the C++ backward-overlap bucket planner
    (``htpu::BucketPlanner``).  Same surface as the pure-Python
    :class:`horovod_tpu_torch.scheduler.PyBucketPlanner`."""

    def __init__(self, bucket_bytes: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native scheduler not available")
        self._lib = lib
        self._ptr = lib.htpu_sched_create(int(bucket_bytes))

    def close(self) -> None:
        if self._ptr:
            self._lib.htpu_sched_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 -- interpreter teardown
            pass

    def register_leaf(self, name: str, nbytes: int, dtype: str) -> int:
        return self._lib.htpu_sched_register(
            self._ptr, name.encode("utf-8"), int(nbytes),
            dtype.encode("utf-8"))

    def seal(self) -> int:
        return self._lib.htpu_sched_seal(self._ptr)

    def bucket_of(self, leaf: int) -> int:
        return self._lib.htpu_sched_bucket_of(self._ptr, int(leaf))

    def bucket_bytes(self, bucket: int) -> int:
        return self._lib.htpu_sched_bucket_bytes(self._ptr, int(bucket))

    def note_ready(self, leaf: int) -> int:
        return self._lib.htpu_sched_note_ready(self._ptr, int(leaf))

    def next_issue(self) -> int:
        return self._lib.htpu_sched_next_issue(self._ptr)

    def note_complete(self, bucket: int) -> None:
        self._lib.htpu_sched_note_complete(self._ptr, int(bucket))

    def all_complete(self) -> bool:
        return bool(self._lib.htpu_sched_all_complete(self._ptr))

    def reset(self) -> None:
        self._lib.htpu_sched_reset(self._ptr)


# ------------------------------------------------------------ fleet policy

class NativeFleetPolicy:
    """ctypes wrapper over the C++ fleet-policy decision engine
    (reference ``cpp_core.py:705-835``): the decision surface of the
    pure-Python :class:`horovod_tpu_torch.policy.FleetPolicy` --
    straggler eviction, re-rank and autoscale, per-set state and the
    precision ladder -- for parity tests and offline replay.  The in-job
    policy lives inside the native ControlPlane itself, which creates it
    from the same environment knobs."""

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("native fleet policy not available")
        self._lib = lib
        self._ptr = lib.htpu_policy_create()

    def close(self) -> None:
        if self._ptr:
            self._lib.htpu_policy_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 -- interpreter teardown
            pass

    def active(self) -> bool:
        return bool(self._lib.htpu_policy_active(self._ptr))

    def observe_tick(self, tick: int, wait_s) -> None:
        n = len(wait_s)
        arr = (ctypes.c_double * n)(*[float(w) for w in wait_s])
        self._lib.htpu_policy_observe(self._ptr, int(tick), arr, n)

    def next_eviction(self, process_count: int, seat_available: bool) -> int:
        return self._lib.htpu_policy_next_eviction(
            self._ptr, int(process_count), 1 if seat_available else 0)

    def rerank_order(self, old_pidx):
        n = len(old_pidx)
        arr = (ctypes.c_int * n)(*[int(p) for p in old_pidx])
        self._lib.htpu_policy_rerank(self._ptr, arr, n)
        return list(arr)

    def autoscale_target(self, tick: int) -> int:
        return self._lib.htpu_policy_autoscale_target(self._ptr, int(tick))

    def ewma(self, proc: int) -> float:
        return float(self._lib.htpu_policy_ewma(self._ptr, int(proc)))

    def consecutive_slow(self, proc: int) -> int:
        return self._lib.htpu_policy_consecutive_slow(self._ptr, int(proc))

    def observe_tick_set(self, process_set: int, wait_s) -> None:
        n = len(wait_s)
        arr = (ctypes.c_double * n)(*[float(w) for w in wait_s])
        self._lib.htpu_policy_observe_set(self._ptr, int(process_set), arr, n)

    def ewma_set(self, process_set: int, proc: int) -> float:
        return float(self._lib.htpu_policy_ewma_set(
            self._ptr, int(process_set), int(proc)))

    def consecutive_slow_set(self, process_set: int, proc: int) -> int:
        return self._lib.htpu_policy_consecutive_slow_set(
            self._ptr, int(process_set), int(proc))

    def next_eviction_set(self, process_set: int, process_count: int,
                          seat_available: bool) -> int:
        return self._lib.htpu_policy_next_eviction_set(
            self._ptr, int(process_set), int(process_count),
            1 if seat_available else 0)

    # -- the precision ladder

    def precision_auto(self) -> bool:
        return bool(self._lib.htpu_policy_precision_auto(self._ptr))

    def observe_precision(self, name: str, residual_norm: float) -> None:
        self._lib.htpu_policy_precision_observe(
            self._ptr, name.encode(), float(residual_norm))

    def note_precision_bandwidth(self, min_leg_bps: float) -> None:
        self._lib.htpu_policy_precision_bandwidth(self._ptr,
                                                  float(min_leg_bps))

    def precision_level(self, name: str) -> int:
        return self._lib.htpu_policy_precision_level(self._ptr,
                                                     name.encode())

    def precision_wire(self, name: str) -> str:
        from horovod_tpu_torch.policy import PRECISION_WIRE
        return PRECISION_WIRE[self.precision_level(name)]

    def precision_ewma(self, name: str) -> float:
        return float(self._lib.htpu_policy_precision_ewma(self._ptr,
                                                          name.encode()))

    def _precision_counts(self):
        counts = (ctypes.c_longlong * 2)()
        self._lib.htpu_policy_precision_counts(self._ptr, counts)
        return int(counts[0]), int(counts[1])

    @property
    def precision_promotions(self) -> int:
        return self._precision_counts()[0]

    @property
    def precision_demotions(self) -> int:
        return self._precision_counts()[1]

    def take_precision_dirty(self) -> bool:
        return bool(self._lib.htpu_policy_precision_dirty(self._ptr))


# ------------------------------------------------------------ observatory

def observe_enabled():
    """Native observatory state: True/False, or ``None`` when the native
    core is unavailable."""
    lib = load()
    if lib is None:
        return None
    return bool(lib.htpu_observe_enabled())


def observe_set_enabled(on: bool) -> None:
    """Flip the native observatory at runtime (A/B runs, tests)."""
    lib = load()
    if lib is not None:
        lib.htpu_observe_set_enabled(1 if on else 0)


def observe_note_step(step_s: float, compute_s: float = 0.0,
                      hidden_s: float = 0.0, exposed_s: float = 0.0,
                      stall_s: float = 0.0) -> bool:
    """Feed one step's decomposition to the native observatory; returns
    False when the native core is unavailable (the caller falls back to
    the Python registry)."""
    lib = load()
    if lib is None:
        return False
    lib.htpu_observe_note_step(step_s, compute_s, hidden_s, exposed_s,
                               stall_s)
    return True


def observe_snapshot() -> dict:
    """Local telemetry digest (step EWMAs, per-leg bandwidth EWMAs,
    inflight) as a dict; empty when the native core is unavailable."""
    import json
    lib = load()
    if lib is None:
        return {}
    out = ctypes.c_void_p()
    n = lib.htpu_observe_snapshot(ctypes.byref(out))
    if n < 0:
        return {}
    return json.loads(_take_buffer(lib, out, n).decode("utf-8"))


def observe_reset() -> None:
    """Zero the native observatory's EWMAs and counts (tests, A/B runs)."""
    lib = load()
    if lib is not None:
        lib.htpu_observe_reset()


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



class CppProcessSetTable:
    """ctypes wrapper over the native multi-tenant process-set registry
    (cpp/htpu/process_set.h), with the interface of the Python mirror in
    :mod:`horovod_tpu_torch.process_set`.  Set ids start at 1; 0 is the
    implicit default/world set."""

    def __init__(self, cache_capacity: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError("native process sets not available")
        self._lib = lib
        self._ptr = lib.htpu_process_sets_create(int(cache_capacity))

    def close(self) -> None:
        if self._ptr:
            self._lib.htpu_process_sets_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 -- best-effort at collection
            pass

    def parse_spec(self, spec: str) -> bool:
        return bool(self._lib.htpu_process_sets_parse_spec(
            self._ptr, spec.encode("utf-8")))

    def add(self, name: str, ranks) -> int:
        n = len(ranks)
        arr = (ctypes.c_int * n)(*[int(r) for r in ranks])
        return self._lib.htpu_process_sets_add(
            self._ptr, name.encode("utf-8"), arr, n)

    def remove(self, set_id: int) -> bool:
        return bool(self._lib.htpu_process_sets_remove(self._ptr,
                                                       int(set_id)))

    def id_of(self, name: str) -> int:
        return self._lib.htpu_process_sets_id_of(self._ptr,
                                                 name.encode("utf-8"))

    def count(self) -> int:
        return self._lib.htpu_process_sets_count(self._ptr)

    def size_of(self, set_id: int) -> int:
        return self._lib.htpu_process_sets_size(self._ptr, int(set_id))

    def local_rank(self, set_id: int, global_rank: int) -> int:
        return self._lib.htpu_process_sets_local_rank(
            self._ptr, int(set_id), int(global_rank))

    def generation(self, set_id: int) -> int:
        return self._lib.htpu_process_sets_generation(self._ptr, int(set_id))

    def reconfigure(self, set_id: int, lost_global_rank: int) -> int:
        return self._lib.htpu_process_sets_reconfigure(
            self._ptr, int(set_id), int(lost_global_rank))

    def increment(self, set_id: int, msg: Request) -> int:
        # The single-message boundary format of CppMessageTable.increment
        # (always with_algo; the set id is the explicit argument, never
        # re-read from the frame).
        data = wire.serialize_request(msg, with_algo=True)
        return self._lib.htpu_process_sets_increment(
            self._ptr, int(set_id), data, len(data))

    def construct_response(self, set_id: int, name: str) -> Response:
        out = ctypes.c_void_p()
        n = self._lib.htpu_process_sets_construct(
            self._ptr, int(set_id), name.encode("utf-8"), ctypes.byref(out))
        if n < 0:
            raise KeyError(f"unknown process set {set_id}")
        resp = wire.parse_single_response(_take_buffer(self._lib, out, n))
        resp.process_set = int(set_id)
        return resp


def wire_roundtrip(wire_dtype: str, values):
    """Encode -> decode a float32 array through the ring wire codec
    (chunked exactly like the data plane); returns ``(decoded,
    wire_bytes)``.  Unit-test hook for the quantizers."""
    import numpy as np
    lib = load()
    if lib is None:
        raise RuntimeError("native core not available")
    arr = np.ascontiguousarray(values, dtype=np.float32)
    out = np.empty_like(arr)
    nbytes = lib.htpu_wire_roundtrip(
        wire_dtype.encode("utf-8"), arr.ctypes.data, arr.size,
        out.ctypes.data)
    if nbytes < 0:
        raise ValueError(f"unknown wire dtype: {wire_dtype!r}")
    return out, int(nbytes)


def wire_encode(wire_dtype: str, values) -> bytes:
    """Encode a float32 array into the ring's wire image
    (``EncodeWireChunk`` framing, per 64K-element sub-chunk)."""
    import numpy as np
    lib = load()
    if lib is None or getattr(lib, "htpu_wire_encode", None) is None:
        raise RuntimeError("native core wire codec not available")
    arr = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    total = lib.htpu_wire_bytes(wire_dtype.encode("utf-8"), arr.size)
    if total < 0:
        raise ValueError(f"unknown wire dtype: {wire_dtype!r}")
    out = np.empty(int(total), dtype=np.uint8)
    rc = lib.htpu_wire_encode(wire_dtype.encode("utf-8"), arr.ctypes.data,
                              arr.size, out.ctypes.data)
    if rc < 0:
        raise ValueError(f"wire encode failed for {wire_dtype!r}")
    return out.tobytes()


def wire_decode(wire_dtype: str, buf: bytes, n_elems: int):
    """Decode a wire image produced by :func:`wire_encode` back to
    float32."""
    import numpy as np
    lib = load()
    if lib is None or getattr(lib, "htpu_wire_decode", None) is None:
        raise RuntimeError("native core wire codec not available")
    inp = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n_elems, dtype=np.float32)
    rc = lib.htpu_wire_decode(wire_dtype.encode("utf-8"), inp.ctypes.data,
                              n_elems, out.ctypes.data)
    if rc < 0:
        raise ValueError(f"wire decode failed for {wire_dtype!r}")
    return out


def sum_into(dtype: str, acc, inp) -> None:
    """Native ``acc += inp`` elementwise (reduce.h SumInto) on two
    C-contiguous same-size numpy arrays; ``dtype`` is the htpu dtype name
    (may differ from the arrays' numpy dtype -- e.g. "bfloat16" over
    uint16 storage)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native core not available")
    if acc.nbytes != inp.nbytes:
        raise ValueError("size mismatch")
    rc = lib.htpu_sum_into(dtype.encode("utf-8"), acc.ctypes.data,
                           inp.ctypes.data, acc.nbytes)
    if rc != 0:
        raise ValueError(f"SumInto failed for dtype {dtype!r}")


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


def metrics_reset() -> None:
    """Zero every native counter/gauge/histogram (tests, bench windows)."""
    lib = load()
    if lib is not None:
        lib.htpu_metrics_reset()


def agg_merge(a: bytes, b: bytes):
    """Fold serialized aggregation container ``b`` into ``a`` through the
    native merge (cpp/htpu/aggregate.cc) and return the canonical merged
    container bytes; ``None`` without the native core; ``ValueError`` on
    a corrupt container -- the seam that holds
    :mod:`horovod_tpu_torch.aggregate` to the native code."""
    lib = load()
    if lib is None or not hasattr(lib, "htpu_agg_merge"):
        return None
    out = ctypes.c_void_p()
    n = lib.htpu_agg_merge(a, len(a), b, len(b), ctypes.byref(out))
    if n < 0:
        raise ValueError("corrupt aggregation container")
    return _take_buffer(lib, out, n)


def agg_roundtrip(buf: bytes):
    """Parse + canonically re-serialize one aggregation container through
    the native code; ``None`` without the native core; ``ValueError`` on
    a corrupt container."""
    lib = load()
    if lib is None or not hasattr(lib, "htpu_agg_roundtrip"):
        return None
    out = ctypes.c_void_p()
    n = lib.htpu_agg_roundtrip(buf, len(buf), ctypes.byref(out))
    if n < 0:
        raise ValueError("corrupt aggregation container")
    return _take_buffer(lib, out, n)


def observe_record_xfer(leg: int, sent_bytes: int, recv_bytes: int,
                        seconds: float) -> None:
    """Test seam: record one transfer on leg 0..3 (classic/shm/uring/
    ctrl) without driving a real job."""
    lib = load()
    if lib is not None and hasattr(lib, "htpu_observe_record_xfer"):
        lib.htpu_observe_record_xfer(leg, sent_bytes, recv_bytes, seconds)


def observe_trailer_encode() -> bytes:
    """The telemetry trailer this process would append to its next tick
    frame -- b"" when the observatory is off."""
    lib = load()
    if lib is None or not hasattr(lib, "htpu_observe_trailer_encode"):
        return b""
    out = ctypes.c_void_p()
    n = lib.htpu_observe_trailer_encode(ctypes.byref(out))
    if n <= 0:
        return b""
    return _take_buffer(lib, out, n)


def observe_trailer_probe(blob: bytes) -> dict:
    """Strip-probe arbitrary frame bytes the way the coordinator does:
    ``{"stripped": bool, "payload_len": int, "sample": {...}}``; empty
    dict without the native core."""
    import json
    lib = load()
    if lib is None or not hasattr(lib, "htpu_observe_trailer_probe"):
        return {}
    out = ctypes.c_void_p()
    n = lib.htpu_observe_trailer_probe(blob, len(blob), ctypes.byref(out))
    if n < 0:
        return {}
    return json.loads(_take_buffer(lib, out, n).decode("utf-8"))


def crc32c_native(data):
    """CRC32C (Castagnoli) via the native runtime-dispatched path (SSE4.2
    when available); ``None`` when the native core is unavailable —
    callers fall back to the pure-Python table in horovod_tpu_torch.wire.
    ``data`` is bytes or a C-contiguous numpy array (a file's ``np.memmap``
    too), read in place."""
    lib = load()
    if lib is None:
        return None
    import numpy as np
    if isinstance(data, np.ndarray):
        if not data.flags["C_CONTIGUOUS"]:
            raise ValueError("crc32c_native: the array is not C-contiguous")
        return int(lib.htpu_crc32c(data.ctypes.data if data.nbytes else None,
                                   data.nbytes))
    return int(lib.htpu_crc32c(data, len(data)))


def crc32c_native_sw(data: bytes):
    """The native software (table) path, regardless of CPU support -- for
    pinning hardware == software == Python on the same inputs."""
    lib = load()
    if lib is None or not hasattr(lib, "htpu_crc32c_sw"):
        return None
    return int(lib.htpu_crc32c_sw(data, len(data)))


def crc32c_hardware() -> bool:
    """True when the native dispatcher selected the SSE4.2 path."""
    lib = load()
    if lib is None or not hasattr(lib, "htpu_crc32c_hw"):
        return False
    return bool(lib.htpu_crc32c_hw())


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

    def membership(self):
        """Current elastic membership identity of this process:
        ``(process_index, process_count, first_rank, generation)``
        (reference ``cpp_core.py:1314``).  All four change together on a
        RECONFIGURE; generation is 0 (and the rest Create-time constants)
        on a non-elastic plane."""
        pi = ctypes.c_int()
        pc = ctypes.c_int()
        fr = ctypes.c_int()
        gen = ctypes.c_int()
        self._lib.htpu_control_membership(
            self._ptr, ctypes.byref(pi), ctypes.byref(pc), ctypes.byref(fr),
            ctypes.byref(gen))
        return pi.value, pc.value, fr.value, gen.value

    def elastic(self) -> bool:
        """True when HOROVOD_TPU_ELASTIC=1 was honoured by this plane."""
        return bool(self._lib.htpu_control_elastic(self._ptr))

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
