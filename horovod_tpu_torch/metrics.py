"""Unified cross-layer metrics: the Python registry, the merge with the
native core's snapshot, and the live exporters.

Port of ``horovod_tpu/metrics.py`` (``MetricsRegistry`` :56, ``snapshot``
:138, ``prometheus_text`` :170, ``start_exporters`` / ``stop_exporters``
:279/:313), verbatim but for the package it reads the native core from.
Series names are the reference's, so ``tools/metrics_watch.py`` reads the
port's files unchanged.

Three layers feed one view:

* the native registry (``cpp/htpu/metrics.{h,cc}``) counts what the C++
  control/data plane does — bytes on the ring wire per negotiated dtype,
  tick/gather/broadcast latency, negotiation latency, aborts, stalls —
  snapshotted as JSON through ``htpu_metrics_snapshot()``;
* this module's :class:`MetricsRegistry` holds the controller-side series
  (enqueues and ops by type/dtype, handle wait time, fusion-buffer
  utilization, outstanding handles) that only exist in Python;
* :func:`snapshot` merges both under ``{"counters", "gauges",
  "histograms"}`` and is what ``hvd.metrics()`` returns.

Exporters (zero new dependencies):

* a JSON-lines emitter — one snapshot line every
  ``HOROVOD_TPU_METRICS_EVERY_S`` seconds to a per-rank file
  (``HOROVOD_TPU_METRICS_FILE`` or ``horovod_tpu_metrics.<rank>.jsonl``),
  tailed by ``tools/metrics_watch.py``;
* a rank-0 Prometheus text-exposition endpoint on
  ``HOROVOD_TPU_METRICS_PORT`` (stdlib ``http.server`` on a daemon
  thread), serving :func:`prometheus_text` at ``/metrics``.

Metric naming: ``family`` or ``family#label=value[,label2=value2]`` —
e.g. ``ring.allreduce.bytes_sent#wire=int8``.  The JSON snapshot keeps
the raw names; the Prometheus renderer splits labels out and sanitizes
dots to underscores (``htpu_ring_allreduce_bytes_sent{wire="int8"}``).

This module must not import :mod:`horovod_tpu_torch.core` at module scope
(core imports it); anything controller-shaped is resolved lazily.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import types
from typing import Dict, List, Optional, Sequence, Tuple

# Same default bucket ladder as the native registry (metrics.cc): spans
# 1us..10s, which covers control ticks through stalled collectives.
DEFAULT_SECONDS_BOUNDS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0,
    10.0)

# Fill-ratio ladder for the fusion-buffer utilization histogram.
RATIO_BOUNDS: Tuple[float, ...] = (
    0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class MetricsRegistry:
    """Thread-safe counters / gauges / fixed-bucket histograms, shaped
    exactly like the native snapshot so the two merge field-for-field."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        # name -> [bounds, counts(len=bounds+1), sum, count]
        self._histograms: Dict[str, list] = {}

    def inc(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float,
                bounds: Sequence[float] = DEFAULT_SECONDS_BOUNDS) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = [list(bounds), [0] * (len(bounds) + 1), 0.0, 0]
                self._histograms[name] = h
            i = 0
            while i < len(h[0]) and value > h[0][i]:
                i += 1
            h[1][i] += 1
            h[2] += value
            h[3] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: {"bounds": list(h[0]), "counts": list(h[1]),
                        "sum": h[2], "count": h[3]}
                    for k, h in self._histograms.items()
                },
            }

    def remove_matching(self, prefix: str) -> int:
        """Drop every gauge/histogram whose name starts with ``prefix``
        and return how many series were removed.  Counters are exempt on
        purpose — mirroring ``htpu::Metrics::RemoveMatching`` — so
        process-lifetime totals survive a membership change while
        per-rank tagged series (``...#rank=R``) are retired instead of
        accumulating under stale rank numbering after a re-rank."""
        with self._lock:
            removed = 0
            for store in (self._gauges, self._histograms):
                stale = [k for k in store if k.startswith(prefix)]
                for k in stale:
                    del store[k]
                removed += len(stale)
            return removed

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: Process-wide controller-side registry (the Python counterpart of
#: ``htpu::Metrics::Get()``); instrumented from core.py and ops/.
registry = MetricsRegistry()


def native_snapshot() -> dict:
    """The C++ registry's snapshot; ``{}`` without the native core."""
    try:
        from horovod_tpu_torch import cpp_core
        return cpp_core.metrics_snapshot()
    except Exception:   # noqa: BLE001 — metrics must never take a job down
        return {}


def snapshot() -> dict:
    """Merged native + controller metrics plus identity/clock fields —
    the payload of ``hvd.metrics()`` and of every JSONL line."""
    merged = {"counters": {}, "gauges": {}, "histograms": {}}
    for src in (native_snapshot(), registry.snapshot()):
        for kind in merged:
            merged[kind].update(src.get(kind, {}))
    merged["ts"] = time.time()
    merged["rank"] = int(os.environ.get("HOROVOD_TPU_RANK", "0"))
    return merged


# ------------------------------------------------------- prometheus text


def _prom_name_and_labels(name: str) -> Tuple[str, str]:
    """Split ``family#k=v,k2=v2`` into a sanitized metric name and a
    Prometheus label block (empty string when unlabelled)."""
    family, _, label_part = name.partition("#")
    prom = "htpu_" + "".join(
        c if (c.isalnum() or c == "_") else "_" for c in family)
    if not label_part:
        return prom, ""
    pairs = []
    for kv in label_part.split(","):
        k, _, v = kv.partition("=")
        k = "".join(c if (c.isalnum() or c == "_") else "_" for c in k)
        v = v.replace("\\", "\\\\").replace('"', '\\"')
        pairs.append(f'{k}="{v}"')
    return prom, "{" + ",".join(pairs) + "}"


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Render a snapshot as the Prometheus text exposition format
    (version 0.0.4): ``# HELP``/``# TYPE`` headers per family,
    counters/gauges as samples, histograms as the standard
    ``_bucket{le=...}/_sum/_count`` triple."""
    if snap is None:
        snap = snapshot()
    lines: List[str] = []
    typed: set = set()

    def type_header(prom: str, kind: str):
        if prom not in typed:
            typed.add(prom)
            lines.append(f"# HELP {prom} horovod_tpu {kind}")
            lines.append(f"# TYPE {prom} {kind}")

    for name in sorted(snap.get("counters", {})):
        prom, labels = _prom_name_and_labels(name)
        type_header(prom, "counter")
        lines.append(f"{prom}{labels} {snap['counters'][name]}")
    for name in sorted(snap.get("gauges", {})):
        prom, labels = _prom_name_and_labels(name)
        type_header(prom, "gauge")
        lines.append(f"{prom}{labels} {snap['gauges'][name]}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        prom, labels = _prom_name_and_labels(name)
        type_header(prom, "histogram")
        # Prometheus buckets are cumulative; the registry's are per-bucket.
        inner = labels[1:-1] + "," if labels else ""
        cum = 0
        for bound, cnt in zip(h["bounds"], h["counts"]):
            cum += cnt
            lines.append(f'{prom}_bucket{{{inner}le="{bound}"}} {cum}')
        cum += h["counts"][-1]
        lines.append(f'{prom}_bucket{{{inner}le="+Inf"}} {cum}')
        lines.append(f"{prom}_sum{labels} {h['sum']}")
        lines.append(f"{prom}_count{labels} {h['count']}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- exporters


class _Emitter:
    """Daemon thread writing one JSON snapshot line per interval to a
    per-rank file; started by ``hvd.init()`` when
    ``HOROVOD_TPU_METRICS_EVERY_S`` is set."""

    def __init__(self, every_s: float, path: str):
        self._every_s = every_s
        self._path = path
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="htpu-metrics-emitter")

    def start(self):
        self._thread.start()

    def _run(self):
        try:
            f = open(self._path, "a")
        except OSError:
            return
        with f:
            while not self._stop.wait(self._every_s):
                self._write_one(f)
            self._write_one(f)   # final snapshot on clean shutdown

    @staticmethod
    def _write_one(f):
        try:
            f.write(json.dumps(snapshot()) + "\n")
            f.flush()
        except Exception:   # noqa: BLE001 — metrics must never take a job down
            pass

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def _make_http_server(port: int):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):   # noqa: N802 — BaseHTTPRequestHandler contract
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = prometheus_text().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # silence per-request stderr spam
            pass

    return http.server.ThreadingHTTPServer(("", port), Handler)


_emitter: Optional[_Emitter] = None
_http_server = None
_lifecycle_lock = threading.Lock()


def start_exporters(rank: int) -> None:
    """Start whatever the env asks for: the per-rank JSONL emitter
    (``HOROVOD_TPU_METRICS_EVERY_S``) and, on rank 0 only, the Prometheus
    endpoint (``HOROVOD_TPU_METRICS_PORT``).  Idempotent; called from
    ``hvd.init()``."""
    global _emitter, _http_server
    with _lifecycle_lock:
        every = os.environ.get("HOROVOD_TPU_METRICS_EVERY_S")
        if every and _emitter is None:
            try:
                every_s = float(every)
            except ValueError:
                every_s = 0.0
            if every_s > 0:
                path = os.environ.get(
                    "HOROVOD_TPU_METRICS_FILE",
                    f"horovod_tpu_metrics.{rank}.jsonl")
                _emitter = _Emitter(every_s, path)
                _emitter.start()
        port = os.environ.get("HOROVOD_TPU_METRICS_PORT")
        if port and rank == 0 and _http_server is None:
            try:
                server = _make_http_server(int(port))
            except (OSError, ValueError) as e:
                import warnings
                warnings.warn(
                    f"horovod_tpu: metrics endpoint not started ({e})",
                    RuntimeWarning)
                return
            _http_server = server
            threading.Thread(target=server.serve_forever, daemon=True,
                             name="htpu-metrics-http").start()


def stop_exporters() -> None:
    """Stop the emitter (flushing one last snapshot) and the HTTP
    endpoint; called from ``hvd.shutdown()``."""
    global _emitter, _http_server
    with _lifecycle_lock:
        if _emitter is not None:
            _emitter.stop()
            _emitter = None
        if _http_server is not None:
            _http_server.shutdown()
            _http_server.server_close()
            _http_server = None


class _CallableModule(types.ModuleType):
    """Lets ``hvd.metrics()`` be a call AND ``hvd.metrics.registry`` an
    attribute access.  A plain function re-exported from ``basics`` would
    be clobbered: importing this submodule rebinds the package attribute
    ``horovod_tpu_torch.metrics`` to the module object (importlib always sets
    the parent attribute), so the module itself must be the callable."""

    def __call__(self) -> dict:
        return snapshot()


sys.modules[__name__].__class__ = _CallableModule
