"""Async incremental checkpoint stream.

Port of ``horovod_tpu/ckpt_stream.py`` (:47-316).  Synchronous
checkpointing bounds ``elastic.downtime_seconds`` by the save interval: a
rank lost at step N replays everything since the last full save.  This
module decouples the two costs:

1. **snapshot** (training thread, every ``snapshot_every_steps`` steps) --
   a device->host copy of the state.  This is the ONLY work on the step
   path, observed as ``ckpt.snapshot_seconds``.  torch updates parameters
   and optimizer state in place (JAX replaces them), so the copy has
   finished when :meth:`AsyncCheckpointer.snapshot` returns: the next
   ``optimizer.step()`` cannot reach it (``checkpoint.flatten_state``
   queues the copies into pinned buffers and synchronizes once).
2. **commit** (background writer thread) -- diff the snapshot against the
   last committed one and publish only the changed leaves as a ``delta``
   chain link (``checkpoint.save_chain``), anchored to a periodic full
   ``base`` every ``HOROVOD_TPU_CKPT_FULL_EVERY`` commits.

The buffer is double-buffered with latest-wins coalescing: at most one
snapshot is queued while one is being written; a newer snapshot replaces
the queued one (``ckpt.coalesced``), so a slow disk degrades recovery
granularity instead of stalling training.

Writer failures do not die inside the thread: they increment
``ckpt.write_errors``, emit a ``CKPT_WRITE_ERROR`` flight event, and
re-raise as an attributed ``HorovodRetryableError`` from the owning rank's
next ``snapshot()``/``flush()`` call.

Chaos drills (``HOROVOD_TPU_FAULT``, parsed by
:func:`horovod_tpu_torch.core.parse_fault_specs`):
``crash_in_save:rank=R:epoch=E`` kills rank R's writer at the worst point
of the first commit with epoch >= E -- after the shards are staged, before
the manifest and the atomic publish; ``corrupt_ckpt:rank=R:epoch=E`` flips
a byte of a committed shard file, which the next restore's CRC32C check
catches.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

from horovod_tpu_torch import basics, checkpoint, cpp_core
from horovod_tpu_torch import metrics as _metrics


def async_enabled() -> bool:
    """HOROVOD_TPU_CKPT_ASYNC=1 turns the stream on even when the cadence
    is driven by explicit ``snapshot()`` calls instead of a step knob."""
    return os.environ.get("HOROVOD_TPU_CKPT_ASYNC", "0") == "1"


def snapshot_every_steps_default() -> int:
    """Snapshot cadence in steps; 0 (the default) disables the stream
    unless HOROVOD_TPU_CKPT_ASYNC=1."""
    try:
        return max(0, int(os.environ.get(
            "HOROVOD_TPU_CKPT_EVERY_STEPS", "0")))
    except ValueError:
        return 0


def full_every_default() -> int:
    """Every Nth commit is a full base (delta chains stay short: restore
    replays at most N-1 deltas and a torn link loses at most N epochs)."""
    try:
        return max(1, int(os.environ.get(
            "HOROVOD_TPU_CKPT_FULL_EVERY", "16")))
    except ValueError:
        return 16


def _die(code: int, msg: str) -> None:
    # Seam for fast tests: the real drill must not run atexit/flush
    # handlers — that is the point of the fault.
    print(msg, file=sys.stderr, flush=True)
    os._exit(code)


def _crash_in_save_epoch(rank: int) -> Optional[int]:
    """Smallest fault epoch targeting ``rank``, or None."""
    from horovod_tpu_torch.core import parse_fault_specs
    specs = [s for s in parse_fault_specs(
                 os.environ.get("HOROVOD_TPU_FAULT", ""))
             if s.mode == "crash_in_save" and s.rank == rank]
    return min((s.epoch for s in specs), default=None)


def _corrupt_ckpt_epoch(rank: int) -> Optional[int]:
    """Smallest ``corrupt_ckpt`` fault epoch targeting ``rank``, or None.
    The drill flips bytes in a COMMITTED shard file — simulating bit rot
    the rename discipline cannot see — so the next restore must detect
    the CRC mismatch and fall back to the prior committed chain."""
    from horovod_tpu_torch.core import parse_fault_specs
    specs = [s for s in parse_fault_specs(
                 os.environ.get("HOROVOD_TPU_FAULT", ""))
             if s.mode == "corrupt_ckpt" and s.rank == rank]
    return min((s.epoch for s in specs), default=None)


class AsyncCheckpointer:
    """Rank-owned snapshot→delta pipeline over ``directory``.

    Created on the writing rank (rank 0 by convention — ``run_elastic``
    does this); ``snapshot(state, epoch)`` is cheap and non-blocking,
    ``flush()`` waits for the queue to drain, ``close()`` stops the
    writer.  Instances on other ranks are inert.
    """

    def __init__(self, directory: str, *,
                 snapshot_every_steps: int = 0,
                 full_every: Optional[int] = None):
        self._dir = os.path.abspath(directory)
        self._every = max(0, snapshot_every_steps)
        self._full_every = full_every or full_every_default()
        self._cv = threading.Condition()
        self._pending: Optional[Tuple[int, Dict[str, Any]]] = None
        self._busy = False
        self._closed = False
        self._error: Optional[BaseException] = None
        # Last COMMITTED snapshot — the delta diff anchor.
        self._anchor: Optional[Dict[str, Any]] = None
        self._anchor_epoch = -1
        self._anchor_is_chain = False
        self._commits_since_base = 0
        try:
            self._rank = basics.rank()
        except basics.NotInitializedError:
            self._rank = 0
        # Fault targeting matches the native plane's: the process's FIRST
        # global rank (at launch) — a successor re-ranked to 0 after a
        # failover must not re-fire the dead coordinator's fault.
        first_rank = int(os.environ.get("HOROVOD_TPU_RANK", self._rank))
        self._fault_epoch = _crash_in_save_epoch(first_rank)
        self._corrupt_epoch = _corrupt_ckpt_epoch(first_rank)
        self._thread = threading.Thread(
            target=self._run, name="htpu-ckpt-writer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer

    def seed(self, state: Any, epoch: int) -> None:
        """Anchor the diff at already-persisted state (post-restore): the
        first commit after a seed is a delta against ``epoch`` when that
        epoch is a chain link on disk, else a fresh base (e.g. the tip
        was a legacy orbax save a delta cannot chain to)."""
        self._anchor = checkpoint.flatten_state(state) if epoch >= 0 else None
        self._anchor_epoch = epoch
        self._anchor_is_chain = (epoch >= 0
                                 and checkpoint.is_chain(self._dir, epoch))
        self._commits_since_base = 0

    def maybe_snapshot(self, state: Any, step: int) -> bool:
        """Cadence-gated :meth:`snapshot` — call every step; snapshots
        land every ``snapshot_every_steps`` steps."""
        if self._every <= 0 or step % self._every != 0:
            self._raise_pending_error()
            return False
        return self.snapshot(state, step)

    def snapshot(self, state: Any, epoch: int) -> bool:
        """Device→host copy of ``state`` and hand-off to the writer.
        Returns False when the snapshot coalesced over a queued one.
        Raises the writer's stored error, if any, on the owning rank."""
        self._raise_pending_error()
        t0 = time.perf_counter()
        flat = checkpoint.flatten_state(state)
        _metrics.registry.observe("ckpt.snapshot_seconds",
                                  time.perf_counter() - t0)
        _metrics.registry.inc("ckpt.snapshots")
        _metrics.registry.set_gauge("ckpt.last_snapshot_ts", time.time())
        with self._cv:
            if self._closed:
                return False
            fresh = self._pending is None
            if not fresh:
                _metrics.registry.inc("ckpt.coalesced")
            self._pending = (epoch, flat)
            _metrics.registry.set_gauge(
                "ckpt.pending", (1 if self._pending else 0) + self._busy)
            self._cv.notify_all()
        return fresh

    def flush(self, timeout: float = 120.0) -> None:
        """Block until every queued snapshot is committed (or ``timeout``
        elapses), then surface any writer error."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._busy:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=min(left, 1.0)):
                    if time.monotonic() >= deadline:
                        break
        self._raise_pending_error()

    def close(self, *, flush: bool = True) -> None:
        """Stop the writer.  ``flush=False`` discards queued work (used
        on the failure path, where the chain on disk is already the
        recovery point)."""
        if flush and not self._closed:
            self.flush()
        with self._cv:
            self._closed = True
            if not flush:
                self._pending = None
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    @property
    def last_committed_epoch(self) -> int:
        return self._anchor_epoch

    def _raise_pending_error(self) -> None:
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # ------------------------------------------------------------ writer

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None and self._closed:
                    return
                epoch, flat = self._pending
                self._pending = None
                self._busy = True
                _metrics.registry.set_gauge("ckpt.pending", 1)
            try:
                self._commit(epoch, flat)
            except BaseException as exc:   # noqa: BLE001 — attributed below
                self._record_error(epoch, exc)
            finally:
                with self._cv:
                    self._busy = False
                    _metrics.registry.set_gauge(
                        "ckpt.pending", 1 if self._pending else 0)
                    self._cv.notify_all()

    def _commit(self, epoch: int, flat: Dict[str, Any]) -> None:
        force_base = (self._anchor is None or not self._anchor_is_chain
                      or self._commits_since_base >= self._full_every)
        t0 = time.perf_counter()
        stats = checkpoint.save_chain(
            self._dir, flat, epoch,
            prev_epoch=self._anchor_epoch,
            prev_flat=None if force_base else self._anchor,
            fault_hook=lambda: self._maybe_crash(epoch))
        _metrics.registry.observe("ckpt.write_seconds",
                                  time.perf_counter() - t0)
        self._anchor, self._anchor_epoch = flat, epoch
        self._anchor_is_chain = True
        self._commits_since_base = (
            0 if stats["kind"] == "base" else self._commits_since_base + 1)
        _metrics.registry.inc(f"ckpt.commits#kind={stats['kind']}")
        _metrics.registry.inc(f"ckpt.bytes_written#kind={stats['kind']}",
                              stats["nbytes"])
        _metrics.registry.set_gauge("ckpt.last_commit_epoch", epoch)
        if stats["kind"] == "delta":
            _metrics.registry.set_gauge("ckpt.last_delta_bytes",
                                        stats["nbytes"])
        cpp_core.flight_record(
            "CKPT_COMMIT",
            f"epoch={epoch} kind={stats['kind']} "
            f"shards={stats['shards']}/{stats['total']}",
            nbytes=stats["nbytes"])
        self._maybe_corrupt(epoch)

    def _maybe_corrupt(self, epoch: int) -> None:
        """corrupt_ckpt drill: flip a byte in the just-COMMITTED shard
        file, after the rename published it — exactly the corruption the
        manifest CRC32C exists to catch at restore."""
        if self._corrupt_epoch is None or epoch < self._corrupt_epoch:
            return
        self._corrupt_epoch = None
        path = os.path.join(
            checkpoint.checkpoint_path(self._dir, epoch),
            checkpoint.CHAIN_SHARDS)
        try:
            with open(path, "r+b") as f:
                data = f.read()
                if not data:
                    return
                f.seek(len(data) // 2)
                f.write(bytes([data[len(data) // 2] ^ 0x5A]))
        except OSError as exc:
            print(f"htpu fault injection: corrupt_ckpt could not mangle "
                  f"{path!r}: {exc}", file=sys.stderr, flush=True)
            return
        _metrics.registry.inc("ckpt.faults_injected#mode=corrupt_ckpt")
        cpp_core.flight_record(
            "fault.corrupt_ckpt",
            f"epoch={epoch} rank={self._rank} path={path}")
        print(f"htpu fault injection: flipped a byte in committed shard "
              f"{path!r} (epoch {epoch})", file=sys.stderr, flush=True)

    def _maybe_crash(self, epoch: int) -> None:
        if self._fault_epoch is not None and epoch >= self._fault_epoch:
            self._fault_epoch = None
            _die(43, f"htpu fault injection: crashing rank {self._rank} "
                     f"mid-save (epoch {epoch})")

    def _record_error(self, epoch: int, exc: BaseException) -> None:
        from horovod_tpu_torch.ops.eager import HorovodRetryableError
        _metrics.registry.inc("ckpt.write_errors")
        cpp_core.flight_record("CKPT_WRITE_ERROR",
                               f"epoch={epoch} rank={self._rank}: {exc}")
        err = HorovodRetryableError(
            f"rank {self._rank}: async checkpoint write failed for epoch "
            f"{epoch} under {self._dir!r}: {exc!r}")
        err.__cause__ = exc
        with self._cv:
            self._error = err
