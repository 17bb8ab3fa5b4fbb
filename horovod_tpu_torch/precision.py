"""Process-local adaptive-precision autopilot.

Port of ``horovod_tpu/precision.py``: :class:`PrecisionAutopilot`,
:func:`get_autopilot` and :func:`reset_autopilot`, thread-safe as in the
reference.

The negotiated (eager) plane runs the real controller inside the
coordinator's fleet policy (the native ``ControlPlane``): workers report
per-bucket residual norms over the request wire (``FLAG_PRECISION_EXT``)
and rank 0 stamps the chosen wire dtype into the negotiated Response, so
every rank agrees by construction.

This module is the plumbing each *worker process* needs around that, plus
the mirror the train step reads:

* ``note_residual(name, norm)`` — record a measured relative residual
  norm for a bucket.  It is queued for the next request frame's
  precision ext (``drain_reports``) AND fed to a local
  :class:`~horovod_tpu_torch.policy.FleetPolicy` mirror, so programs
  without a coordinator (``spmd.make_train_step``, the SPMD branch of
  ``DistributedOptimizer``) run the same ladder.
* ``wire_dtype_for(name)`` / ``plan_version`` — the local mirror's
  current decision and a counter that bumps on every level change, so
  ``make_train_step(compression="auto")`` knows when its per-leaf route
  is stale and must be rebuilt.

Determinism note for the mirror: residuals are computed from the
*allreduced* gradients, which are bit-identical on every process, and the
ladder is a pure function of the observed sequence — so independent
per-process mirrors stay in lockstep without any negotiation.  If a
caller feeds per-process-varying values the mirrors can diverge; the
negotiated plane does not have this caveat (rank 0 decides alone).

Armed by ``HOROVOD_TPU_PRECISION=auto`` (default ``static`` — everything
here becomes a cheap no-op and wire frames stay byte-identical).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from horovod_tpu_torch import policy as _policy


class PrecisionAutopilot:
    """Thread-safe per-process wrapper over the precision ladder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._policy = _policy.FleetPolicy()
        self._pending: Dict[str, float] = {}
        self._version = 0

    @property
    def enabled(self) -> bool:
        """True when ``HOROVOD_TPU_PRECISION=auto`` armed the ladder."""
        return self._policy.precision_auto()

    @property
    def plan_version(self) -> int:
        """Bumped on every ladder level change anywhere;
        ``make_train_step(compression="auto")`` rebuilds its per-leaf
        route when this moves."""
        with self._lock:
            return self._version

    def note_residual(self, name: str, residual_norm: float) -> None:
        """Record one measured relative residual norm for bucket ``name``.

        Queued for the next request frame (``drain_reports``) and fed to
        the local ladder mirror.  No-op unless the autopilot is armed;
        negative values (no measurement) are ignored.
        """
        if not self.enabled or residual_norm < 0:
            return
        with self._lock:
            self._pending[name] = float(residual_norm)
            self._policy.observe_precision(name, float(residual_norm))
            if self._policy.take_precision_dirty():
                self._version += 1

    def note_bandwidth(self, min_leg_bps: float) -> None:
        """Feed the slowest observed leg bandwidth to the promotion gate
        (``HOROVOD_TPU_PRECISION_BW_BPS``)."""
        if not self.enabled:
            return
        with self._lock:
            self._policy.note_precision_bandwidth(min_leg_bps)

    def drain_reports(self) -> List[Tuple[str, float]]:
        """Take (and clear) the residual reports queued since the last
        drain, in name order — the payload for the request frame's
        precision ext."""
        with self._lock:
            items = sorted(self._pending.items())
            self._pending.clear()
            return items

    def wire_dtype_for(self, name: str) -> str:
        """The local mirror's current wire dtype for ``name``
        (""/"bf16"/"int8")."""
        with self._lock:
            return self._policy.precision_wire(name)

    def level_for(self, name: str) -> int:
        with self._lock:
            return self._policy.precision_level(name)

    def ewma_for(self, name: str) -> float:
        with self._lock:
            return self._policy.precision_ewma(name)

    @property
    def promotions(self) -> int:
        with self._lock:
            return self._policy.precision_promotions

    @property
    def demotions(self) -> int:
        with self._lock:
            return self._policy.precision_demotions


_singleton: PrecisionAutopilot | None = None
_singleton_lock = threading.Lock()


def get_autopilot() -> PrecisionAutopilot:
    """The process-wide autopilot (created on first use; env knobs are
    read at that moment)."""
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            _singleton = PrecisionAutopilot()
        return _singleton


def reset_autopilot() -> None:
    """Drop the singleton so the next ``get_autopilot`` re-reads the env
    (test isolation)."""
    global _singleton
    with _singleton_lock:
        _singleton = None
