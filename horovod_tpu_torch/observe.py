"""Fleet performance observatory: the Python face of the per-hop
telemetry, step-time decomposition and fleet aggregation of the native
core (``cpp/htpu/observe.{h,cc}``).

Port of ``horovod_tpu/observe.py:46-166``.  ``hvd.observe()`` returns one
merged dict:

* ``"enabled"`` -- whether the native observatory is armed
  (``HOROVOD_TPU_OBSERVE=1`` or ``observe.set_enabled(True)``);
* ``"local"`` -- this process's native digest: step/compute/exposed/stall
  EWMAs, per-leg bandwidth EWMAs (classic/shm/uring/ctrl), step count,
  in-flight transfers;
* ``"fleet"`` -- on the coordinator (process 0) only, the fleet view
  parsed back out of the ``fleet.*`` gauges the coordinator republishes
  from the telemetry trailers of tick frames: ``{"ranks": N,
  "by_rank": {rank: {...}}}``.

The step decomposition is fed by the eager gradient route's overlapped
step (:mod:`horovod_tpu_torch.optimizer`) through :func:`note_step`,
which routes to the native EWMAs when the core is loaded and always
mirrors into the Python registry, so that pure-Python runs still get the
``step.*`` histograms in ``hvd.metrics()``.

Like :mod:`horovod_tpu_torch.metrics`, this module is callable --
``hvd.observe()`` -- because importing the submodule rebinds the package
attribute to the module object.
"""

from __future__ import annotations

import os
import sys
import types
from typing import Dict, Optional

from horovod_tpu_torch import metrics as _metrics

# Python-side state for ``enabled()`` when the native core is absent:
# seeded from the env, flippable via set_enabled().
_py_enabled: Optional[bool] = None


def _env_enabled() -> bool:
    return os.environ.get("HOROVOD_TPU_OBSERVE", "").strip().lower() in (
        "1", "true", "yes", "on")


def enabled() -> bool:
    """Whether the observatory is armed (native state when available)."""
    global _py_enabled
    try:
        from horovod_tpu_torch import cpp_core
        native = cpp_core.observe_enabled()
    except Exception:   # noqa: BLE001 -- observability must never raise
        native = None
    if native is not None:
        return native
    if _py_enabled is None:
        _py_enabled = _env_enabled()
    return _py_enabled


def set_enabled(on: bool) -> None:
    """Flip the observatory at runtime (both native and Python state)."""
    global _py_enabled
    _py_enabled = bool(on)
    try:
        from horovod_tpu_torch import cpp_core
        cpp_core.observe_set_enabled(bool(on))
    except Exception:   # noqa: BLE001 -- observability must never raise
        pass


def note_step(step_s: float, compute_s: float = 0.0, hidden_s: float = 0.0,
              exposed_s: float = 0.0, stall_s: float = 0.0) -> None:
    """Record one training step's wall-clock decomposition.

    Feeds the native EWMAs (which ride the telemetry trailer to the
    coordinator) when the core is loaded, and always mirrors into the
    Python registry's ``step.*`` histograms."""
    if not enabled():
        return
    try:
        from horovod_tpu_torch import cpp_core
        cpp_core.observe_note_step(step_s, compute_s, hidden_s, exposed_s,
                                   stall_s)
    except Exception:   # noqa: BLE001 -- observability must never raise
        pass
    reg = _metrics.registry
    reg.inc("step.count")
    reg.observe("step.seconds", step_s)
    reg.observe("step.compute_seconds", compute_s)
    reg.observe("step.hidden_comm_seconds", hidden_s)
    reg.observe("step.exposed_comm_seconds", exposed_s)
    reg.observe("step.stall_seconds", stall_s)


def local_snapshot() -> dict:
    """The native per-process digest; ``{}`` without the native core."""
    try:
        from horovod_tpu_torch import cpp_core
        return cpp_core.observe_snapshot()
    except Exception:   # noqa: BLE001 -- observability must never raise
        return {}


def fleet_from_gauges(gauges: Dict[str, float]) -> dict:
    """Reshape the coordinator's flat ``fleet.*#rank=R[,leg=L]`` gauges
    into ``{"ranks": N, "by_rank": {R: {...}}}``."""
    by_rank: Dict[int, dict] = {}
    for name, value in gauges.items():
        if not name.startswith("fleet.") or "#" not in name:
            continue
        family, _, label_part = name.partition("#")
        labels = {}
        for kv in label_part.split(","):
            k, _, v = kv.partition("=")
            labels[k] = v
        try:
            rank = int(labels["rank"])
        except (KeyError, ValueError):
            continue
        row = by_rank.setdefault(rank, {})
        key = family[len("fleet."):]
        if key == "bandwidth_bps":
            row.setdefault("bandwidth_bps", {})[
                labels.get("leg", "?")] = value
        else:
            row[key] = value
    return {"ranks": int(gauges.get("fleet.ranks", len(by_rank))),
            "by_rank": by_rank}


def snapshot() -> dict:
    """The merged observatory view returned by ``hvd.observe()``."""
    snap = _metrics.snapshot()
    return {
        "enabled": enabled(),
        "local": local_snapshot(),
        "fleet": fleet_from_gauges(snap.get("gauges", {})),
        "sentinel_alerts": {
            k.partition("=")[2]: v
            for k, v in snap.get("counters", {}).items()
            # Eagerly registered kinds sit at zero until they fire; only
            # fired kinds belong in the user-facing alert map.
            if k.startswith("sentinel.alerts#kind=") and v
        },
    }


class _CallableModule(types.ModuleType):
    """Makes ``hvd.observe()`` a call and ``hvd.observe.note_step`` an
    attribute access -- the idiom (and reason) of ``hvd.metrics``."""

    def __call__(self) -> dict:
        return snapshot()


sys.modules[__name__].__class__ = _CallableModule
