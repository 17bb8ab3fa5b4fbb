"""Fleet policy engine (Python mirror of cpp/htpu/policy).

Port of ``horovod_tpu/policy.py``, whole: the env readers (:79-160),
:func:`parse_autoscale_script` (:41), :class:`FleetPolicy` (:182) with the
precision ladder (:432-512), and :func:`make_fleet_policy` (:528).  Pure
Python; its gauges and counters go to this package's metrics registry
under the reference's names.

The coordinator's self-driving layer: every control tick it consumes the
per-rank imposed-wait samples the skew monitor already computes and turns
them into *planned* reconfigures through the elastic machinery —

* **straggler eviction** — a process whose EWMA imposed wait sits
  ``HOROVOD_TPU_EVICT_THRESHOLD`` seconds above the fleet's median EWMA
  for ``HOROVOD_TPU_EVICT_TICKS`` consecutive gathers is demoted to
  standby.  One healthy gather resets the window (hysteresis);
  ``HOROVOD_TPU_EVICT_MAX`` bounds total evictions; suppressed
  opportunities log once and count ``policy.evictions_suppressed``.
* **ring re-ranking** — on any reconfigure survivors are stably sorted
  by ms-bucketed EWMA so the slowest hosts become ring-adjacent
  (``HOROVOD_TPU_POLICY_RERANK=0`` keeps the dense order).
* **scripted autoscaling** — ``HOROVOD_TPU_AUTOSCALE`` holds a
  ``tick:<T>=<procs>,...`` schedule; ``HOROVOD_TPU_AUTOSCALE_FILE`` is
  the external-signal seam.
* **the precision ladder** — per-bucket wire dtype (fp32 -> bf16 ->
  int8) from measured residual norms, armed by
  ``HOROVOD_TPU_PRECISION=auto``.

In a job the native coordinator runs its own copy of this engine inside
the ControlPlane, armed by the same knobs at ``hvd.init``: it evicts,
re-ranks and rescales, and :mod:`horovod_tpu_torch.core` follows its
reconfigures (:mod:`horovod_tpu_torch.precision` keeps a per-process
mirror of the ladder).  This mirror is the executable specification,
held against the reference and the native engine by the parity tests.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

#: EWMA smoothing factor for per-process imposed wait; matches
#: ``htpu::FleetPolicy::alpha_``.
EWMA_ALPHA = 0.2


def parse_autoscale_script(script: str) -> List[Tuple[int, int]]:
    """Parse ``tick:<T>=<procs>[,tick:<T>=<procs>...]`` into a
    tick-sorted ``[(tick, target_processes), ...]`` list.

    Strict — raises :class:`ValueError` on any malformed entry so
    ``run.py --autoscale-script`` fails at launch instead of the native
    parser silently dropping the schedule mid-job.  Empty entries
    (trailing commas) are tolerated, matching the lenient C++ parse.
    """
    out: List[Tuple[int, int]] = []
    for entry in script.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if not entry.startswith("tick:"):
            raise ValueError(
                f"autoscale entry {entry!r} must look like tick:<T>=<procs>")
        body = entry[len("tick:"):]
        tick_s, sep, target_s = body.partition("=")
        if not sep:
            raise ValueError(
                f"autoscale entry {entry!r} is missing '=<procs>'")
        try:
            tick = int(tick_s)
            target = int(target_s)
        except ValueError:
            raise ValueError(
                f"autoscale entry {entry!r}: tick and process count must "
                "be integers") from None
        if tick <= 0 or target <= 0:
            raise ValueError(
                f"autoscale entry {entry!r}: tick and process count must "
                "be positive")
        out.append((tick, target))
    out.sort(key=lambda e: e[0])
    return out


def evict_threshold_s_from_env() -> float:
    """``HOROVOD_TPU_EVICT_THRESHOLD`` (seconds); 0 disables eviction."""
    raw = os.environ.get("HOROVOD_TPU_EVICT_THRESHOLD", "0")
    try:
        v = float(raw)
        return v if v >= 0 else 0.0
    except ValueError:
        return 0.0


def evict_ticks_from_env() -> int:
    """``HOROVOD_TPU_EVICT_TICKS``: consecutive slow gathers before a
    rank is demoted (the hysteresis window)."""
    raw = os.environ.get("HOROVOD_TPU_EVICT_TICKS", "5")
    try:
        v = int(raw)
        return v if v > 0 else 5
    except ValueError:
        return 5


def evict_max_from_env() -> int:
    """``HOROVOD_TPU_EVICT_MAX``: lifetime eviction budget."""
    raw = os.environ.get("HOROVOD_TPU_EVICT_MAX", "1")
    try:
        v = int(raw)
        return v if v >= 0 else 1
    except ValueError:
        return 1


def rerank_enabled_from_env() -> bool:
    """``HOROVOD_TPU_POLICY_RERANK``: straggler-adjacent survivor order
    on reconfigure (default on; only consulted while a policy is armed)."""
    return os.environ.get("HOROVOD_TPU_POLICY_RERANK", "1") != "0"


def precision_auto_from_env() -> bool:
    """``HOROVOD_TPU_PRECISION``: ``auto`` arms the per-bucket wire-dtype
    ladder; anything else (default ``static``) keeps the static
    ``compression=`` knobs authoritative."""
    return os.environ.get("HOROVOD_TPU_PRECISION", "static") == "auto"


def precision_threshold_from_env() -> float:
    """``HOROVOD_TPU_PRECISION_THRESHOLD``: relative residual-norm
    ceiling — one raw sample above it demotes the bucket to fp32."""
    raw = os.environ.get("HOROVOD_TPU_PRECISION_THRESHOLD", "0.05")
    try:
        v = float(raw)
        return v if v > 0 else 0.05
    except ValueError:
        return 0.05


def precision_ticks_from_env() -> int:
    """``HOROVOD_TPU_PRECISION_TICKS``: consecutive healthy reports
    before a bucket is promoted one ladder level (the hysteresis
    window, same shape as ``HOROVOD_TPU_EVICT_TICKS``)."""
    raw = os.environ.get("HOROVOD_TPU_PRECISION_TICKS", "8")
    try:
        v = int(raw)
        return v if v > 0 else 8
    except ValueError:
        return 8


def precision_bw_bps_from_env() -> float:
    """``HOROVOD_TPU_PRECISION_BW_BPS``: bandwidth gate — promotion is
    held while the slowest observed leg is at or above this many
    bytes/s (the wire is not the bottleneck, so quantization buys
    nothing — the EQuARX rationale).  0 (default) disables the gate."""
    raw = os.environ.get("HOROVOD_TPU_PRECISION_BW_BPS", "0")
    try:
        v = float(raw)
        return v if v >= 0 else 0.0
    except ValueError:
        return 0.0


#: Ladder level -> negotiated wire dtype ("" = raw fp32).
PRECISION_WIRE = ("", "bf16", "int8")


class _ProcState:
    __slots__ = ("ewma", "valid", "consecutive", "suppress_logged")

    def __init__(self):
        self.ewma = 0.0
        self.valid = False
        self.consecutive = 0
        self.suppress_logged = False


class _PrecState:
    __slots__ = ("ewma", "healthy", "level")

    def __init__(self):
        self.ewma = -1.0    # relative residual-norm EWMA (-1 = no data)
        self.healthy = 0    # consecutive reports under threshold
        self.level = 0      # 0 = fp32, 1 = bf16, 2 = int8


class FleetPolicy:
    """Pure-Python fleet-policy decision engine; same semantics as
    ``htpu::FleetPolicy`` (parity is tested through the ctypes wrapper
    ``cpp_core.NativeFleetPolicy``)."""

    def __init__(self):
        self._threshold_s = evict_threshold_s_from_env()
        self._evict_ticks = evict_ticks_from_env()
        self._evict_max = evict_max_from_env()
        self._rerank = rerank_enabled_from_env()
        raw = os.environ.get("HOROVOD_TPU_AUTOSCALE", "")
        try:
            self._schedule = parse_autoscale_script(raw) if raw else []
        except ValueError as e:
            print(f"horovod_tpu_torch policy: ignoring malformed "
                  f"HOROVOD_TPU_AUTOSCALE ({e})", file=sys.stderr)
            self._schedule = []
        self._autoscale_file = os.environ.get("HOROVOD_TPU_AUTOSCALE_FILE",
                                              "")
        # Per-process straggler state keyed by process set (0 = the
        # default/pod set).  Pod-level decisions (next_eviction,
        # rerank_order) read set 0 only; a rank slow in one tenant's
        # collectives is never nominated for eviction from another's.
        self._sets: Dict[int, List[_ProcState]] = {}
        self._evictions = 0   # global budget, shared across all sets
        # Precision ladder (the third actuator on the same engine).
        self._precision_auto = precision_auto_from_env()
        self._precision_threshold = precision_threshold_from_env()
        self._precision_ticks = precision_ticks_from_env()
        self._precision_bw_bps = precision_bw_bps_from_env()
        self._precision_bw_hold = False
        self._precision_dirty = False
        self._precision_promotions = 0
        self._precision_demotions = 0
        self._precision: Dict[str, _PrecState] = {}

    # ------------------------------------------------------- arming state

    def evict_enabled(self) -> bool:
        return self._threshold_s > 0

    def autoscale_enabled(self) -> bool:
        return bool(self._schedule) or bool(self._autoscale_file)

    def active(self) -> bool:
        return (self.evict_enabled() or self.autoscale_enabled()
                or self.precision_auto())

    def precision_auto(self) -> bool:
        return self._precision_auto

    def rerank_enabled(self) -> bool:
        return self._rerank and self.active()

    # ---------------------------------------------------------- accessors

    @property
    def threshold_s(self) -> float:
        return self._threshold_s

    @property
    def evict_ticks(self) -> int:
        return self._evict_ticks

    @property
    def evict_max(self) -> int:
        return self._evict_max

    @property
    def evictions(self) -> int:
        return self._evictions

    def ewma(self, proc: int) -> float:
        return self.ewma_set(0, proc)

    def consecutive_slow(self, proc: int) -> int:
        return self.consecutive_slow_set(0, proc)

    def ewma_set(self, process_set: int, proc: int) -> float:
        procs = self._sets.get(process_set, [])
        if 0 <= proc < len(procs) and procs[proc].valid:
            return procs[proc].ewma
        return -1.0

    def consecutive_slow_set(self, process_set: int, proc: int) -> int:
        procs = self._sets.get(process_set, [])
        if 0 <= proc < len(procs):
            return procs[proc].consecutive
        return 0

    # ---------------------------------------------------------- decisions

    def _update_set(self, procs: List[_ProcState],
                    wait_s: Sequence[float]) -> None:
        """EWMA + consecutive-slow pass over one set's state vector."""
        while len(procs) < len(wait_s):
            procs.append(_ProcState())
        for p, w in enumerate(wait_s):
            if w < 0:
                continue
            ps = procs[p]
            ps.ewma = (EWMA_ALPHA * w + (1.0 - EWMA_ALPHA) * ps.ewma
                       if ps.valid else float(w))
            ps.valid = True
        if not self.evict_enabled():
            return
        # Slow is RELATIVE to the fleet: re-anchoring the smoothed values
        # on their own median means a fleet-wide slowdown (every EWMA
        # elevated alike) never nominates anyone — skew is a property of
        # one host, load is a property of the job.
        ew = sorted(ps.ewma for ps in procs if ps.valid)
        if len(ew) < 2:
            return
        mid = len(ew) // 2
        median = (ew[mid] if len(ew) % 2
                  else (ew[mid] + ew[mid - 1]) / 2.0)
        for ps in procs:
            if not ps.valid:
                continue
            if ps.ewma - median > self._threshold_s:
                ps.consecutive += 1
            else:
                # Hysteresis: one healthy gather resets the whole window.
                ps.consecutive = 0
                ps.suppress_logged = False

    def observe_tick(self, tick: int, wait_s: Sequence[float],
                     set_attr: Sequence[int] = ()) -> None:
        """Feed one gather's per-process imposed waits (seconds; a
        negative entry means no sample for that process this tick).

        ``set_attr[p]`` names the process set process ``p``'s tick was
        spent in (0 = default): its sample lands on that set's EWMA
        state, so one tenant's slowness stays that tenant's signal.  An
        empty attribution is all-default — bit-identical to the pre-set
        behavior.  The default set's pass always runs so its
        consecutive-slow windows keep their every-gather cadence; a
        non-default set runs only on ticks that attributed it a sample.
        """
        del tick
        per_set: Dict[int, List[float]] = {0: [-1.0] * len(wait_s)}
        for p, w in enumerate(wait_s):
            s = set_attr[p] if p < len(set_attr) and set_attr[p] > 0 else 0
            per_set.setdefault(s, [-1.0] * len(wait_s))[p] = w
        for s in sorted(per_set):
            self._update_set(self._sets.setdefault(s, []), per_set[s])

    def observe_tick_set(self, process_set: int,
                         wait_s: Sequence[float]) -> None:
        """Feed one wait vector directly into ``process_set``'s state
        (tests + tooling; the live tick path uses ``observe_tick``'s
        attribution)."""
        self._update_set(self._sets.setdefault(process_set, []), wait_s)

    def _nominate(self, process_set: int, process_count: int,
                  seat_available: bool) -> int:
        """Shared nomination: candidate scan over one set's state plus
        the global budget / seat suppression."""
        if not self.evict_enabled():
            return -1
        procs = self._sets.get(process_set, [])
        candidate = -1
        worst = 0.0
        # Process 0 IS the coordinator — never a candidate (failover,
        # not eviction, handles a slow coordinator).
        for p in range(1, min(process_count, len(procs))):
            ps = procs[p]
            if not ps.valid or ps.consecutive < self._evict_ticks:
                continue
            if candidate < 0 or ps.ewma > worst:
                candidate = p
                worst = ps.ewma
        if candidate < 0:
            return -1
        why: Optional[str] = None
        if self._evictions >= self._evict_max:
            why = "eviction budget HOROVOD_TPU_EVICT_MAX exhausted"
        elif not seat_available:
            why = ("no parked standby and shrinking would fall below "
                   "the rank floor")
        if why is not None:
            from horovod_tpu_torch.metrics import registry
            registry.inc("policy.evictions_suppressed")
            ps = procs[candidate]
            if not ps.suppress_logged:
                ps.suppress_logged = True
                print(f"horovod_tpu_torch policy: NOT evicting straggler "
                      f"process {candidate} (set {process_set}, ewma_wait="
                      f"{ps.ewma * 1e3:.1f}ms > threshold for "
                      f"{ps.consecutive} ticks): {why}", file=sys.stderr)
            return -1
        self._evictions += 1
        return candidate

    def next_eviction(self, process_count: int,
                      seat_available: bool) -> int:
        """The process index to demote this tick, or -1 — read from the
        DEFAULT set's state (pod eviction acts on pod-level slowness).
        Suppressed opportunities (budget spent, no seat) count
        ``policy.evictions_suppressed`` and log once per slow episode."""
        return self._nominate(0, process_count, seat_available)

    def next_eviction_set(self, process_set: int, process_count: int,
                          seat_available: bool) -> int:
        """Per-set eviction candidate (per-set reconfigure decisions):
        same nomination over ``process_set``'s state, sharing the global
        eviction budget."""
        return self._nominate(process_set, process_count, seat_available)

    def rerank_order(self, old_pidx: Sequence[int]) -> List[int]:
        """Survivor order for the next membership: slow hosts sorted to
        the ring's tail so they sit adjacent.  EWMAs are bucketed to
        whole milliseconds so sub-noise differences cannot perturb a
        uniform fleet; the stable sort keeps the dense order within
        a bucket, so "no straggler" reduces to the identity."""
        order = list(old_pidx)
        if not self.rerank_enabled():
            return order
        # Ring order is pod-global: only the default set's EWMAs drive it.
        procs = self._sets.get(0, [])

        def bucket(p: int) -> int:
            if 0 <= p < len(procs) and procs[p].valid:
                return int(procs[p].ewma * 1e3)
            return 0

        order.sort(key=bucket)
        return order

    def autoscale_target(self, tick: int) -> int:
        """The standing world-size target at ``tick`` (-1 = none): the
        last schedule entry at or before the tick, overridden by the
        file seam whenever it holds a positive integer."""
        target = -1
        for entry_tick, entry_target in self._schedule:
            if entry_tick <= tick:
                target = entry_target
        if self._autoscale_file:
            try:
                with open(self._autoscale_file) as f:
                    v = int(f.read().split()[0])
                if v > 0:
                    target = v
            except (OSError, ValueError, IndexError):
                pass
        return target

    # ------------------------------------------------ precision controller

    @property
    def precision_threshold(self) -> float:
        return self._precision_threshold

    @property
    def precision_ticks(self) -> int:
        return self._precision_ticks

    @property
    def precision_promotions(self) -> int:
        return self._precision_promotions

    @property
    def precision_demotions(self) -> int:
        return self._precision_demotions

    def note_precision_bandwidth(self, min_leg_bps: float) -> None:
        """EQuARX gate: when even the slowest observed leg moves bytes
        faster than ``HOROVOD_TPU_PRECISION_BW_BPS``, the wire is not
        the bottleneck and quantization buys nothing — promotion stalls
        (demotion still fires: correctness outranks the gate)."""
        if self._precision_bw_bps <= 0 or min_leg_bps <= 0:
            return
        self._precision_bw_hold = min_leg_bps >= self._precision_bw_bps

    def observe_precision(self, name: str, residual_norm: float) -> None:
        """One residual-norm report for bucket ``name`` (relative:
        ``||residual|| / ||gradient||``).  Demotion is edge-triggered on
        the RAW sample, not the EWMA: one genuine spike must not hide
        behind seven smooth reports.  Promotion needs
        ``precision_ticks`` CONSECUTIVE healthy reports — the same
        hysteresis shape as eviction's consecutive-slow window."""
        if not self._precision_auto or residual_norm < 0:
            return
        ps = self._precision.setdefault(name, _PrecState())
        ps.ewma = (residual_norm if ps.ewma < 0
                   else EWMA_ALPHA * residual_norm
                   + (1.0 - EWMA_ALPHA) * ps.ewma)
        from horovod_tpu_torch.metrics import registry
        registry.set_gauge(f"precision.residual#bucket={name}", ps.ewma)
        if residual_norm > self._precision_threshold:
            ps.healthy = 0
            if ps.level != 0:
                ps.level = 0
                self._precision_dirty = True
                self._precision_demotions += 1
                registry.inc("precision.demotions")
                print(f"horovod_tpu_torch policy: precision DEMOTE {name} "
                      f"-> fp32 (residual={residual_norm:.4f} > threshold="
                      f"{self._precision_threshold:.4f})", file=sys.stderr)
        else:
            ps.healthy += 1
            if (ps.level < 2 and not self._precision_bw_hold
                    and ps.healthy >= self._precision_ticks):
                ps.level += 1
                ps.healthy = 0
                self._precision_dirty = True
                self._precision_promotions += 1
                registry.inc("precision.promotions")
        registry.set_gauge(f"precision.level#bucket={name}", ps.level)

    def precision_level(self, name: str) -> int:
        """Ladder level for ``name``: 0 = fp32, 1 = bf16, 2 = int8.
        Unknown names are level 0 (never promoted without evidence)."""
        ps = self._precision.get(name)
        return ps.level if ps is not None else 0

    def precision_wire(self, name: str) -> str:
        """The level as the negotiated Response wire_dtype string."""
        return PRECISION_WIRE[self.precision_level(name)]

    def precision_ewma(self, name: str) -> float:
        """Residual-norm EWMA for ``name`` (-1 when no report seen)."""
        ps = self._precision.get(name)
        return ps.ewma if ps is not None else -1.0

    def take_precision_dirty(self) -> bool:
        """True once when any level changed since the last call
        (test-and-clear; the coordinator's cache-flush edge)."""
        d = self._precision_dirty
        self._precision_dirty = False
        return d

    def on_reconfigure(self, old_to_new: Sequence[int],
                       new_count: int) -> None:
        """Remap per-process state to the post-reconfigure numbering
        (``old_to_new[p] = -1`` drops p: evicted, dead, or parked).
        Process indices are pod-global in every set's state vector, so
        one membership change remaps them all."""
        for s, procs in self._sets.items():
            nxt = [_ProcState() for _ in range(new_count)]
            for p, np_ in enumerate(old_to_new):
                if 0 <= np_ < new_count and p < len(procs):
                    nxt[np_] = procs[p]
            self._sets[s] = nxt


def make_fleet_policy(prefer_native: bool = True):
    """A fleet-policy decision engine: the native one when the core
    library exports the policy API, else the pure-Python mirror."""
    if prefer_native:
        try:
            from horovod_tpu_torch import cpp_core
            return cpp_core.NativeFleetPolicy()
        except (RuntimeError, OSError):
            pass
    return FleetPolicy()
