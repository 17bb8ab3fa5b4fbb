"""The port's fleet policy (``horovod_tpu_torch/policy.py``) and the native
policy binding (``cpp_core.NativeFleetPolicy``), held against the JAX
package's ``horovod_tpu/policy.py``.

Every case is a trace: a list of calls (observations, bandwidth notes,
queries) played through the reference's ``FleetPolicy``, the port's, and
the port's native binding where the trace uses only what the native
engine exposes.  Every query's answer must be the same in all of them:
levels, wires, EWMAs, the dirty edge, counters, eviction nominations,
re-rank orders and autoscale targets.  The env readers and
``parse_autoscale_script`` are held the same way, error texts included.
"""

import pytest

from horovod_tpu import policy as ref_policy
from horovod_tpu.metrics import registry as ref_registry
from horovod_tpu_torch import cpp_core
from horovod_tpu_torch import policy
from horovod_tpu_torch.metrics import registry

KNOBS = ("PRECISION", "PRECISION_THRESHOLD", "PRECISION_TICKS",
         "PRECISION_BW_BPS", "EVICT_THRESHOLD", "EVICT_TICKS", "EVICT_MAX",
         "POLICY_RERANK", "AUTOSCALE", "AUTOSCALE_FILE")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)


def _arm(monkeypatch, **knobs):
    for knob, value in knobs.items():
        monkeypatch.setenv("HOROVOD_TPU_" + knob.upper(), value)


def _play(engine, trace):
    """Apply ``trace`` to ``engine``; the answers of its queries, in
    order."""
    out = []
    for op, *args in trace:
        if op == "prec":
            engine.observe_precision(*args)
        elif op == "bw":
            engine.note_precision_bandwidth(*args)
        elif op == "tick":
            engine.observe_tick(*args)
        elif op == "tick_set":
            engine.observe_tick_set(*args)
        elif op == "state":
            name = args[0]
            out.append((engine.precision_level(name),
                        engine.precision_wire(name),
                        engine.precision_ewma(name),
                        engine.take_precision_dirty(),
                        engine.precision_promotions,
                        engine.precision_demotions))
        elif op == "evict":
            out.append(engine.next_eviction(*args))
        elif op == "evict_set":
            out.append(engine.next_eviction_set(*args))
        elif op == "slow":
            out.append([(engine.ewma(p), engine.consecutive_slow(p))
                        for p in range(args[0])])
        elif op == "slow_set":
            s, n = args
            out.append([(engine.ewma_set(s, p),
                         engine.consecutive_slow_set(s, p))
                        for p in range(n)])
        elif op == "rerank":
            out.append(engine.rerank_order(list(args[0])))
        elif op == "scale":
            out.append(engine.autoscale_target(args[0]))
        elif op == "armed":
            out.append((engine.active(),))
        else:
            raise ValueError(op)
    return out


def _native():
    try:
        return cpp_core.NativeFleetPolicy()
    except RuntimeError:
        pytest.skip("native core not built")


def _hold(trace, native=True):
    """The trace's answers from the reference, the port and (``native``)
    the native binding; all equal."""
    want = _play(ref_policy.FleetPolicy(), trace)
    assert _play(policy.FleetPolicy(), trace) == want
    if native:
        nat = _native()
        try:
            got = _play(nat, trace)
        finally:
            nat.close()
        assert got == want
    return want


# ----------------------------------------------------------- the ladder

_TRACE = [0.01, 0.01, 0.01, 0.2, 0.01, 0.01, 0.01, 0.01]

LADDER = {
    # 3 healthy -> bf16, the spike -> fp32, 3 healthy -> bf16 again.
    "promote_demote_repromote": (
        {"precision": "auto", "precision_ticks": "3"},
        [x for r in _TRACE for x in (("prec", "b", r), ("state", "b"))]),
    "full_climb_to_int8": (
        {"precision": "auto", "precision_ticks": "2"},
        [x for _ in range(14) for x in (("prec", "b", 0.01),
                                        ("state", "b"))]),
    # One raw sample over the threshold demotes while the EWMA is smooth.
    "edge_triggered_demotion": (
        {"precision": "auto", "precision_ticks": "2",
         "precision_threshold": "0.05"},
        [("prec", "b", 0.001)] * 20 + [("state", "b"), ("prec", "b", 0.06),
                                       ("state", "b")]),
    "spike_at_fp32_is_no_demotion": (
        {"precision": "auto"},
        [("prec", "b", 0.9), ("state", "b"), ("state", "never seen")]),
    "bandwidth_gate": (
        {"precision": "auto", "precision_ticks": "2",
         "precision_bw_bps": "1e9"},
        [("bw", 2e9)] + [("prec", "b", 0.01)] * 6
        + [("state", "b"), ("bw", 1e8), ("prec", "b", 0.01), ("state", "b"),
           ("bw", 2e9), ("prec", "b", 0.9), ("state", "b")]),
    "static_is_inert": (
        {"precision": "static"},
        [("prec", "b", 0.0)] * 50 + [("state", "b"), ("armed",)]),
    "interleaved_buckets": (
        {"precision": "auto", "precision_ticks": "2",
         "precision_threshold": "0.02"},
        [x for i in range(12) for x in (
            ("prec", "grads['w']", 0.001 * (i + 1)),
            ("prec", "DistributedOptimizer.grads.bucket0",
             0.5 if i == 7 else 0.003),
            ("state", "grads['w']"),
            ("state", "DistributedOptimizer.grads.bucket0"))]),
    "negative_residual_is_no_report": (
        {"precision": "auto", "precision_ticks": "1"},
        [("prec", "b", -1.0), ("state", "b"), ("prec", "b", 0.0),
         ("state", "b")]),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_ladder_trace_matches_reference_and_native(monkeypatch, case):
    knobs, trace = LADDER[case]
    _arm(monkeypatch, **knobs)
    answers = _hold(trace)
    if case == "promote_demote_repromote":
        assert answers[-1][:2] == (1, "bf16") and answers[-1][4:] == (2, 1)
    if case == "full_climb_to_int8":
        assert answers[3][:2] == (2, "int8") and answers[-1][0] == 2
    if case == "edge_triggered_demotion":
        assert answers[0][0] == 2 and answers[1][0] == 0
        assert answers[1][2] < 0.05          # the EWMA is still smooth
    if case == "static_is_inert":
        assert answers[0][0] == 0 and answers[0][4] == 0


def test_take_precision_dirty_is_test_and_clear(monkeypatch):
    _arm(monkeypatch, precision="auto", precision_ticks="2")
    for engine in (ref_policy.FleetPolicy(), policy.FleetPolicy(),
                   _native()):
        seen = [engine.take_precision_dirty()]
        for r in (0.01, 0.01, 0.01, 0.9):
            engine.observe_precision("b", r)
            seen += [engine.take_precision_dirty(),
                     engine.take_precision_dirty()]
        assert seen == [False, False, False, True, False, False, False,
                        True, False]


def test_env_readers_match_reference(monkeypatch):
    values = {"PRECISION": ["auto", "static", "AUTO", ""],
              "PRECISION_THRESHOLD": ["0.1", "-1", "x", "0"],
              "PRECISION_TICKS": ["3", "0", "-2", "x"],
              "PRECISION_BW_BPS": ["1e9", "-5", "x"],
              "EVICT_THRESHOLD": ["0.25", "-1", "x"],
              "EVICT_TICKS": ["7", "0", "x"],
              "EVICT_MAX": ["2", "-1", "x"],
              "POLICY_RERANK": ["0", "1", "no"]}
    readers = ("precision_auto_from_env", "precision_threshold_from_env",
               "precision_ticks_from_env", "precision_bw_bps_from_env",
               "evict_threshold_s_from_env", "evict_ticks_from_env",
               "evict_max_from_env", "rerank_enabled_from_env")

    def read():
        return [getattr(policy, f)() for f in readers]

    assert read() == [getattr(ref_policy, f)() for f in readers]
    for knob, vals in values.items():
        for v in vals:
            monkeypatch.setenv("HOROVOD_TPU_" + knob, v)
            assert read() == [getattr(ref_policy, f)() for f in readers], \
                (knob, v)
        monkeypatch.delenv("HOROVOD_TPU_" + knob)
    assert policy.PRECISION_WIRE == ref_policy.PRECISION_WIRE
    assert policy.EWMA_ALPHA == ref_policy.EWMA_ALPHA


@pytest.mark.parametrize("script", [
    "tick:30=4,tick:10=2", "tick:10=2,", "", " tick:5=1 , tick:6=3",
    "tick:banana", "tock:1=2", "tick:1", "tick:0=2", "tick:1=-2",
    "tick:x=2"])
def test_parse_autoscale_script_matches_reference(script):
    def outcome(mod):
        try:
            return ("ok", mod.parse_autoscale_script(script))
        except ValueError as e:
            return ("error", str(e))

    assert outcome(policy) == outcome(ref_policy)


def test_precision_metrics_and_demote_line(monkeypatch, capsys):
    """The ladder's gauges and counters in the port's registry under the
    reference's names; the demote line is the reference's, naming this
    package."""
    _arm(monkeypatch, precision="auto", precision_ticks="2")
    before = registry.snapshot()["counters"]
    p = policy.FleetPolicy()
    for r in (0.01, 0.01, 0.9):
        p.observe_precision("m/kernel:0", r)
    snap = registry.snapshot()
    moved = {k: snap["counters"].get(k, 0) - before.get(k, 0)
             for k in ("precision.promotions", "precision.demotions")}
    assert moved == {"precision.promotions": 1, "precision.demotions": 1}
    assert snap["gauges"]["precision.level#bucket=m/kernel:0"] == 0
    assert snap["gauges"]["precision.residual#bucket=m/kernel:0"] > 0
    mine = capsys.readouterr().err
    ref_policy.FleetPolicy()
    r = ref_policy.FleetPolicy()
    for x in (0.01, 0.01, 0.9):
        r.observe_precision("m/kernel:0", x)
    theirs = capsys.readouterr().err
    assert mine == theirs.replace("horovod_tpu policy",
                                  "horovod_tpu_torch policy")
    assert mine.startswith("horovod_tpu_torch policy: precision DEMOTE "
                           "m/kernel:0 -> fp32 (residual=0.9000")
    assert ref_registry.snapshot()["gauges"][
        "precision.level#bucket=m/kernel:0"] == 0


def test_make_fleet_policy(monkeypatch):
    assert isinstance(policy.make_fleet_policy(prefer_native=False),
                      policy.FleetPolicy)
    got = policy.make_fleet_policy()
    want = (cpp_core.NativeFleetPolicy if cpp_core.available()
            else policy.FleetPolicy)
    assert isinstance(got, want)


# ------------------------------------------ eviction, re-rank, autoscale

def _waits(tick, slow, n=4, base=0.001, extra=0.05):
    return ("tick", tick, [base + (extra if p in slow else 0.0)
                           for p in range(n)])


EVICTION = {
    "straggler_after_window": (
        {"evict_threshold": "0.02", "evict_ticks": "3"},
        [x for t in range(5) for x in (_waits(t, {2}), ("slow", 4),
                                       ("evict", 4, True))]),
    "single_spike_no_eviction": (
        {"evict_threshold": "0.02", "evict_ticks": "3"},
        [_waits(0, {1}), _waits(1, set()), _waits(2, set()),
         _waits(3, set()), ("slow", 4), ("evict", 4, True)]),
    "recovery_resets_window": (
        {"evict_threshold": "0.02", "evict_ticks": "3"},
        [_waits(0, {3}), _waits(1, {3}), ("slow", 4), _waits(2, set()),
         ("slow", 4), _waits(3, {3}), _waits(4, {3}), ("evict", 4, True)]),
    "fleet_wide_slowdown": (
        {"evict_threshold": "0.02", "evict_ticks": "2"},
        [_waits(t, {0, 1, 2, 3}) for t in range(4)]
        + [("slow", 4), ("evict", 4, True)]),
    "budget_and_seat": (
        {"evict_threshold": "0.02", "evict_ticks": "2", "evict_max": "1"},
        [_waits(t, {1}) for t in range(3)]
        + [("evict", 4, False), ("evict", 4, True), ("evict", 4, True)]),
    "coordinator_never_candidate": (
        {"evict_threshold": "0.02", "evict_ticks": "1"},
        [_waits(t, {0}) for t in range(3)] + [("evict", 4, True)]),
    "worst_candidate_wins": (
        {"evict_threshold": "0.01", "evict_ticks": "2", "evict_max": "3"},
        [("tick", t, [0.001, 0.03, 0.001, 0.08, 0.001]) for t in range(3)]
        + [("evict", 5, True), ("slow", 5)]),
    "missing_samples": (
        {"evict_threshold": "0.02", "evict_ticks": "2"},
        [("tick", 0, [0.001, -1.0, 0.06, 0.001]),
         ("tick", 1, [0.001, 0.002, -1.0, 0.001]),
         ("tick", 2, [0.001, 0.002, 0.06, 0.001]),
         ("slow", 4), ("evict", 4, True)]),
    "rerank_straggler_last": (
        {"evict_threshold": "0.5"},
        [("tick", t, [0.001, 0.004, 0.001, 0.0015]) for t in range(4)]
        + [("rerank", [0, 1, 2, 3]), ("rerank", [3, 1, 0, 2])]),
    "rerank_off": (
        {"evict_threshold": "0.5", "policy_rerank": "0"},
        [("tick", 0, [0.001, 0.009, 0.001]), ("rerank", [0, 1, 2])]),
    "rerank_unarmed_is_identity": (
        {},
        [("tick", 0, [0.001, 0.009, 0.001]), ("rerank", [2, 1, 0]),
         ("armed",)]),
    "autoscale_schedule": (
        {"autoscale": "tick:30=4,tick:10=2"},
        [("scale", t) for t in (0, 9, 10, 29, 30, 100)] + [("armed",)]),
    "per_set_state": (
        {"evict_threshold": "0.02", "evict_ticks": "2", "evict_max": "2"},
        [("tick_set", 3, [0.001, 0.05, 0.001, 0.001]) for _ in range(3)]
        + [("slow_set", 3, 4), ("slow", 4), ("evict", 4, True),
           ("evict_set", 3, 4, True), ("evict_set", 3, 4, True)]),
}


@pytest.mark.parametrize("case", sorted(EVICTION))
def test_fleet_trace_matches_reference_and_native(monkeypatch, case):
    knobs, trace = EVICTION[case]
    _arm(monkeypatch, **knobs)
    answers = _hold(trace)
    if case == "straggler_after_window":
        # Nominated on the third slow gather; the budget of one is then
        # spent.
        assert answers[1::2] == [-1, -1, 2, -1, -1]
    if case == "rerank_straggler_last":
        assert answers == [[0, 2, 3, 1], [3, 0, 2, 1]]


def test_tick_attribution_and_remap_match_reference(monkeypatch):
    """The Python engines alone: ``observe_tick``'s per-set attribution
    and ``on_reconfigure``'s remap (the native binding has neither)."""
    _arm(monkeypatch, evict_threshold="0.02", evict_ticks="2",
         evict_max="3")
    trace = [("tick", t, [0.001, 0.05, 0.001, 0.06], [0, 2, 0, 0])
             for t in range(3)]
    trace += [("slow", 4), ("slow_set", 2, 4), ("evict", 4, True),
              ("evict_set", 2, 4, True)]
    engines = (ref_policy.FleetPolicy(), policy.FleetPolicy())
    assert _play(engines[0], trace) == _play(engines[1], trace)
    for e in engines:
        e.on_reconfigure([0, -1, 2, 1], 3)
    after = [("slow", 3), ("slow_set", 2, 3), ("rerank", [0, 1, 2])]
    assert _play(engines[0], after) == _play(engines[1], after)


def test_budget_suppression_logs_and_counts(monkeypatch, capsys):
    _arm(monkeypatch, evict_threshold="0.02", evict_ticks="2",
         evict_max="0")
    before = registry.snapshot()["counters"].get(
        "policy.evictions_suppressed", 0)
    p = policy.FleetPolicy()
    for t in range(4):
        p.observe_tick(t, [0.001, 0.06, 0.001])
        assert p.next_eviction(3, True) == -1
    after = registry.snapshot()["counters"]["policy.evictions_suppressed"]
    assert after - before == 3
    err = capsys.readouterr().err
    assert err.count("horovod_tpu_torch policy: NOT evicting straggler "
                     "process 1 (set 0") == 1
    assert "HOROVOD_TPU_EVICT_MAX exhausted" in err


def test_autoscale_file_seam_matches_reference(monkeypatch, tmp_path):
    sig = tmp_path / "target"
    _arm(monkeypatch, autoscale="tick:10=2", autoscale_file=str(sig))
    trace = [("scale", 5), ("scale", 12)]
    for content in (None, "6\n", "banana", "0", "3 extra"):
        if content is None:
            if sig.exists():
                sig.unlink()
        else:
            sig.write_text(content)
        _hold(trace)


def test_malformed_autoscale_knob_warns_and_disarms(monkeypatch, capsys):
    _arm(monkeypatch, autoscale="tick:banana")
    p = policy.FleetPolicy()
    assert not p.autoscale_enabled() and not p.active()
    err = capsys.readouterr().err
    ref_policy.FleetPolicy()
    assert err == capsys.readouterr().err.replace(
        "horovod_tpu policy", "horovod_tpu_torch policy")
