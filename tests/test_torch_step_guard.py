"""The train step's guard and instruments in the port against the JAX
package's (``horovod_tpu/jax/spmd.py:244-532``), on the CPU.

* Wire plan: ``estimate_wire_plan`` of the port equals the JAX
  package's for n 1, 2, 4 and 8, the none, bf16 and int8 wires, flat and
  two-tier, with ``HOROVOD_TPU_INJIT_INT8_FLOOR`` set and unset; the
  ``"auto"`` marker counts what the reference counts for its frozen
  autopilot builds.  ``record_wire_plan`` moves the counters as the
  reference's test of it checks.
* Wire counters: a 2-process gloo job (``_torch_step_guard_worker``,
  spawned once for the file): one call of the port's step moves
  ``injit.bytes#wire_dtype=*`` and ``injit.steps`` by the reference's
  estimate for the same shapes, times ``steps_per_call``, on every route.
* Guard: with a controller whose hazard count is 2, the port's step
  raises the reference's ``RuntimeError`` word for word (the text the JAX
  step raises under the same stub) before it runs anything; at 0 it runs.
  The eval step is not guarded, as in the reference.
* Spans: with a timeline on the controller, three steps write the same
  DISPATCH and EXECUTE lanes and events as the JAX step, through both
  writers, each EXECUTE after its DISPATCH; a raising step closes its
  DISPATCH.
* Observatory: a scripted clock gives the same ``note_step`` arguments
  as the reference's ``_wire_observe``, with ``steps_per_call`` 1 and 3.
* Watchdog: a process whose step blocks inside the call exits 83 with
  "step watchdog"; healthy steps with an idle gap longer than the deadline
  never fire it; the 2-process gloo crash drill of
  ``tests/test_multicontroller.py:147-190``, launched from the environment
  with no control plane, ends within its bound.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import horovod_tpu_torch as hvd
from _torch_spmd_worker import once, run_group
from _torch_step_guard_worker import CASES, batch_of, injit_counts, mlp, mse
from horovod_tpu import basics as jbasics
from horovod_tpu import cpp_core as jcpp
from horovod_tpu import observe as jobserve
from horovod_tpu.jax import spmd as jspmd
from horovod_tpu.ops import quantized_collectives as jqc
from horovod_tpu.timeline import Timeline as JTimeline
from horovod_tpu_torch import basics as tbasics
from horovod_tpu_torch import cpp_core as tcpp
from horovod_tpu_torch import observe as tobserve
from horovod_tpu_torch import spmd as tspmd
from horovod_tpu_torch.metrics import registry as tregistry
from horovod_tpu_torch.ops import quantized_collectives as tqc
from horovod_tpu_torch.timeline import Timeline as TTimeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_step_guard_worker.py")

_PLAN_SHAPES = [((512, 64), "float32"), ((64,), "float32"),
                ((8, 512), "float32"), ((300, 7), "float32"),
                ((128, 128), "bfloat16"), ((64, 256), "float16"),
                ((10,), "int32"), ((40, 3), "int64"),
                ((1000, 100), "float32"), ((), "float32")]


def _leaves(shapes):
    jleaves = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in shapes]
    tleaves = [torch.empty(s, dtype=getattr(torch, d)) for s, d in shapes]
    return jleaves, tleaves


@pytest.fixture()
def no_wire_knobs(monkeypatch):
    for knob in ("INJIT_WIRE_DTYPE", "INJIT_INT8_FLOOR"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)


# -------------------------------------------------------------- wire plan


@pytest.mark.parametrize("floor", [None, "0", "4096"])
@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("compression", ["none", "bf16", "int8"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_estimate_wire_plan_matches_jax(no_wire_knobs, monkeypatch, n,
                                        compression, hierarchical, floor):
    if floor is not None:
        monkeypatch.setenv("HOROVOD_TPU_INJIT_INT8_FLOOR", floor)
    jleaves, tleaves = _leaves(_PLAN_SHAPES)
    want = jqc.estimate_wire_plan(jleaves, n, compression,
                                  hierarchical=hierarchical)
    got = tqc.estimate_wire_plan(tleaves, n, compression,
                                 hierarchical=hierarchical)
    assert got == want
    assert (got == {}) == (n == 1)


@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("n", [2, 8])
def test_auto_counts_the_reference_frozen_plan(no_wire_knobs, monkeypatch,
                                               n, hierarchical):
    """``"auto"`` counts what the reference's frozen rebuild
    (``compression=_AUTO_FROZEN``) counts: every leaf at its own dtype,
    whatever ``HOROVOD_TPU_INJIT_WIRE_DTYPE`` says."""
    monkeypatch.setenv("HOROVOD_TPU_INJIT_WIRE_DTYPE", "int8")
    jleaves, tleaves = _leaves(_PLAN_SHAPES)
    want = jqc.estimate_wire_plan(jleaves, n, jspmd._AUTO_FROZEN,
                                  hierarchical=hierarchical)
    assert tqc.estimate_wire_plan(tleaves, n, "auto",
                                  hierarchical=hierarchical) == want
    assert "int8" not in want and "fp32" in want


def test_record_wire_plan_counters():
    """The reference's check (``tests/test_quantized_collectives.py:
    293-303``) on the port's registry, and the same deltas from the
    reference's ``record_wire_plan`` on its own."""
    from horovod_tpu.metrics import registry as jregistry
    plan = {"int8": 1000, "fp32": 64}
    deltas = {}
    for name, reg, record in (("port", tregistry, tqc.record_wire_plan),
                              ("jax", jregistry, jqc.record_wire_plan)):
        before = reg.snapshot()["counters"]
        record(plan, steps=3)
        record({}, steps=5)            # an empty plan counts nothing
        after = reg.snapshot()["counters"]
        deltas[name] = {k: after[k] - before.get(k, 0) for k in after
                        if k.startswith("injit.")
                        and after[k] != before.get(k, 0)}
    assert deltas["port"] == deltas["jax"] == {
        "injit.bytes#wire_dtype=int8": 3000,
        "injit.bytes#wire_dtype=fp32": 192, "injit.steps": 3}


@pytest.fixture(scope="module")
def injit_run(request, tmp_path_factory):
    return once(request, tmp_path_factory, "step_guard_injit",
                lambda: run_group(injit_counts, 2))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-spc{c[1]}"
                         + ("-two_tier" if c[2] else ""))
def test_step_counts_the_reference_wire_plan(injit_run, no_wire_knobs,
                                             case):
    compression, spc, two_tier = case
    for rank in range(2):
        out = injit_run[rank]
        assert out["size"] == 2
        leaves = [jax.ShapeDtypeStruct(s, jnp.dtype(d))
                  for s, d in out["leaves"]]
        plan = jqc.estimate_wire_plan(
            leaves, 2,
            jspmd._AUTO_FROZEN if compression == "auto" else compression,
            hierarchical=two_tier)
        want = {f"injit.bytes#wire_dtype={k}": v * spc
                for k, v in plan.items()}
        want["injit.steps"] = spc
        assert out[case] == want, (rank, case)
    if compression == "int8" and not two_tier:
        assert "injit.bytes#wire_dtype=int8" in injit_run[0][case]


def test_single_process_step_counts_nothing(no_wire_knobs):
    model = mlp()
    step = tspmd.make_train_step(model, mse, torch.optim.SGD(
        model.parameters(), lr=0.01), compression="int8")
    before = tregistry.snapshot()["counters"]
    step(batch_of(0))
    after = tregistry.snapshot()["counters"]
    assert {k: v for k, v in after.items() if k.startswith("injit.")} == \
        {k: v for k, v in before.items() if k.startswith("injit.")}


# ------------------------------------------------------------------ guard


def _stub(hazard):
    return types.SimpleNamespace(mesh_async_hazard=lambda: hazard,
                                 timeline=None)


def _jax_guard_text(monkeypatch, hazard):
    """What the JAX package's own step raises under a controller whose
    hazard count is ``hazard`` (None when it runs)."""
    monkeypatch.setattr(jbasics._state, "controller", _stub(hazard))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("ranks",))
    params = {"w": jnp.zeros((4, 1)), "b": jnp.zeros((1,))}
    x = np.ones((8, 4), np.float32)

    def loss_fn(params, aux, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), aux

    tx = optax.sgd(0.1)
    step = jspmd.make_train_step(loss_fn, tx, mesh, sync_aux_state=False,
                                 donate=False)
    try:
        step(params, {}, tx.init(params), (x, x[:, :1]))
    except RuntimeError as e:
        return str(e)
    return None


def _counting_loss(calls):
    def loss(model, batch):
        calls.append(1)
        return mse(model, batch)
    return loss


def test_guard_raises_the_reference_text(monkeypatch):
    want = _jax_guard_text(monkeypatch, 2)
    assert want is not None and "2 async eager collective(s)" in want
    with pytest.raises(RuntimeError) as exc:
        jbasics.check_mesh_async_ordering("make_train_step")
    assert str(exc.value) == want
    monkeypatch.setattr(tbasics._state, "controller", _stub(2))
    model, calls = mlp(), []
    start = [p.detach().clone() for p in model.parameters()]
    step = tspmd.make_train_step(model, _counting_loss(calls),
                                 torch.optim.SGD(model.parameters(),
                                                 lr=0.1))
    with pytest.raises(RuntimeError) as exc:
        step(batch_of(0))
    assert str(exc.value) == want
    with pytest.raises(RuntimeError) as exc:
        tbasics.check_mesh_async_ordering("make_train_step")
    assert str(exc.value) == want
    # Raised before the step ran anything.
    assert calls == []
    assert all(torch.equal(a, p)
               for a, p in zip(start, model.parameters()))


@pytest.mark.parametrize("spc", [1, 3])
def test_guard_at_zero_runs_the_step(monkeypatch, spc):
    assert _jax_guard_text(monkeypatch, 0) is None
    monkeypatch.setattr(tbasics._state, "controller", _stub(0))
    model, calls = mlp(), []
    start = [p.detach().clone() for p in model.parameters()]
    step = tspmd.make_train_step(model, _counting_loss(calls),
                                 torch.optim.SGD(model.parameters(),
                                                 lr=0.1),
                                 steps_per_call=spc)
    loss = step(batch_of(0, (spc,) if spc > 1 else ()))
    assert torch.isfinite(loss) and len(calls) == spc
    assert not all(torch.equal(a, p)
                   for a, p in zip(start, model.parameters()))


def test_guard_is_a_no_op_before_init():
    hvd.shutdown()
    assert tbasics._state.controller is None
    tbasics.check_mesh_async_ordering("make_train_step")


def test_eval_step_is_not_guarded(monkeypatch):
    monkeypatch.setattr(tbasics._state, "controller", _stub(2))
    model = mlp()
    ev = tspmd.make_eval_step(model, mse)
    assert torch.isfinite(ev(batch_of(0)))


def test_auto_step_is_guarded(monkeypatch):
    monkeypatch.setattr(tbasics._state, "controller", _stub(1))
    model = mlp()
    step = tspmd.make_train_step(model, mse, torch.optim.SGD(
        model.parameters(), lr=0.1), compression="auto")
    with pytest.raises(RuntimeError, match="1 async eager collective"):
        step(batch_of(0))


# ------------------------------------------------------------------ spans


_LANES = ("train_step/dispatch", "train_step/execute")


def _lanes(path):
    """{lane without its [n] suffix: [(ph, name, ts)]} of the step's two
    lanes, and every event of the trace."""
    events = json.loads(path.read_text())
    lane_of = {e["pid"]: re.sub(r"\[\d+\]", "", e["args"]["name"])
               for e in events if e.get("name") == "process_name"}
    lanes = {}
    for e in events:
        lane = lane_of.get(e.get("pid"))
        if lane in _LANES and e.get("ph") in ("B", "E"):
            lanes.setdefault(lane, []).append(
                (e["ph"], e.get("name"), e["ts"]))
    return lanes, events


def _writer(backend, cpp_module, python_cls, path):
    if backend == "cpp":
        if not cpp_module.available():
            pytest.skip("native core not built")
        return cpp_module.CppTimeline(str(path))
    return python_cls(str(path))


def _jax_lanes(backend, tmp_path, steps):
    """The reference's own timeline test, ``tests/test_spmd_step.py:
    181-248``: ``steps`` steps of its make_train_step on the rank mesh."""
    import horovod_tpu as jhvd
    jhvd.init()
    path = tmp_path / "jax.json"
    controller = jbasics._state.controller
    controller.timeline = _writer(backend, jcpp, JTimeline, path)
    try:
        mesh = jhvd.ranks_mesh()
        rng = np.random.RandomState(0)
        x = rng.randn(32, 8).astype(np.float32)
        y = x @ rng.randn(8, 1).astype(np.float32)
        params = {"w": jnp.zeros((8, 1)), "b": jnp.zeros((1,))}

        def loss_fn(params, aux, batch):
            x, y = batch
            return jnp.mean((x @ params["w"] + params["b"] - y) ** 2), aux

        tx = optax.sgd(0.05)
        sh = NamedSharding(mesh, P("ranks"))
        batch = (jax.device_put(x, sh), jax.device_put(y, sh))
        step = jspmd.make_train_step(loss_fn, tx, mesh,
                                     sync_aux_state=False, donate=False)
        opt_state, aux = tx.init(params), {}
        for _ in range(steps):
            params, aux, opt_state, loss = step(params, aux, opt_state,
                                                batch)
        jax.block_until_ready(loss)
        time.sleep(0.5)
    finally:
        timeline, controller.timeline = controller.timeline, None
        timeline.close()
    return _lanes(path)[0]


@pytest.fixture()
def size1(monkeypatch):
    """The port's ``hvd.init()`` at size 1 on the CPU with no launcher,
    timeline or step knob; shut down after the test."""
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "TIMELINE", "STEP_TIMEOUT_S", "OBSERVE"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("backend", ["python", "cpp"])
def test_train_step_writes_the_reference_lanes(size1, tmp_path, backend):
    steps = 3
    want = _jax_lanes(backend, tmp_path, steps)
    path = tmp_path / "port.json"
    controller = tbasics._state.controller
    controller.timeline = _writer(backend, tcpp, TTimeline, path)
    try:
        model = mlp()
        step = tspmd.make_train_step(model, mse, torch.optim.SGD(
            model.parameters(), lr=0.05))
        for _ in range(steps):
            step(batch_of(0))
        # Negotiated tensors keep their QUEUE span beside the lanes.
        for i in range(2):
            hvd.allreduce(torch.ones(4), name=f"tq.{i}")
        time.sleep(0.5)
    finally:
        timeline, controller.timeline = controller.timeline, None
        timeline.close()
    got, events = _lanes(path)
    strip = {lane: [(ph, name) for ph, name, _ in evs]
             for lane, evs in got.items()}
    assert strip == {lane: [(ph, name) for ph, name, _ in evs]
                     for lane, evs in want.items()}
    for lane, name in zip(_LANES, ("DISPATCH", "EXECUTE")):
        assert [ph for ph, _ in strip[lane]] == ["B", "E"] * steps
        assert [n for ph, n in strip[lane] if ph == "B"] == [name] * steps
    d_end = [ts for ph, _, ts in got["train_step/dispatch"] if ph == "E"]
    x_begin = [ts for ph, _, ts in got["train_step/execute"] if ph == "B"]
    x_end = [ts for ph, _, ts in got["train_step/execute"] if ph == "E"]
    assert all(b >= d for b, d in zip(x_begin, d_end))
    assert all(e >= b for e, b in zip(x_end, x_begin))
    pid_of = {e["args"]["name"]: e["pid"] for e in events
              if e.get("name") == "process_name"}
    for i in range(2):
        names = [e.get("name") for e in events
                 if e.get("pid") == pid_of[f"tq.{i}"]
                 and e.get("ph") == "B"]
        assert names.count("QUEUE") == 1, names


def test_raising_step_closes_its_dispatch(size1, tmp_path):
    path = tmp_path / "raise.json"
    controller = tbasics._state.controller
    controller.timeline = TTimeline(str(path))
    try:
        model = mlp()

        def broken(model, batch):
            raise ValueError("broken loss")

        step = tspmd.make_train_step(model, broken, torch.optim.SGD(
            model.parameters(), lr=0.05))
        with pytest.raises(ValueError, match="broken loss"):
            step(batch_of(0))
    finally:
        timeline, controller.timeline = controller.timeline, None
        timeline.close()
    lanes, _ = _lanes(path)
    assert [ph for ph, _, _ in lanes["train_step/dispatch"]] == ["B", "E"]
    assert "train_step/execute" not in lanes


def test_each_step_gets_its_own_lanes(size1, tmp_path):
    path = tmp_path / "two.json"
    controller = tbasics._state.controller
    controller.timeline = TTimeline(str(path))
    try:
        for _ in range(2):
            model = mlp()
            tspmd.make_train_step(model, mse, torch.optim.SGD(
                model.parameters(), lr=0.05))(batch_of(0))
        time.sleep(0.3)
    finally:
        timeline, controller.timeline = controller.timeline, None
        timeline.close()
    events = json.loads(path.read_text())
    lanes = [e["args"]["name"] for e in events
             if e.get("name") == "process_name"
             and e["args"]["name"].endswith("/dispatch")]
    assert len(lanes) == 2 and len(set(lanes)) == 2
    assert all(re.fullmatch(r"train_step(\[\d+\])?/dispatch", n)
               for n in lanes), lanes


# ----------------------------------------------------------- observatory


@pytest.mark.parametrize("spc", [1, 3])
def test_observe_feeds_the_reference_note_step(monkeypatch, spc):
    rng = np.random.default_rng(5)
    ticks = list(np.cumsum(rng.uniform(0.001, 0.2, 40)) + 100.0)
    enabled = [True, True, True, False, True, True, True, True]
    calls = {}
    for name, spmd_mod, obs_mod in (("jax", jspmd, jobserve),
                                    ("port", tspmd, tobserve)):
        clock, flags = iter(ticks), iter(enabled)
        monkeypatch.setattr(spmd_mod, "time", types.SimpleNamespace(
            perf_counter=lambda: next(clock)))
        monkeypatch.setattr(obs_mod, "enabled", lambda: next(flags))
        calls[name] = []
        monkeypatch.setattr(obs_mod, "note_step",
                            lambda *a, _c=calls[name]: _c.append(a))
        wrapped = spmd_mod._wire_observe(lambda *a: None, spc)
        for _ in enabled:
            wrapped(None)
    assert calls["port"] == calls["jax"]
    # The first call and the first after the observatory was off feed
    # nothing.
    assert len(calls["port"]) == len(enabled) - 3
    for step_s, compute_s, hidden, exposed, stall_s in calls["port"]:
        assert (hidden, exposed) == (0.0, 0.0)
        assert compute_s == max(0.0, step_s - stall_s)


def test_train_step_notes_every_call_after_the_first(monkeypatch):
    monkeypatch.setattr(tobserve, "enabled", lambda: True)
    model = mlp()
    step = tspmd.make_train_step(model, mse, torch.optim.SGD(
        model.parameters(), lr=0.05))
    before = tregistry.snapshot()["counters"].get("step.count", 0)
    for _ in range(4):
        step(batch_of(0))
    assert tregistry.snapshot()["counters"]["step.count"] - before == 3


# --------------------------------------------------------------- watchdog


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_TPU_", "MASTER_"))}
    env.update(PYTHONPATH=ROOT)
    env.update(extra)
    return env


def _run(args, env, timeout):
    proc = subprocess.run([sys.executable, WORKER] + args, env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def test_watchdog_ends_a_step_blocked_inside_the_call():
    t0 = time.monotonic()
    rc, out, err = _run(["block"], _env(HOROVOD_TPU_STEP_TIMEOUT_S="1"),
                        timeout=50)
    elapsed = time.monotonic() - t0
    assert rc == 83, (rc, out, err)
    assert "BLOCKING" in out and "STEP_RETURNED" not in out, out
    assert ("horovod_tpu_torch: step watchdog: a dispatched train step "
            "did not complete within HOROVOD_TPU_STEP_TIMEOUT_S=1s"
            ) in err, err
    assert elapsed < 40, elapsed


def test_watchdog_spares_healthy_steps_and_idle_gaps():
    rc, out, err = _run(["healthy", "2.0"],
                        _env(HOROVOD_TPU_STEP_TIMEOUT_S="0.75"), timeout=60)
    assert rc == 0, (rc, out, err)
    assert "HEALTHY_DONE" in out and "step watchdog" not in err, err


def test_watchdog_unset_starts_no_thread(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_STEP_TIMEOUT_S", raising=False)

    def watchers():
        return sum(t.name == "horovod_tpu_torch-step-watchdog"
                   for t in threading.enumerate())

    before = watchers()
    model = mlp()
    tspmd.make_train_step(model, mse, torch.optim.SGD(
        model.parameters(), lr=0.05))(batch_of(0))
    assert watchers() == before


def test_done_never_raises_into_a_watcher():
    class Broken:
        def query(self):
            raise RuntimeError("device lost")

        def synchronize(self):
            raise RuntimeError("device lost")

    done = tspmd._Done()
    assert not done.ready()            # the call has not returned
    done.finish(torch.zeros(()))       # a CPU result: done at return
    assert done.ready() and done.event is None
    done.event = Broken()
    assert done.ready()
    done.wait()
    failed = tspmd._Done()
    failed.finish(None)                # the call raised
    assert failed.ready()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_mid_training_peer_crash_is_bounded():
    """The reference's drill (``tests/test_multicontroller.py:147-190``)
    on the port: two gloo ranks launched from the environment, no control
    plane, ``HOROVOD_TPU_STEP_TIMEOUT_S=8``; rank 1 exits 17 after three
    steps; the survivor ends with the watchdog's 83 or a surfaced error's
    3, within the reference's bound."""
    port = _free_port()
    env = _env(HOROVOD_TPU_STEP_TIMEOUT_S="8")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "drill", str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    t0 = time.monotonic()
    try:
        out1, _ = procs[1].communicate(timeout=100)
        out0, _ = procs[0].communicate(timeout=100)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    elapsed = time.monotonic() - t0
    assert procs[1].returncode == 17, out1
    assert "CRASHING" in out1, out1
    assert "SURVIVOR_CONTINUES" in out0, out0
    assert "SURVIVOR_FINISHED" not in out0, out0
    assert procs[0].returncode in (83, 3), (procs[0].returncode, out0)
    if procs[0].returncode == 83:
        assert "step watchdog" in out0, out0
    else:
        assert "SURVIVOR_ERROR" in out0, out0
    assert elapsed < 110, elapsed
