"""The port's async checkpoint stream against the JAX package's, on the
CPU.

A scripted series of snapshots -- with the writer held at chosen epochs,
so that coalescing is deterministic -- gives the same snapshot() returns,
commit kinds, chain links and ``ckpt.*`` counter deltas in both packages.
The ``crash_in_save`` and ``corrupt_ckpt`` drills fall back to the
previous committed chain.  A snapshot is a copy taken before
``snapshot()`` returns: a parameter updated in place right after it (an
``optimizer.step()``) does not reach the committed epoch.
"""

import os
import threading

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as ref_checkpoint
from horovod_tpu import ckpt_stream as ref_stream
from horovod_tpu import metrics as ref_metrics
from horovod_tpu_torch import checkpoint, ckpt_stream, elastic
from horovod_tpu_torch import metrics as port_metrics
from horovod_tpu_torch.ops.eager import HorovodRetryableError

COUNTERS = ("ckpt.snapshots", "ckpt.coalesced", "ckpt.commits#kind=base",
            "ckpt.commits#kind=delta")


def _np_state(step, n=16):
    return {"w": np.full(n, float(step), np.float32),
            "b": np.arange(3, dtype=np.float64),
            "step": np.asarray(step, np.int64)}


def _torch_state(step, n=16):
    return {k: torch.from_numpy(np.array(v))
            for k, v in _np_state(step, n).items()}


@pytest.fixture()
def size1(monkeypatch):
    import horovod_tpu_torch as hvd
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "ELASTIC", "STANDBY", "FAULT", "CKPT_EVERY_STEPS",
                 "CKPT_ASYNC", "CKPT_FULL_EVERY"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _script(stream_mod, ckpt_mod, registry, make_state, d, monkeypatch):
    """The scripted series on one package: returns snapshot()'s returns,
    each committed epoch's (kind, prev), the tip's links and the counter
    deltas."""
    holds = {4: threading.Event()}
    entered = threading.Event()
    orig = ckpt_mod.save_chain

    def gated(directory, flat, epoch, **kw):
        if epoch in holds:
            entered.set()
            holds[epoch].wait(timeout=30)
        return orig(directory, flat, epoch, **kw)

    monkeypatch.setattr(ckpt_mod, "save_chain", gated)
    before = registry.snapshot()["counters"]
    returns = []
    ac = stream_mod.AsyncCheckpointer(d, snapshot_every_steps=1,
                                      full_every=2)
    try:
        for e in (1, 2, 3):
            returns.append(ac.snapshot(make_state(e), e))
            ac.flush()
        returns.append(ac.snapshot(make_state(4), 4))   # the writer holds 4
        assert entered.wait(timeout=30)
        for e in (5, 6):                                # 6 replaces 5
            returns.append(ac.snapshot(make_state(e), e))
        holds[4].set()
        ac.flush()
        for e in (7, 8, 9):
            returns.append(ac.maybe_snapshot(make_state(e), e))
            ac.flush()
    finally:
        for ev in holds.values():
            ev.set()
        ac.close()
    after = registry.snapshot()["counters"]
    manifests = {e: ckpt_mod._chain_manifest(d, e) for e in range(1, 10)}
    kinds = {e: (m["kind"], m["prev"]) for e, m in manifests.items() if m}
    deltas = {c: after.get(c, 0) - before.get(c, 0) for c in COUNTERS}
    return returns, kinds, ckpt_mod.chain_links(d, 9), deltas


def test_scripted_stream_matches_the_reference(tmp_path, monkeypatch):
    want = _script(ref_stream, ref_checkpoint, ref_metrics.registry,
                   _np_state, str(tmp_path / "ref"), monkeypatch)
    got = _script(ckpt_stream, checkpoint, port_metrics.registry,
                  _torch_state, str(tmp_path / "port"), monkeypatch)
    assert got == want
    returns, kinds, _, deltas = got
    assert returns == [True, True, True, True, True, False, True, True,
                       True]
    assert 5 not in kinds and deltas["ckpt.coalesced"] == 1


def test_knob_defaults_match_the_reference(monkeypatch):
    for env in ({}, {"HOROVOD_TPU_CKPT_ASYNC": "1",
                     "HOROVOD_TPU_CKPT_EVERY_STEPS": "5",
                     "HOROVOD_TPU_CKPT_FULL_EVERY": "4"},
                {"HOROVOD_TPU_CKPT_EVERY_STEPS": "x",
                 "HOROVOD_TPU_CKPT_FULL_EVERY": "0"}):
        for var in ("HOROVOD_TPU_CKPT_ASYNC", "HOROVOD_TPU_CKPT_EVERY_STEPS",
                    "HOROVOD_TPU_CKPT_FULL_EVERY"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = (ckpt_stream.async_enabled(),
               ckpt_stream.snapshot_every_steps_default(),
               ckpt_stream.full_every_default())
        assert got == (ref_stream.async_enabled(),
                       ref_stream.snapshot_every_steps_default(),
                       ref_stream.full_every_default()), env


def test_crash_in_save_falls_back_to_the_previous_chain(
        tmp_path, monkeypatch, size1):
    d = str(tmp_path)

    class Died(Exception):
        pass

    def fake_die(code, msg):
        raise Died(f"exit {code}: {msg}")
    monkeypatch.setattr(ckpt_stream, "_die", fake_die)
    monkeypatch.setenv("HOROVOD_TPU_FAULT", "crash_in_save:rank=0:epoch=4")
    monkeypatch.setenv("HOROVOD_TPU_RANK", "0")
    ac = ckpt_stream.AsyncCheckpointer(d, snapshot_every_steps=1)
    try:
        ac.snapshot(_torch_state(2), 2)
        ac.flush()                       # epoch 2 commits (< fault)
        ac.snapshot(_torch_state(4), 4)  # the fault fires mid-commit
        with pytest.raises(HorovodRetryableError, match="epoch 4"):
            ac.flush()
    finally:
        ac.close(flush=False)
    assert any(e.startswith(".tmp-checkpoint-4") for e in os.listdir(d))
    assert checkpoint.latest_epoch(d) == 2
    state, epoch = checkpoint.restore_and_broadcast(d, _torch_state(0))
    assert epoch == 2 and torch.equal(state["w"], _torch_state(2)["w"])


def test_corrupt_ckpt_falls_back_to_the_previous_chain(
        tmp_path, monkeypatch, size1, capfd):
    d = str(tmp_path)
    monkeypatch.setenv("HOROVOD_TPU_FAULT", "corrupt_ckpt:rank=0:epoch=4")
    monkeypatch.setenv("HOROVOD_TPU_RANK", "0")
    before = port_metrics.registry.snapshot()["counters"].get(
        "ckpt.corrupt_links", 0)
    ac = ckpt_stream.AsyncCheckpointer(d, snapshot_every_steps=1)
    try:
        for e in (2, 4):
            ac.snapshot(_torch_state(e), e)
            ac.flush()
    finally:
        ac.close()
    assert checkpoint._chain_manifest(d, 4)["kind"] == "delta"
    assert checkpoint.latest_epoch(d) == 2
    state, epoch = checkpoint.restore_and_broadcast(d, _torch_state(0),
                                                    epoch=4)
    assert epoch == 2 and torch.equal(state["w"], _torch_state(2)["w"])
    assert "torn or missing" in capfd.readouterr().err
    after = port_metrics.registry.snapshot()["counters"]["ckpt.corrupt_links"]
    assert after > before


def test_snapshot_survives_an_in_place_step(tmp_path, monkeypatch, size1):
    """The state is snapshotted, then ``optimizer.step()`` updates the
    parameters and the momentum in place while the writer is still held:
    the committed epoch holds the values of snapshot time, bit for bit."""
    model = torch.nn.Linear(8, 4)
    opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)

    def state():
        return {"params": dict(model.named_parameters()),
                "opt_state": opt.state_dict()}

    def step():
        opt.zero_grad()
        model(torch.ones(2, 8)).square().sum().backward()
        opt.step()

    step()
    want = {k: v.copy() for k, v in checkpoint.flatten_state(state()).items()}
    gate = threading.Event()
    orig = checkpoint.save_chain

    def held(*args, **kwargs):
        gate.wait(timeout=30)
        return orig(*args, **kwargs)

    d = str(tmp_path)
    monkeypatch.setattr(checkpoint, "save_chain", held)
    ac = ckpt_stream.AsyncCheckpointer(d, snapshot_every_steps=1)
    try:
        ac.snapshot(state(), 1)
        step()                            # in place, while the writer waits
        gate.set()
        ac.flush()
    finally:
        gate.set()
        ac.close()
    got = checkpoint.read_chain_state(d, 1)
    assert got.keys() == want.keys()
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert not np.array_equal(got["['params']['weight']"],
                              model.weight.detach().numpy())


def test_run_elastic_stream_lifecycle(tmp_path, size1):
    """run_elastic(snapshot_every_steps=N) arms the stream on the root
    rank, elastic.snapshot() feeds it at the cadence, and a clean exit
    flushes the final snapshot committed."""
    d = str(tmp_path)
    seen = {}

    def train(state, epoch):
        seen["stream"] = elastic.active_stream()
        assert seen["stream"] is not None
        for step in range(1, 7):
            elastic.snapshot(_torch_state(step), step)
        return "done"

    out = elastic.run_elastic(train, directory=d, like=_torch_state(0),
                              snapshot_every_steps=2)
    assert out == "done" and elastic.active_stream() is None
    assert checkpoint.latest_epoch(d) == 6 and checkpoint.is_chain(d, 6)
    state, epoch = checkpoint.restore_and_broadcast(d, _torch_state(0))
    assert epoch == 6 and int(state["step"]) == 6
