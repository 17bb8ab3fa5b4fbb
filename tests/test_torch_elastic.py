"""Elastic membership of the port against the JAX package's, on the CPU.

In one process: the knobs and the coordinator-succession helpers equal
the reference's, a RETRYABLE status raises ``HorovodRetryableError``, and
``run_elastic`` retries, gives up and propagates as
``tests/test_elastic.py:190-225`` require of the reference.  Through the
port's launcher (``python -m horovod_tpu_torch.run --elastic``) on gloo:
two processes, one killed with SIGKILL mid-training, the survivor resuming
at generation 1 as a job of one with its restored state bit-identical to
its own at that epoch; and the same loss with a standby parked once the
world has shrunk and admitted back (the ``rejoin`` fault action), both
ranks ending on the same bits at generation 2.  Each drill has its own
time limit.
"""

import os
import subprocess
import sys

import pytest
import torch

from horovod_tpu import elastic as ref_elastic
from horovod_tpu_torch import checkpoint, elastic
from horovod_tpu_torch.core import Status, StatusType
from horovod_tpu_torch.ops.eager import HorovodRetryableError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_elastic_worker.py")


def test_knobs_match_the_reference(monkeypatch):
    for env in ({}, {"HOROVOD_TPU_ELASTIC": "1",
                     "HOROVOD_TPU_ELASTIC_MIN_RANKS": "3",
                     "HOROVOD_TPU_STANDBY": "1"}):
        for var in ("HOROVOD_TPU_ELASTIC", "HOROVOD_TPU_ELASTIC_MIN_RANKS",
                    "HOROVOD_TPU_STANDBY"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = (elastic.enabled(), elastic.min_ranks(), elastic.is_standby())
        assert got == (ref_elastic.enabled(), ref_elastic.min_ranks(),
                       ref_elastic.is_standby())


def test_succession_helpers_match_the_reference():
    for count in (1, 2, 5):
        assert (elastic.successor_candidates(count)
                == ref_elastic.successor_candidates(count))
    for cands, failed in (([1, 2, 3], []), ([1, 2, 3], [1]),
                          ([1, 2], [1, 2]), ([], [])):
        assert (elastic.elect_successor(cands, failed)
                == ref_elastic.elect_successor(cands, failed))
    for args in ((3, 1, 2), (1, 1, 2), (2, 2, 4)):
        assert elastic.quorum_ok(*args) == ref_elastic.quorum_ok(*args)


def test_retryable_status_raises_the_typed_error(monkeypatch):
    import horovod_tpu_torch as hvd
    for knob in ("SIZE", "RANK", "COORD_ADDR", "ELASTIC", "STANDBY"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        hm = hvd.controller().handle_manager
        h = hm.allocate(name="el.typed")
        hm.mark_done(h, Status.retryable(
            "Horovod membership reconfigured at generation 1: rank 1 lost"))
        assert Status.retryable("x").type == StatusType.RETRYABLE
        with pytest.raises(HorovodRetryableError, match="generation 1"):
            hvd.synchronize(h)
        assert not issubclass(HorovodRetryableError,
                              hvd.HorovodAbortedError)
    finally:
        hvd.shutdown()


def test_eager_step_after_a_retryable_step(monkeypatch):
    """A step whose reduction completes RETRYABLE (a membership change
    under ``opt.step()``) leaves the optimizer ready for the next one:
    the next ``zero_grad``, backward and step run as usual."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import optimizer
    for knob in ("SIZE", "RANK", "COORD_ADDR", "ELASTIC", "STANDBY",
                 "OVERLAP"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.5), eager=True)

        def step():
            opt.zero_grad()
            model(torch.ones(3, 4)).square().sum().backward()
            opt.step()

        def reconfigured(t, **kw):
            hm = hvd.controller().handle_manager
            h = hm.allocate(name=kw.get("name", ""))
            hm.mark_done(h, Status.retryable(
                "Horovod membership reconfigured at generation 1"))
            return h

        with monkeypatch.context() as mp:
            mp.setattr(optimizer._eager, "allreduce_async", reconfigured)
            before = model.weight.detach().clone()
            with pytest.raises(HorovodRetryableError, match="generation 1"):
                step()
            assert torch.equal(model.weight, before)
        step()
        assert not torch.equal(model.weight, before)
    finally:
        hvd.shutdown()


def test_elastic_job_without_the_launchers_store_fails_loudly(monkeypatch):
    import horovod_tpu_torch as hvd
    for knob in ("COORD_ADDR", "STANDBY", "LOCAL_RANK"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_USE_AGENT_STORE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_ELASTIC", "1")
    monkeypatch.setenv("HOROVOD_TPU_SIZE", "2")
    monkeypatch.setenv("HOROVOD_TPU_RANK", "0")
    hvd.shutdown()
    with pytest.raises(RuntimeError, match="outlives every worker"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


class TestRunElastic:
    """``tests/test_elastic.py:190-225``, on the port."""

    def _patch_restore(self, monkeypatch, calls):
        def fake_restore(directory, like, root_rank=0, optional_keys=()):
            calls.append(directory)
            return {"w": len(calls)}, len(calls) - 2
        monkeypatch.setattr(checkpoint, "restore_and_broadcast",
                            fake_restore)

    def test_reenters_train_on_membership_change(self, monkeypatch):
        calls, entries = [], []

        def train(state, epoch):
            entries.append((state, epoch))
            if len(entries) < 3:
                raise HorovodRetryableError("membership reconfigured")
            return "finished"
        self._patch_restore(monkeypatch, calls)
        out = elastic.run_elastic(train, directory="/ckpt", like={"w": 0},
                                  snapshot_every_steps=0)
        assert out == "finished"
        assert len(calls) == 3
        assert entries[0] == ({"w": 1}, -1)
        assert entries[2] == ({"w": 3}, 1)

    def test_gives_up_after_max_reconfigures(self, monkeypatch):
        calls = []

        def train(state, epoch):
            raise HorovodRetryableError("flapping membership")
        self._patch_restore(monkeypatch, calls)
        with pytest.raises(HorovodRetryableError, match="flapping"):
            elastic.run_elastic(train, directory="/ckpt", like={},
                                max_reconfigures=2, snapshot_every_steps=0)
        assert len(calls) == 3

    def test_other_errors_propagate_unretried(self, monkeypatch):
        calls = []

        def train(state, epoch):
            raise RuntimeError("real bug")
        self._patch_restore(monkeypatch, calls)
        with pytest.raises(RuntimeError, match="real bug"):
            elastic.run_elastic(train, directory="/ckpt", like={},
                                snapshot_every_steps=0)
        assert len(calls) == 1


def _drill(tmp_path, launcher_args, **env):
    from horovod_tpu_torch import cpp_core
    assert cpp_core.available()      # built once, before the workers load it
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("HOROVOD_TPU_", "MASTER_", "TORCHELASTIC_"))}
    full.update(PYTHONPATH=ROOT, TEST_CKPT_DIR=str(tmp_path),
                HOROVOD_TPU_CYCLE_TIME_MS="2",
                HOROVOD_TPU_CONTROL_TIMEOUT_S="30", **env)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", *launcher_args,
         "--elastic", "--max-restarts", "0", "--snapshot-every-steps", "2",
         "--", sys.executable, WORKER], cwd=ROOT, env=full,
        capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout + proc.stderr


def test_kill_one_of_two_resumes_at_generation_1(tmp_path):
    rc, out = _drill(tmp_path, ["-np", "2"], TEST_DIE_RANK="1")
    assert rc == 0, out
    assert "ABORTED" not in out, out
    assert "rebuilt the gloo world group for generation 1 (size 1" in out
    assert "RESUMED rank=0 size=1 gen=1" in out, out
    assert "state_ok=True" in out and "state_ok=False" not in out, out
    assert "DONE rank=0 size=1 gen=1" in out, out


def test_standby_admitted_back_after_a_loss(tmp_path):
    rc, out = _drill(tmp_path, ["-np", "2", "--num-standby", "1"],
                     TEST_DIE_RANK="1", TEST_EXPECT_SIZE="2",
                     TEST_STANDBY_AFTER_LOSS="1",
                     HOROVOD_TPU_FAULT="rejoin:rank=0:tick=1")
    assert rc == 0, out
    assert "ABORTED" not in out, out
    assert "RESUMED rank=0 size=1 gen=1" in out, out
    assert "standby admitted at generation 2 as rank 1 of 2" in out, out
    assert "RESUMED rank=0 size=2 gen=2" in out, out
    assert "state_ok=False" not in out, out
    done = sorted(line.split("digest=")[1] for line in out.splitlines()
                  if line.startswith("DONE") and "gen=2" in line)
    assert len(done) == 2 and done[0] == done[1], out
