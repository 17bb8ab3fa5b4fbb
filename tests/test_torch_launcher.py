"""The port's launcher (``python -m horovod_tpu_torch.run``) against the
JAX package's (``python -m horovod_tpu.run``).

Usage errors carry the reference's texts.  Each child's environment is
the reference's for the same arguments plus the port's documented
additions: ``HOROVOD_TPU_LOCAL_RANK`` (the child's GPU) and the
rendezvous store the launcher hosts (``MASTER_ADDR``, ``MASTER_PORT``,
``TORCHELASTIC_USE_AGENT_STORE=True``).  A child that exits 1 makes the
launcher return 1 and reap the others within the grace period.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from horovod_tpu import run as ref_run
from horovod_tpu_torch import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "tests", "_torch_launcher_probe.py")
EXTRAS = ("HOROVOD_TPU_LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
          "TORCHELASTIC_USE_AGENT_STORE")


def _usage_error(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["-np", "1", "--num-standby", "1", "--", "true"],
    ["-np", "1", "--autoscale-script", "tick:1=2", "--", "true"],
    ["-np", "1"],
    ["-np", "1", "--"],
    ["--", "true"],
    ["-np", "x", "--", "true"],
], ids=["standby", "autoscale", "no-command", "empty-command", "no-np",
        "bad-np"])
def test_usage_errors_match_the_reference(argv, capsys):
    assert (_usage_error(run.main, argv, capsys)
            == _usage_error(ref_run.main, argv, capsys))


@pytest.mark.parametrize("script", [
    "tick:x=2", "bogus", "tick:5", "tick:0=2", "tick:5=2,tick:9=-1"],
    ids=["not-integer", "no-tick", "no-target", "zero-tick",
         "negative-target"])
def test_autoscale_script_usage_errors_match_the_reference(script, capsys):
    argv = ["-np", "2", "--elastic", "--autoscale-script", script, "--",
            "true"]
    msg = _usage_error(run.main, argv, capsys)
    assert msg == _usage_error(ref_run.main, argv, capsys)
    assert msg.startswith("--autoscale-script: autoscale entry ")


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_TPU_", "MASTER_", "TORCHELASTIC_"))}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", **extra)
    return env


def _children(module, args, env):
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, "--", sys.executable, PROBE,
         "env"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=90)
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(line[4:]) for line in proc.stdout.splitlines()
           if line.startswith("ENV ")]
    return {int(e["HOROVOD_TPU_PROCESS_INDEX"]): e for e in got}


@pytest.mark.parametrize("args,timeline", [
    (["-np", "2", "--metrics-every", "0.5", "--metrics-port", "9911",
      "--snapshot-every-steps", "4"], True),
    (["-np", "1", "--elastic", "--num-standby", "1", "--elastic-min-ranks",
      "1", "--ckpt-async"], False),
    (["-np", "1", "--elastic", "--num-standby", "1", "--autoscale-script",
      "tick:60=2,tick:200=4"], False),
], ids=["plain", "elastic", "autoscale"])
def test_child_env_is_the_reference_plus_the_store(args, timeline,
                                                   tmp_path):
    env = _clean_env()
    if timeline:
        env["HOROVOD_TPU_TIMELINE"] = str(tmp_path / "t.json")
    want = _children("horovod_tpu.run", args, env)
    got = _children("horovod_tpu_torch.run", args, env)
    assert sorted(got) == sorted(want) and len(got) == 2
    ports = set()
    for pidx, child in got.items():
        extras = {k: child.pop(k) for k in EXTRAS}
        assert extras["HOROVOD_TPU_LOCAL_RANK"] == str(pidx)
        assert extras["MASTER_ADDR"] == "127.0.0.1"
        assert extras["TORCHELASTIC_USE_AGENT_STORE"] == "True"
        ports.add(extras["MASTER_PORT"])
        ref_child = dict(want[pidx])
        # The coordinator's port is a free one, drawn per launch.
        for e in (child, ref_child):
            e["HOROVOD_TPU_COORD_ADDR"] = e["HOROVOD_TPU_COORD_ADDR"].rsplit(
                ":", 1)[0]
        assert child == ref_child, pidx
    assert len(ports) == 1


def test_failed_child_fails_the_job_and_the_rest_are_reaped():
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "3",
         "--kill-on-failure-grace", "1", "--", sys.executable, PROBE,
         "fail"], cwd=ROOT, env=_clean_env(), capture_output=True,
        text=True, timeout=60)
    elapsed = time.monotonic() - t0
    assert proc.returncode == 1, proc.stderr
    assert "exited with code 1" in proc.stderr
    assert "terminating surviving processes" in proc.stderr
    assert elapsed < 20, elapsed


def test_cards_go_to_the_lowest_free_index():
    """A relaunched standby takes the card of the process it replaces."""

    class Proc:
        def __init__(self):
            self.rc = None

        def poll(self):
            return self.rc

    cards = run._Cards()
    procs = []
    for want in (0, 1, 2, 3):
        assert cards.free() == want
        procs.append(Proc())
        cards.hold(procs[-1], want)
    procs[2].rc = -9
    assert cards.free() == 2
    cards.hold(Proc(), 2)
    assert cards.free() == 4
