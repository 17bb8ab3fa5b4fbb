"""The fleet policy's reconfigure actuators and the hierarchical control
topology on the port's eager plane, as the JAX package's drills hold
them (``tests/test_policy_drills.py``, ``tests/test_aggregate.py:405-513``).

Every drill is a multi-process job of ``tests/_torch_fleet_worker.py`` on
the CPU: a gloo world group and the native TCP control plane and ring.
The jobs this file starts itself get the launcher's rendezvous store from
a ``TCPStore`` the test hosts (an elastic world group is made per
generation on it), so that a fault can reach one process only:

* straggler eviction: ``HOROVOD_TPU_FAULT=slow:...`` in process 1 alone;
  the coordinator demotes it, admits the parked standby in the same
  reconfigure, and every member resumes at generation 1 with the
  committed tip; the victim, and only the victim, exits 3 with the native
  eviction text.  With four processes and a milder straggler (process 2)
  the survivors are re-ranked fastest first: the old process indices
  gathered over the new world follow ``policy.FleetPolicy.rerank_order``
  on the coordinator's EWMAs, and every process's rank is its rank in the
  rebuilt gloo group;
* scripted autoscale through the launcher: ``--autoscale-script
  "tick:60=2,tick:200=4"`` shrinks the world to 2 (the parked pair are
  relaunched as standbys) and grows it back to 4;
* ``HOROVOD_TPU_CONTROL_TOPO=hier`` on four processes of two faked hosts:
  results bit-identical to ``flat``, a member's and a leader's death
  under elastic membership, and a topology mismatch refused at bootstrap.
  The drill runs the reference's schedule, one-rank sets ``solo<r>`` and
  their set-scoped allreduces included, and holds every process to a
  response-cache hit under both topologies, as the reference's does.

Each drill has its own time limit, well under 90 s.
"""

import contextlib
import datetime
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

from horovod_tpu_torch import cpp_core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_fleet_worker.py")
HOSTS = ["hostA", "hostA", "hostB", "hostB"]
EVICTED = ("evicted from the membership at generation 1 after: straggler "
           "rank 1 demoted to standby by fleet policy")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_TPU_", "MASTER_", "TORCHELASTIC_"))}
    env.update(PYTHONPATH=ROOT, HOROVOD_TPU_CYCLE_TIME_MS="2",
               HOROVOD_TPU_CONTROL_TIMEOUT_S="30")
    env.update(extra)
    return env


@contextlib.contextmanager
def _store():
    """The rendezvous store the launcher would host, on 127.0.0.1; yields
    its port."""
    import torch.distributed as dist
    port = _free_port()
    store = dist.TCPStore("127.0.0.1", port, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=120))
    try:
        yield port
    finally:
        del store


def _start(nprocs, common, per_proc=None, num_standby=0, store_port=None):
    """``nprocs`` workers and ``num_standby`` parked standbys, each with
    ``common`` plus its own overlay (the reference's
    ``start_policy_procs``)."""
    assert cpp_core.available()     # built once, before the workers load it
    coord = _free_port()
    master = store_port or _free_port()
    procs = []
    for i in range(nprocs + num_standby):
        env = _base_env(**common)
        env.update({
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{coord}",
            "HOROVOD_TPU_PROCESS_INDEX": str(i),
            "HOROVOD_TPU_PROCESS_COUNT": str(nprocs),
            "HOROVOD_TPU_SIZE": str(nprocs),
            "HOROVOD_TPU_RANK": str(i),
            "HOROVOD_TPU_LOCAL_RANK": str(i),
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(master),
        })
        if store_port is not None:
            env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
        env.update((per_proc or {}).get(i, {}))
        if i >= nprocs:
            env.update(HOROVOD_TPU_STANDBY="1",
                       HOROVOD_TPU_STANDBY_WAIT_S="60")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=80):
    """[(exit code, output)] of every process; all of them are killed
    and their outputs shown when one outlives ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, text))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        texts = [p.communicate()[0] for p in procs]
        raise AssertionError(f"no end within {timeout} s:\n"
                             + "\n".join(texts)) from None
    return out


def _lines(out):
    """The worker's report lines: each is one write, but the launcher's
    children share its stdout, where another process's unterminated text
    can precede one."""
    return re.sub(r"(REENTRY|RESUMED|DONE|POLICY|ABORTED) ", r"\n\1 ",
                  out).splitlines()


def _line(out, prefix):
    return next(line for line in _lines(out) if line.startswith(prefix))


def _fields(line):
    return dict(kv.split("=", 1) for kv in line.split()[1:])


# ---------------------------------------------------------------- fleet

# (processes, per-process faults).  The stragglers are slow from the
# first tick, so that no other process's EWMA can lead theirs; the
# eviction waits for the standby, which parks once rank 0 has committed
# epoch 0.  With four processes process 2 is slower than process 3, but
# under the threshold: the re-rank puts 3 before it.
EVICTIONS = {
    "evict3": (3, {1: "slow:rank=1:ms=50"}),
    "rerank4": (4, {1: "slow:rank=1:ms=50", 2: "slow:rank=2:ms=15"}),
}


@pytest.mark.parametrize("case", sorted(EVICTIONS))
def test_straggler_evicted_and_survivors_reranked(case, tmp_path,
                                                  monkeypatch):
    nprocs, faults = EVICTIONS[case]
    with _store() as port:
        procs = _start(
            nprocs,
            dict(TEST_MODE="policy", TEST_CKPT_DIR=str(tmp_path),
                 TEST_EXPECT_SIZE=str(nprocs), TEST_WAIT_S="45",
                 TEST_STANDBY_AFTER_COMMIT="1", HOROVOD_TPU_ELASTIC="1",
                 HOROVOD_TPU_EVICT_THRESHOLD="0.02",
                 HOROVOD_TPU_EVICT_TICKS="5", HOROVOD_TPU_EVICT_MAX="1",
                 # Floor at the full world: the eviction waits for the
                 # spare to park, a seat swap.
                 HOROVOD_TPU_ELASTIC_MIN_RANKS=str(nprocs)),
            {i: {"HOROVOD_TPU_FAULT": f} for i, f in faults.items()},
            num_standby=1, store_port=port)
        results = _finish(procs)
    everything = "\n".join(out for _, out in results)

    rc1, out1 = results[1]
    assert "htpu fault injection: slowing rank 1 by 50ms" in out1, out1
    assert rc1 == 3, out1
    assert EVICTED in _line(out1, "ABORTED rank=1 old_pidx=1"), out1
    assert everything.count("ABORTED") == 1, everything

    rc0, out0 = results[0]
    assert rc0 == 0, out0
    assert "straggler rank 1 demoted to standby by fleet policy" in out0
    assert (f"reconfigured to {nprocs} process(es) at generation 1"
            in out0), out0
    policy_line = json.loads(_line(out0, "POLICY ")[len("POLICY "):])
    assert policy_line["counters"].get("policy.evictions") == 1
    evicts = [r for r in policy_line["records"]
              if r["kind"] == "policy.evict"]
    assert len(evicts) == 1 and evicts[0]["a"] == 1, policy_line
    assert "standby admitted at generation 1" in results[-1][1]

    # The order of the new world: the coordinator, the survivors as the
    # fleet policy's Python twin re-ranks them on the coordinator's EWMAs
    # (the last read before the reconfigure), then the standby.
    from horovod_tpu_torch import policy
    monkeypatch.setenv("HOROVOD_TPU_EVICT_THRESHOLD", "0.02")
    twin = policy.FleetPolicy()
    ewmas = {int(r): v for r, v in policy_line["ewmas"].items()}
    twin.observe_tick(0, [ewmas.get(p, -1.0) for p in range(nprocs)])
    survivors = [p for p in range(2, nprocs)]
    order = [0] + twin.rerank_order(survivors) + [nprocs]
    reranks = [r["detail"] for r in policy_line["records"]
               if r["kind"] == "policy.rerank"]
    assert reranks == ([] if order[1:-1] == survivors
                       else [",".join(map(str, order[1:-1]))]), policy_line

    members = [0] + list(range(2, nprocs + 1))
    seen = {}
    for i in members:
        rc, out = results[i]
        assert rc == 0, f"process {i}:\n{out}"
        re_ = _fields(_line(out, "REENTRY "))
        assert re_["gen"] == "1" and re_["size"] == str(nprocs), out
        assert re_["state_ok"] == "True" and re_["agree"] == "True", out
        assert re_["group_rank"] == re_["rank"], out
        assert json.loads(re_["order"]) == order, (out, ewmas)
        seen[int(re_["old_pidx"])] = int(re_["rank"])
        resumed = _fields(_line(out, "RESUMED "))
        assert resumed["gen"] == "1" and resumed["state_ok"] == "True"
        assert _line(out, "DONE ")
    assert [old for old, _ in sorted(seen.items(), key=lambda kv: kv[1])] \
        == order
    digests = {_fields(_line(results[i][1], "DONE "))["digest"]
               for i in members}
    assert len(digests) == 1, everything


def test_scripted_autoscale_shrinks_and_grows_back(tmp_path):
    env = _base_env(TEST_MODE="policy", TEST_CKPT_DIR=str(tmp_path),
                    TEST_EXPECT_SIZE="4", TEST_WAIT_S="45",
                    HOROVOD_TPU_STANDBY_WAIT_S="60")
    assert cpp_core.available()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4",
         "--elastic", "--autoscale-script", "tick:60=2,tick:200=4", "--",
         sys.executable, WORKER], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=85)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"no end within 85 s:\n{out}") from None
    assert proc.returncode == 0, out
    assert "autoscale: shrink to 2 process(es)" in out, out
    assert "reconfigured to 2 process(es) at generation 1" in out, out
    assert out.count("after: autoscale: shrink to 2 process(es)") == 2, out
    assert out.count("relaunched as standby") == 2, out
    assert "autoscale: grow to 4 process(es)" in out, out
    assert "reconfigured to 4 process(es)" in out, out
    lines = _lines(out)
    shrunk = [_fields(line) for line in lines
              if line.startswith("REENTRY ") and "gen=1 " in line]
    assert sorted(f["old_pidx"] for f in shrunk) == ["0", "1"], out
    resumed = [_fields(line) for line in lines
               if line.startswith("RESUMED ")]
    assert len(resumed) == 4 and all(
        f["size"] == "4" and f["state_ok"] == "True" for f in resumed), out
    rescales = [int(m) for line in lines
                if line.startswith("RESUMED rank=0")
                for m in re.findall(r"rescales=(\d+)", line)]
    assert rescales and max(rescales) >= 2, out
    assert "state_ok=False" not in out and "agree=False" not in out, out
    done = {_fields(line)["digest"] for line in lines
            if line.startswith("DONE ")}
    assert len(done) == 1, out


# ------------------------------------------------------ control topology

def _topo(topo):
    sets = ";".join(f"solo{r}:{r}" for r in range(len(HOSTS)))
    # A 20 ms tick: each replay's requests, enqueued as the previous
    # ring returns on every process, land in one tick (at 2 ms, the
    # reference drill's, both packages' hits vary with scheduling, from 0
    # to 7 of 7 under load).
    procs = _start(4, dict(TEST_MODE="topo", HOROVOD_TPU_CONTROL_TOPO=topo,
                           HOROVOD_TPU_PROCESS_SETS=sets,
                           HOROVOD_TPU_CYCLE_TIME_MS="20"),
                   {i: {"HOROVOD_TPU_HOST_FINGERPRINT": fp}
                    for i, fp in enumerate(HOSTS)})
    parsed = []
    for i, (rc, out) in enumerate(_finish(procs, timeout=60)):
        assert rc == 0, f"process {i} ({topo}):\n{out}"
        parsed.append((_line(out, "DIGEST ").split()[1],
                       json.loads(_line(out, "SNAP ")[len("SNAP "):])))
    return parsed


def test_hier_results_equal_flat_on_two_fake_hosts():
    flat, hier = _topo("flat"), _topo("hier")
    for i in range(len(HOSTS)):
        assert flat[i][0] == hier[i][0], f"rank {i} diverged"
    root_flat, root_hier = flat[0][1], hier[0][1]
    assert root_hier["gauges"].get("control.agg_depth") == 2.0
    assert root_flat["gauges"].get("control.agg_depth") == 1.0
    assert root_hier["counters"].get("control.merged_frames", 0) > 0
    assert root_flat["counters"].get("control.merged_frames", 0) == 0
    assert hier[2][1]["counters"].get("control.merged_frames", 0) > 0
    assert root_flat["counters"].get("control.root_gather_bytes", 0) > 0
    assert root_hier["counters"].get("control.root_gather_bytes", 0) > 0
    # Members ticked their sub-coordinator, not the root, yet the
    # response cache still served replay ticks everywhere (the
    # reference's tests/test_aggregate.py:430-432).
    for _, snap in flat + hier:
        assert snap["counters"].get("control.cache_hits", 0) > 0


@pytest.mark.parametrize("die,who", [(3, "member"), (2, "leader")])
def test_hier_death_reconfigures_elastic(die, who, tmp_path):
    """Process 3 is host B's member, process 2 its sub-coordinator: a
    member's death reaches the root as a dead entry of B's container; a
    leader's silences B for a tick, the root evicts the leader and the
    rebuild re-elects process 3 as B's leader."""
    with _store() as port:
        procs = _start(
            4, dict(TEST_MODE="elastic_topo", TEST_CKPT_DIR=str(tmp_path),
                    TEST_DIE_RANK=str(die), TEST_EXPECT_SIZE="3",
                    HOROVOD_TPU_ELASTIC="1",
                    HOROVOD_TPU_CONTROL_TOPO="hier"),
            {i: {"HOROVOD_TPU_HOST_FINGERPRINT": fp}
             for i, fp in enumerate(HOSTS)}, store_port=port)
        results = _finish(procs)
    assert results[die][0] == -signal.SIGKILL, results[die][1]
    for i in range(4):
        if i == die:
            continue
        rc, out = results[i]
        assert rc == 0, f"process {i} ({who}'s death):\n{out}"
        assert "ABORTED" not in out, out
        resumed = _fields(_line(out, "RESUMED "))
        assert resumed["size"] == "3" and resumed["gen"] == "1", out
        assert resumed["state_ok"] == "True", out


def test_topo_mismatch_rejected_at_bootstrap():
    procs = _start(2, dict(TEST_MODE="topo"),
                   {0: {"HOROVOD_TPU_CONTROL_TOPO": "flat",
                        "HOROVOD_TPU_HOST_FINGERPRINT": "hostA"},
                    1: {"HOROVOD_TPU_CONTROL_TOPO": "hier",
                        "HOROVOD_TPU_HOST_FINGERPRINT": "hostA"}})
    results = _finish(procs, timeout=60)
    joined = "\n".join(out for _, out in results)
    assert any(rc != 0 for rc, _ in results), joined
    assert "HOROVOD_TPU_CONTROL_TOPO mismatch" in joined, joined


def test_a_collective_from_an_older_generation_retries(monkeypatch):
    """A planned reconfigure can land while a rank is between two of its
    collectives, none in flight: the next one it submits, from the
    generation ``run_elastic`` entered ``train`` in, completes RETRYABLE
    instead of waiting for members that restore (the drills above hit
    this window)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import Status
    from horovod_tpu_torch.ops.eager import HorovodRetryableError
    for knob in ("SIZE", "RANK", "COORD_ADDR", "ELASTIC", "STANDBY"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        ctl = hvd.controller()
        assert torch.equal(hvd.allreduce(torch.ones(3), name="gen.a"),
                           torch.ones(3))
        ctl.expected_generation = 0
        assert torch.equal(hvd.allreduce(torch.ones(3), name="gen.b"),
                           torch.ones(3))
        ctl._reconfigure_status = Status.retryable(
            "Horovod membership reconfigured at generation 1: drill")
        ctl._adopted_generation = 1
        with pytest.raises(HorovodRetryableError, match="generation 1"):
            hvd.allreduce(torch.ones(3), name="gen.c")
        ctl.expected_generation = 1
        assert torch.equal(hvd.allreduce(torch.ones(3), name="gen.d"),
                           torch.ones(3))
    finally:
        hvd.shutdown()
