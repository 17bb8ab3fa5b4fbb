"""One worker of the port's fleet-policy and control-topology drills
(torch only, so it starts fast).

Started by ``tests/test_torch_fleet.py`` (``TEST_MODE``):

* ``policy``: the elastic job the fleet policy acts on.  Each rank trains
  a small linear model on the CPU through ``elastic.run_elastic`` and
  ``DistributedOptimizer(SGD momentum, eager=True)``, snapshotting every
  step into the async stream (rank 0 commits epoch 0 before the first
  step; with ``TEST_STANDBY_AFTER_COMMIT`` a standby parks only after
  that).  Generation 0, and every generation whose size is not
  ``TEST_EXPECT_SIZE``, trains until the membership changes (at most
  ``TEST_WAIT_S``); the first generation of the expected size trains
  ``TEST_STEPS`` steps and ends.  At each re-entry after generation 0
  every process prints::

      REENTRY old_pidx=<i> rank=<r> size=<n> gen=<g> epoch=<e>
              state_ok=<bool> group_rank=<r> agree=<bool> order=<json>

  ``state_ok``: the restored state equals the committed tip (or the
  initial state when nothing was committed); ``order``: the old process
  indices gathered over the new world, in rank order; ``agree``: rank,
  the rank map, the executor's topology and ``basics``' snapshot agree,
  and the local rank did not move.  Rank 0 adds ``POLICY <json>``: the
  coordinator's ``policy.*`` counters, the fleet policy's EWMA gauges
  last read in the generation before, and the ``policy.*`` records of
  the flight recorder.  An evicted or parked process prints ``ABORTED``
  and exits 3, as the reference's drills expect.
* ``topo``: fixed-seed ``allreduce``/``allgather``/``broadcast`` on CPU
  tensors (the native TCP ring), cache-served replays included; prints
  ``DIGEST <sha256>`` and ``SNAP <json>`` (counters and gauges).
* ``elastic_topo``: the reference's hierarchical elastic loop: rank
  ``TEST_DIE_RANK`` SIGKILLs itself in generation 0; a survivor prints
  ``RESUMED rank=<r> size=<n> gen=<g>`` in the generation of
  ``TEST_EXPECT_SIZE``.
"""

import hashlib
import json
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, cpp_core, elastic, topology

DIM = 16


def _say(line: str) -> None:
    """One line in one write: under the launcher every process shares its
    stdout."""
    sys.stdout.flush()
    os.write(1, (line + "\n").encode())


def _batch(step: int, rank: int):
    gen = torch.Generator().manual_seed(1000 * step + rank)
    x = torch.randn(8, DIM, generator=gen)
    return x, x @ torch.linspace(-1, 1, DIM)


def _digest(flat: dict) -> str:
    h = hashlib.sha256()
    for key, value in sorted(flat.items()):
        h.update(key.encode())
        h.update(value.tobytes())
    return h.hexdigest()


def _agree(local_rank: int) -> bool:
    """Every view of this process's identity names the same seat."""
    from horovod_tpu_torch import basics
    ctl = hvd.controller()
    r, n = hvd.rank(), hvd.size()
    group = dist.get_rank() if dist.is_initialized() else 0
    return (group == r and ctl.topology.rank == r
            and ctl._executor.topology.rank == r
            and basics._state.topology.rank == r
            and ctl._rank_to_process == {i: i for i in range(n)}
            and hvd.local_rank() == local_rank)


def _policy_counters() -> dict:
    c = cpp_core.metrics_snapshot().get("counters", {})
    return {k: v for k, v in c.items() if k.startswith("policy.")}


def _ewma_gauges() -> dict:
    g = cpp_core.metrics_snapshot().get("gauges", {})
    return {k.split("#rank=")[1]: v for k, v in g.items()
            if k.startswith("policy.ewma_wait_s#rank=")}


def _policy_records() -> list:
    events = json.loads(cpp_core.flight_snapshot("drill"))["events"]
    return [e for e in events if e["kind"].startswith("policy.")]


def policy() -> None:
    directory = os.environ["TEST_CKPT_DIR"]
    expect = int(os.environ["TEST_EXPECT_SIZE"])
    steps = int(os.environ.get("TEST_STEPS", "4"))
    wait_s = float(os.environ.get("TEST_WAIT_S", "60"))
    # The launch's process index (a standby's is above the workers').
    old_pidx = topology.resolve().process_index
    committed = os.path.join(directory, "committed")
    if elastic.is_standby() and os.environ.get("TEST_STANDBY_AFTER_COMMIT"):
        # Park once epoch 0 is on disk: an eviction that waits for a seat
        # then comes after the commit.
        deadline = time.monotonic() + wait_s
        while not os.path.exists(committed):
            if time.monotonic() > deadline:
                sys.exit(f"{committed} never appeared")
            time.sleep(0.05)
    torch.manual_seed(0)
    model = torch.nn.Linear(DIM, 1)
    # torch's first optimizer imports for seconds: before the control
    # plane ticks, so that the fault's onset tick falls in training.
    inner = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    elastic.init(device="cpu")
    # The policy's records must outlive the ticks between a decision and
    # the re-entry that reads them.
    cpp_core.flight_set_capacity(1 << 18)
    local_rank = hvd.local_rank()
    opt = hvd.DistributedOptimizer(inner, eager=True)
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    initial = _digest(checkpoint.flatten_state(
        checkpoint.model_state(model, opt)))
    last_ewmas = {}

    def step_once(step: int) -> None:
        x, y = _batch(step, hvd.rank())
        opt.zero_grad()
        (model(x).squeeze(-1) - y).square().mean().backward()
        opt.step()
        elastic.snapshot(checkpoint.model_state(model, opt), step + 1)

    def train(state, epoch):
        gen = elastic.generation()
        size = hvd.size()
        checkpoint.load_model_state(model, opt, state)
        if gen > 0:
            got = _digest(checkpoint.flatten_state(
                checkpoint.model_state(model, opt)))
            want = (_digest(checkpoint.read_chain_state(directory, epoch))
                    if epoch >= 0 else initial)
            order = hvd.allgather(torch.tensor([old_pidx]),
                                  name=f"fleet.order.{gen}").tolist()
            _say(f"REENTRY old_pidx={old_pidx} rank={hvd.rank()} "
                 f"size={size} gen={gen} epoch={epoch} "
                 f"state_ok={got == want} group_rank={dist.get_rank()} "
                 f"agree={_agree(local_rank)} "
                 f"order={json.dumps(order, separators=(',', ':'))}")
            if hvd.rank() == 0:
                _say("POLICY " + json.dumps(
                    {"counters": _policy_counters(), "ewmas": last_ewmas,
                     "records": _policy_records()}))
        elif epoch < 0 and hvd.rank() == 0:
            stream = elastic.active_stream()
            stream.snapshot(checkpoint.model_state(model, opt), 0)
            stream.flush()
            open(committed, "w").close()
        step = max(epoch, 0)
        if gen == 0 or size != expect:
            deadline = time.monotonic() + wait_s
            while time.monotonic() < deadline:
                if elastic.generation() != gen:
                    raise hvd.HorovodRetryableError(
                        "membership changed between steps")
                step_once(step)
                step += 1
                if hvd.rank() == 0:
                    last_ewmas.clear()
                    last_ewmas.update(_ewma_gauges())
            _say(f"NO_RECONFIG rank={hvd.rank()} size={size}")
            sys.exit(5)
        counters = _policy_counters()
        _say(f"RESUMED rank={hvd.rank()} size={size} gen={gen} "
             f"epoch={epoch} state_ok={got == want} "
             f"evictions={counters.get('policy.evictions', 0)} "
             f"rescales={counters.get('policy.rescales', 0)}")
        for s in range(step, step + steps):
            if elastic.generation() != gen:
                raise hvd.HorovodRetryableError(
                    "membership changed between steps")
            step_once(s)

    try:
        elastic.run_elastic(train, directory=directory,
                            like=checkpoint.model_state(model, opt),
                            snapshot_every_steps=1)
    except hvd.HorovodAbortedError as exc:
        _say(f"ABORTED rank={hvd.rank()} old_pidx={old_pidx} msg={exc}")
        sys.exit(3)
    final = checkpoint.flatten_state(checkpoint.model_state(model, opt))
    _say(f"DONE rank={hvd.rank()} size={hvd.size()} "
         f"gen={elastic.generation()} digest={_digest(final)}")
    hvd.shutdown()


def topo() -> None:
    import numpy as np
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    digest = hashlib.sha256()
    for i in range(4):
        rng = np.random.RandomState(2000 + i)
        base = torch.from_numpy(
            rng.randint(-1000, 1000, size=4096).astype(np.float32))
        out = hvd.allreduce(base + float(rank * (i + 1)), average=False,
                            name=f"topo.{i}")
        want = base * n + float(sum(r * (i + 1) for r in range(n)))
        if not torch.equal(out, want):
            raise AssertionError(f"rank {rank} payload {i}: wrong sum")
        digest.update(out.numpy().tobytes())
    # Cache-served replays: uniform bits-only frames, the container's
    # template/roster fast path.
    fixed = torch.full((4096,), 3.0)
    for j in range(8):
        out = hvd.allreduce(fixed, average=False, name="topo.replay")
        if not torch.equal(out, torch.full((4096,), 3.0 * n)):
            raise AssertionError(f"rank {rank} replay {j}: wrong sum")
        digest.update(out.numpy().tobytes())
    mine = torch.from_numpy(np.random.RandomState(3000 + rank).randn(
        rank + 2, 3).astype(np.float32))
    digest.update(hvd.allgather(mine, name="topo.gather").numpy().tobytes())
    root = torch.from_numpy(np.random.RandomState(4000 + rank).randn(
        257).astype(np.float32))
    digest.update(hvd.broadcast(root, 1, name="topo.bcast").numpy()
                  .tobytes())
    # Per-set traffic (set-tagged requests never cache), the reference's
    # schedule (tests/test_aggregate.py): one-rank sets solo<r>.
    me = hvd.process_set_by_name(f"solo{rank}")
    for j in range(2):
        want = torch.full((64,), float(rank + j))
        out = hvd.allreduce(want, average=False, name=f"topo.set.{j}",
                            process_set=me)
        if not torch.equal(out, want):
            raise AssertionError(f"rank {rank} set {j}: wrong sum")
        digest.update(out.numpy().tobytes())
    # Drain: one last world collective, so that no rank shuts down while
    # a peer still negotiates its solo-set collectives.
    digest.update(hvd.allreduce(torch.ones(16), average=False,
                                name="topo.drain").numpy().tobytes())
    print("DIGEST", digest.hexdigest(), flush=True)
    snap = hvd.metrics()
    print("SNAP", json.dumps({"counters": snap["counters"],
                              "gauges": snap["gauges"]}), flush=True)
    hvd.shutdown()


def elastic_topo() -> None:
    directory = os.environ["TEST_CKPT_DIR"]
    die_rank = int(os.environ.get("TEST_DIE_RANK", "-1"))
    expect = int(os.environ["TEST_EXPECT_SIZE"])
    elastic.init(device="cpu")
    w0 = torch.arange(8, dtype=torch.float32)

    def train(state, epoch):
        gen = elastic.generation()
        if gen == 0 and hvd.rank() == 0:
            checkpoint.save(directory, state, 0)
        if gen == 0 or hvd.size() != expect:
            t0 = time.monotonic()
            i = 0
            while time.monotonic() - t0 < 60:
                if elastic.generation() != gen:
                    raise hvd.HorovodRetryableError(
                        "membership changed between steps")
                if hvd.rank() == die_rank and i == 5:
                    os.kill(os.getpid(), signal.SIGKILL)
                hvd.allreduce(torch.ones(8), name=f"et.{gen}.{i}")
                i += 1
            print(f"NO_RECONFIG rank={hvd.rank()}", flush=True)
            sys.exit(5)
        ok = torch.equal(state["w"], w0)
        print(f"RESUMED rank={hvd.rank()} size={hvd.size()} gen={gen} "
              f"state_ok={ok}", flush=True)
        return state

    try:
        elastic.run_elastic(train, directory=directory, like={"w": w0})
    except hvd.HorovodAbortedError as exc:
        print(f"ABORTED rank={hvd.rank()} msg={exc}", flush=True)
        sys.exit(3)
    print("DONE", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    {"policy": policy, "topo": topo,
     "elastic_topo": elastic_topo}[os.environ["TEST_MODE"]]()
