"""One worker of the port's elastic drill (torch only, so it starts fast).

Launched by ``python -m horovod_tpu_torch.run --elastic`` from
``tests/test_torch_elastic.py``: each rank trains a small linear model on
the CPU through ``elastic.run_elastic`` and
``DistributedOptimizer(SGD momentum, eager=True)`` (the negotiated eager
plane), snapshotting ``checkpoint.model_state`` into the async stream
every ``--snapshot-every-steps`` steps, as ``chip_smoke.py``'s phase 28
does on the card.  The rank named by
``TEST_DIE_RANK`` kills itself with SIGKILL at step ``TEST_DIE_STEP`` of
generation 0; a
survivor that re-enters ``train`` holds its restored state against the
state it had itself at that epoch, bit for bit, and prints::

    RESUMED rank=<r> size=<n> gen=<g> epoch=<e> state_ok=<bool>

With ``TEST_EXPECT_SIZE``, a generation of another size trains no step:
it waits for the next membership change (a parked standby admitted by the
``rejoin`` fault action), and a standby parks only once the survivors have
reconfigured (``TEST_STANDBY_AFTER_LOSS``), so that the loss shrinks the
world before the standby grows it back.  The test drives the environment
through the launcher's ``env=``.
"""

import hashlib
import os
import signal
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, elastic

DIM = 16


def _batch(step: int, rank: int):
    gen = torch.Generator().manual_seed(1000 * step + rank)
    x = torch.randn(8, DIM, generator=gen)
    return x, x @ torch.linspace(-1, 1, DIM)


def _digest(state) -> str:
    h = hashlib.sha256()
    for key, value in sorted(checkpoint.flatten_state(state).items()):
        h.update(key.encode())
        h.update(value.tobytes())
    return h.hexdigest()


def _wait_for(path: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            sys.exit(f"{path} never appeared")
        time.sleep(0.05)


def main() -> None:
    directory = os.environ["TEST_CKPT_DIR"]
    marker = os.path.join(directory, "reconfigured")
    if elastic.is_standby() and os.environ.get("TEST_STANDBY_AFTER_LOSS"):
        _wait_for(marker)
    elastic.init(device="cpu")
    die_rank = int(os.environ.get("TEST_DIE_RANK", "-1"))
    die_step = int(os.environ.get("TEST_DIE_STEP", "5"))
    steps = int(os.environ.get("TEST_STEPS", "10"))
    expect = int(os.environ.get("TEST_EXPECT_SIZE", "0"))
    seen = {}     # epoch -> digest of this process's own state then
    torch.manual_seed(0)
    model = torch.nn.Linear(DIM, 1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        eager=True)
    # A zero momentum gives SGD's first update bit for bit, and the state
    # its whole structure from the start (the restore template).
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)

    def train(state, epoch):
        gen = elastic.generation()
        checkpoint.load_model_state(model, opt, state)
        if epoch >= 0 and hvd.rank() == 0 and gen > 0:
            ok = seen.get(epoch) == _digest(
                checkpoint.model_state(model, opt))
            print(f"RESUMED rank={hvd.rank()} size={hvd.size()} gen={gen} "
                  f"epoch={epoch} state_ok={ok}", flush=True)
        if gen > 0:
            open(marker, "w").close()
        deadline = time.monotonic() + 60
        size = hvd.size()
        while expect and size != expect:
            if elastic.generation() != gen:
                raise hvd.HorovodRetryableError(
                    "membership changed while waiting for a standby")
            if time.monotonic() > deadline:
                sys.exit(f"NO_RECONFIG rank={hvd.rank()} size={size}")
            time.sleep(0.05)
        for step in range(max(epoch, 0), steps):
            if elastic.generation() != gen:
                raise hvd.HorovodRetryableError(
                    "membership changed between steps")
            if gen == 0 and hvd.rank() == die_rank and step == die_step:
                os.kill(os.getpid(), signal.SIGKILL)
            x, y = _batch(step, hvd.rank())
            opt.zero_grad()
            (model(x).squeeze(-1) - y).square().mean().backward()
            opt.step()
            state = checkpoint.model_state(model, opt)
            seen[step + 1] = _digest(state)
            elastic.snapshot(state, step + 1)

    try:
        elastic.run_elastic(train, directory=directory,
                            like=checkpoint.model_state(model, opt))
    except hvd.HorovodAbortedError as exc:
        print(f"ABORTED rank={hvd.rank()} msg={exc}", flush=True)
        sys.exit(3)
    print(f"DONE rank={hvd.rank()} size={hvd.size()} "
          f"gen={elastic.generation()} "
          f"digest={_digest(checkpoint.model_state(model, opt))}",
          flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
