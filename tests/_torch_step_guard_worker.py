"""Torch-only workers of ``tests/test_torch_step_guard.py`` (kept apart
from the test file so that a spawned worker imports PyTorch and the port,
not JAX).

* :func:`injit_counts`: one rank of the 2-process gloo job (through
  ``_torch_spmd_worker.run_group``).  For each case of :data:`CASES` it
  builds ``make_train_step`` over :func:`mlp` and returns the deltas of
  the ``injit.*`` counters around one call.
* As a script, ``python _torch_step_guard_worker.py <mode> [args]``,
  with ``HOROVOD_TPU_STEP_TIMEOUT_S`` in its environment:

  - ``block``: one step whose loss sleeps 60 s inside the call; the
    step watchdog must end the process with exit code 83;
  - ``healthy <gap_s>``: 20 steps of about 20 ms, an idle gap of
    ``gap_s`` seconds (longer than the deadline), 5 more steps; prints
    ``HEALTHY_DONE`` and exits 0;
  - ``drill <rank> <port>``: one of two ranks launched from the
    environment with no control plane (the reference's
    ``tests/_crash_worker.py``): 3 steps,
    then rank 1 prints ``CRASHING`` and exits 17 while rank 0 prints
    ``SURVIVOR_CONTINUES`` and keeps stepping.  A surfaced error prints
    ``SURVIVOR_ERROR`` and exits 3; the watchdog exits 83.
"""

import os
import sys
import time

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.metrics import registry  # noqa: E402
from horovod_tpu_torch.spmd import make_train_step  # noqa: E402

# (compression, steps_per_call, two-tier) of each counted call.
CASES = [("none", 1, False), ("bf16", 1, False), ("int8", 1, False),
         ("int8", 3, False), ("none", 3, False), ("int8", 1, True),
         ("bf16", 1, True), ("auto", 1, False), ("auto", 2, True)]


def mlp(seed: int = 0) -> torch.nn.Module:
    """Linear(64, 512) -> tanh -> Linear(512, 8): a (512, 64) f32 weight
    above the int8 floor, an (8, 512) one under it, two 1-D biases."""
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(64, 512), torch.nn.Tanh(),
                               torch.nn.Linear(512, 8))


def mse(model, batch):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def batch_of(rank: int, leading=()):
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(*leading, 4, 64, generator=gen)
    return x, torch.randn(*leading, 4, 8, generator=gen)


def leaves(model) -> list:
    return [(tuple(p.shape), str(p.dtype).replace("torch.", ""))
            for p in model.parameters()]


def injit_counts(rank: int) -> dict:
    model = mlp()
    mesh = hvd.hierarchical_mesh()
    out = {"leaves": leaves(model), "size": hvd.size()}
    for case in CASES:
        compression, spc, two_tier = case
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, mse, opt, compression=compression,
                               steps_per_call=spc,
                               mesh=mesh if two_tier else None)
        batch = batch_of(rank, (spc,) if spc > 1 else ())
        before = registry.snapshot()["counters"]
        step(batch)
        after = registry.snapshot()["counters"]
        out[case] = {k: after[k] - before.get(k, 0) for k in after
                     if k.startswith("injit.")
                     and after[k] != before.get(k, 0)}
    return out


def _steps(step, batch, n: int) -> None:
    for _ in range(n):
        step(batch)


def _block() -> None:
    model = mlp()

    def sleepy(model, batch):
        time.sleep(60)
        return mse(model, batch)

    step = make_train_step(model, sleepy, torch.optim.SGD(
        model.parameters(), lr=0.01))
    print("BLOCKING", flush=True)
    step(batch_of(0))
    print("STEP_RETURNED", flush=True)


def _healthy(gap_s: float) -> None:
    model = mlp()

    def paced(model, batch):
        time.sleep(0.02)
        return mse(model, batch)

    step = make_train_step(model, paced, torch.optim.SGD(
        model.parameters(), lr=0.01))
    batch = batch_of(0)
    _steps(step, batch, 20)
    time.sleep(gap_s)
    _steps(step, batch, 5)
    print("HEALTHY_DONE", flush=True)


def _drill(rank: int, port: int) -> None:
    os.environ.update({"HOROVOD_TPU_SIZE": "2",
                       "HOROVOD_TPU_RANK": str(rank),
                       "HOROVOD_TPU_LOCAL_RANK": str(rank),
                       "HOROVOD_TPU_LOCAL_SIZE": "1"})
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{port}")
    model = mlp()
    step = make_train_step(model, mse, torch.optim.SGD(
        model.parameters(), lr=0.1))
    batch = batch_of(rank)
    for i in range(3):
        print(f"STEP {i} LOSS {float(step(batch))!r}", flush=True)
    if rank == 1:
        print("CRASHING", flush=True)
        os._exit(17)   # no shutdown: the sockets drop
    print("SURVIVOR_CONTINUES", flush=True)
    try:
        for i in range(3, 40):
            print(f"STEP {i} LOSS {float(step(batch))!r}", flush=True)
    except Exception as exc:   # noqa: BLE001 -- a surfaced error passes
        print(f"SURVIVOR_ERROR {type(exc).__name__}: {str(exc)[:200]}",
              flush=True)
        os._exit(3)
    print("SURVIVOR_FINISHED", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "block":
        _block()
    elif mode == "healthy":
        _healthy(float(sys.argv[2]))
    else:
        _drill(int(sys.argv[2]), int(sys.argv[3]))
