"""Data-parallel pod training, the port's twin of
``examples/jax_pod_training.py``: each process feeds only its own rows of
the global batch (``data.shard_for_process``, the multi-controller input
contract) and ``make_train_step`` averages the gradients over every GPU,
on the JAX example's synthetic regression task and MLP.

The JAX example starts the pod runtime (``jax.distributed.initialize``);
here the launcher's environment is the runtime, and one process is one
GPU.

Usage:  python -m horovod_tpu_torch.examples.pod_training --steps 30
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.pod_training)
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.data import shard_for_process
from horovod_tpu_torch.models import MLP
from horovod_tpu_torch.spmd import make_train_step

D_IN, D_OUT = 16, 4


def make_data(batch_per_rank: int, n: int):
    """The JAX example's deterministic task, identical on every process:
    (x_global, y_global) of ``batch_per_rank * n`` rows."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(D_IN, D_OUT).astype(np.float32)
    x_global = rng.randn(batch_per_rank * n, D_IN).astype(np.float32)
    return x_global, x_global @ w_true


def main(argv=None, device: str = "cuda"):
    """Train and return (first loss, final loss); ``device="cpu"`` runs on
    the CPU over gloo."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-per-rank", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    hvd.init(device=device)
    n = hvd.size()
    dev = hvd.local_devices()[0]
    if hvd.rank() == 0:
        print(f"pod: {hvd.process_count()} process(es), {n} ranks")

    x_global, y_global = make_data(args.batch_per_rank, n)
    model = MLP(D_IN, features=(64,), num_classes=D_OUT, seed=0, device=dev)
    # Startup sync (the reference recipe's step 4): identical initial state.
    hvd.broadcast_parameters(model, root_rank=0)

    def loss_fn(model, data):
        x, y = data
        return torch.mean((model(x) - y) ** 2)

    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    step = make_train_step(model, loss_fn, opt, sync_aux_state=False)

    # Each process supplies only the rows of its ranks.
    rows = len(x_global) // hvd.process_count()
    lo = hvd.process_index() * rows
    data = shard_for_process((x_global[lo:lo + rows],
                              y_global[lo:lo + rows]), dev)

    loss0 = loss = None
    for i in range(args.steps):
        loss = step(data)
        if loss0 is None:
            loss0 = float(loss)
        if hvd.rank() == 0 and i % 10 == 0:
            print(f"step {i:4d}  loss {float(loss):.6f}")
    final = float(loss)
    if hvd.rank() == 0:
        print(f"final loss {final:.6f} (from {loss0:.6f})")
    return loss0, final


if __name__ == "__main__":
    main()
