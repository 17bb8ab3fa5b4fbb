"""MNIST training, the port's twin of ``examples/jax_mnist.py``: the
reference's 4-step recipe (init -> shard data by rank -> wrap optimizer
-> broadcast initial state), the ConvNet model, per-epoch metric
averaging, on the same deterministic synthetic stand-in unless
``--data`` names a local ``mnist.npz``.

Usage:  python -m horovod_tpu_torch.examples.mnist --epochs 2
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.mnist)
"""

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as hvd_callbacks
from horovod_tpu_torch.data import ShardedLoader, epoch_batches
from horovod_tpu_torch.models import ConvNet


def load_data(path):
    """(train_x, train_y, test_x, test_y) in [0, 1], (N, 28, 28)."""
    if path and os.path.exists(path):
        with np.load(path) as d:
            return (d["x_train"].astype(np.float32) / 255.0, d["y_train"],
                    d["x_test"].astype(np.float32) / 255.0, d["y_test"])
    # Synthetic stand-in: class-dependent blobs, learnable to high accuracy.
    rng = np.random.RandomState(0)
    n_train, n_test = 8192, 1024
    y = rng.randint(0, 10, n_train + n_test)
    x = rng.randn(n_train + n_test, 28, 28).astype(np.float32) * 0.1
    for c in range(10):
        mask = y == c
        x[mask, c * 2:(c * 2) + 4, c * 2:(c * 2) + 4] += 1.0
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def main(argv=None, device: str = "cuda"):
    """Train and return the test accuracy averaged over the ranks;
    ``device="cpu"`` runs on the CPU over gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--data", type=str, default="",
                   help="path to an mnist.npz; synthetic data if absent")
    args = p.parse_args(argv)

    # Step 1: initialize from the launcher's environment.
    hvd.init(device=device)
    n = hvd.size()
    dev = (torch.device("cpu") if device == "cpu"
           else torch.device("cuda", hvd.local_rank()))

    train_x, train_y, test_x, test_y = load_data(args.data)
    model = ConvNet(seed=0, device=dev)

    # Step 3: wrap the optimizer; LR scaled by size per the reference
    # recipe, the warmup ramps into it.
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=args.lr * n, momentum=args.momentum))

    state = hvd_callbacks.TrainingState(params=model, opt_state=opt)
    # One process per GPU: each stages its own batch_size rows a step.
    steps_per_epoch = (len(train_x) // n) // args.batch_size
    cbs = hvd_callbacks.CallbackList(
        [
            # Step 4: broadcast initial state from rank 0.
            hvd_callbacks.BroadcastGlobalVariablesCallback(0),
            hvd_callbacks.MetricAverageCallback(),
            hvd_callbacks.LearningRateWarmupCallback(
                warmup_epochs=1, steps_per_epoch=steps_per_epoch, verbose=1),
        ],
        state, params={"steps": steps_per_epoch})

    cbs.on_train_begin()
    for epoch in range(args.epochs):
        cbs.on_epoch_begin(epoch)
        # Step 2: DistributedSampler-style epoch shard -- identical
        # shuffle everywhere, rank-strided rows, equal batch counts; the
        # loader stages batches on this rank's device a step ahead.
        loader = ShardedLoader(
            lambda e=epoch: epoch_batches(train_x, train_y,
                                          args.batch_size, rank=hvd.rank(),
                                          size=n, seed=1234 + e), dev)
        losses = []
        for b, (x, y) in enumerate(loader):
            cbs.on_batch_begin(b)
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y.long())
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            cbs.on_batch_end(b)
        logs = {"loss": float(torch.stack(losses).mean())}
        cbs.on_epoch_end(epoch, logs=logs)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={logs['loss']:.4f} "
                  f"lr={logs.get('lr', float('nan')):.4f}")

    # Eval (rank-replicated; the metric averaged across ranks, as the
    # reference's pytorch_mnist.py metric_average does).
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(test_x).to(dev))
    acc = float((logits.argmax(-1).cpu().numpy() == test_y).mean())
    acc = float(hvd.allreduce(torch.tensor(acc, device=dev), average=True,
                              name="test.accuracy"))
    if hvd.rank() == 0:
        print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
