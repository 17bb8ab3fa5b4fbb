"""Advanced MNIST, the port's twin of ``examples/jax_mnist_advanced.py``:
data augmentation with **per-rank random streams**, the full callback
stack (broadcast, metric averaging, LR warmup), and rank-0-only
checkpointing, on the JAX example's synthetic data and ConvNet.

The JAX example folds its rank and the step counter into one replicated
PRNG key inside the compiled step.  Here each rank draws its offsets and
scales on the host from its own stream, keyed on (42, rank, step)
(:func:`draw_augmentation`), and :func:`shift_scale` applies them on the
device: the same shift by zero-pad and slice, the same multiplicative
jitter.  ``jax.random``'s bits are not reproduced.

Usage:  python -m horovod_tpu_torch.examples.mnist_advanced --epochs 4
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.mnist_advanced)
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as hvd_callbacks
from horovod_tpu_torch import checkpoint as hvd_checkpoint
from horovod_tpu_torch.models import ConvNet
from horovod_tpu_torch.spmd import make_eval_step, shard_batch

MAX_SHIFT = 3        # random translation, pixels
SCALE_RANGE = 0.08   # random multiplicative jitter
AUG_SEED = 42        # the JAX example's PRNGKey(42)


def draw_augmentation(rank: int, step: int, n: int):
    """This rank's offsets and scales for step ``step``: (dy, dx) in [0,
    2 * MAX_SHIFT] (a shift in [-3, 3]) and a scale in [1 - SCALE_RANGE,
    1 + SCALE_RANGE) per image, from the stream keyed on (AUG_SEED, rank,
    step)."""
    rng = np.random.RandomState([AUG_SEED, rank, step])
    dy, dx = rng.randint(0, 2 * MAX_SHIFT + 1, (2, n))
    scale = (1.0 + rng.uniform(-SCALE_RANGE, SCALE_RANGE, n)).astype(
        np.float32)
    return dy, dx, scale


def shift_scale(images: torch.Tensor, dy, dx, scale) -> torch.Tensor:
    """Each (H, W) image zero-padded by MAX_SHIFT on every side, the (H, W)
    window at (dy, dx) of the padded image taken, times its scale: the JAX
    example's pad + ``dynamic_slice`` + scale, for all images at once."""
    n, h, w = images.shape
    dev = images.device
    dy, dx, scale = (torch.as_tensor(a, device=dev) for a in (dy, dx, scale))
    padded = F.pad(images, (MAX_SHIFT,) * 4)
    rows = (dy[:, None] + torch.arange(h, device=dev))[:, :, None]
    cols = (dx[:, None] + torch.arange(w, device=dev))[:, None, :]
    out = padded[torch.arange(n, device=dev)[:, None, None], rows, cols]
    return out * scale.to(images.dtype)[:, None, None]


def load_data():
    """Deterministic synthetic MNIST stand-in (hermetic; no downloads),
    the JAX example's.  The class signal is blob *size*
    (shift-invariant), so random-shift augmentation makes the task harder
    without making it ambiguous."""
    rng = np.random.RandomState(0)
    n_train, n_test = 8192, 1024
    y = rng.randint(0, 10, n_train + n_test)
    x = rng.randn(n_train + n_test, 28, 28).astype(np.float32) * 0.1
    for c in range(10):
        mask = y == c
        sz = 2 * c + 2
        x[mask, 4:4 + sz, 4:4 + sz] += 1.0
    return (x[:n_train], y[:n_train].astype(np.int32),
            x[n_train:], y[n_train:].astype(np.int32))


def epoch_rows(rng_np, n_train: int, global_batch: int, steps: int):
    """The rows of each global batch of one epoch: the JAX example's
    permutation (one draw of ``rng_np`` an epoch) cut into global
    batches."""
    perm = rng_np.permutation(n_train)
    for b in range(steps):
        yield perm[b * global_batch:(b + 1) * global_batch]


def main(argv=None, device: str = "cuda"):
    """Train and return the test accuracy averaged over the ranks;
    ``device="cpu"`` runs on the CPU over gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--warmup-epochs", type=int, default=2)
    p.add_argument("--checkpoint-dir", type=str, default="")
    args = p.parse_args(argv)

    hvd.init(device=device)
    n, rank = hvd.size(), hvd.rank()
    dev = hvd.local_devices()[0]
    global_batch = args.batch_size * n

    train_x, train_y, test_x, test_y = load_data()
    model = ConvNet(seed=0, device=dev)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=args.lr * n, momentum=0.9))

    def accuracy(model, batch):
        imgs, lbls = batch
        return {"accuracy": (model(imgs).argmax(-1) == lbls).float().mean()}

    eval_step = make_eval_step(model, accuracy)

    state = hvd_callbacks.TrainingState(params=model, opt_state=opt)
    steps_per_epoch = len(train_x) // global_batch
    cbs = hvd_callbacks.CallbackList(
        [
            hvd_callbacks.BroadcastGlobalVariablesCallback(0),
            hvd_callbacks.MetricAverageCallback(),
            hvd_callbacks.LearningRateWarmupCallback(
                warmup_epochs=args.warmup_epochs,
                steps_per_epoch=steps_per_epoch, verbose=1),
        ],
        state, params={"steps": steps_per_epoch})

    step = 0
    rng_np = np.random.RandomState(1234)
    cbs.on_train_begin()
    for epoch in range(args.epochs):
        cbs.on_epoch_begin(epoch)
        losses = []
        for b, rows in enumerate(epoch_rows(rng_np, len(train_x),
                                            global_batch, steps_per_epoch)):
            cbs.on_batch_begin(b)
            imgs, lbls = shard_batch((torch.from_numpy(train_x[rows]),
                                      torch.from_numpy(train_y[rows])))
            # Per-rank stream: (rank, step) keys this rank's draws.
            imgs = shift_scale(imgs, *draw_augmentation(rank, step,
                                                        len(imgs)))
            opt.zero_grad()
            loss = F.cross_entropy(model(imgs), lbls.long())
            loss.backward()
            opt.step()
            step += 1
            losses.append(loss.detach())
            cbs.on_batch_end(b)
        logs = {"loss": float(torch.stack(losses).mean())}
        cbs.on_epoch_end(epoch, logs=logs)
        # Rank-0-only checkpointing; other ranks no-op inside save().
        if args.checkpoint_dir:
            hvd_checkpoint.save(args.checkpoint_dir,
                                hvd_checkpoint.model_state(model, opt), epoch)
        if rank == 0:
            print(f"epoch {epoch}: loss={logs['loss']:.4f} "
                  f"lr={logs.get('lr', float('nan')):.4f}")

    accs = []
    for b in range(len(test_x) // global_batch):
        sl = slice(b * global_batch, (b + 1) * global_batch)
        m = eval_step(shard_batch((torch.from_numpy(test_x[sl]),
                                   torch.from_numpy(test_y[sl]))))
        accs.append(float(m["accuracy"]))
    acc = float(np.mean(accs))
    if rank == 0:
        print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
