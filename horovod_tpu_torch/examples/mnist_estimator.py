"""Estimator-style MNIST, the port's twin of
``examples/jax_mnist_estimator.py``: a structured train/evaluate loop
driven by a model_fn, with the rank-0-only ``model_dir`` checkpoint
convention and total steps divided by world size, on the JAX example's
synthetic data and ConvNet.

The :class:`Estimator` owns auto-resume from the newest checkpoint in
``model_dir``, the broadcast after init or restore, periodic rank-0
checkpointing and sharded evaluation, so the user script is a model_fn
and two input_fns.

Usage:  python -m horovod_tpu_torch.examples.mnist_estimator --steps 200
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.mnist_estimator)
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as hvd_checkpoint
from horovod_tpu_torch.models import ConvNet
from horovod_tpu_torch.spmd import make_eval_step, shard_batch


def _rank_block(batch):
    """This rank's block of a global batch of numpy arrays, on its
    device."""
    return shard_batch(tuple(torch.from_numpy(a) for a in batch))


class Estimator:
    """Structured training loop over ``DistributedOptimizer``.

    ``init_fn(seed) -> torch.nn.Module`` builds the model on this rank's
    device; ``model_fn(model, batch) -> (loss, predictions)``;
    ``optimizer(params) -> torch.optim.Optimizer`` builds the optimizer
    that :func:`~horovod_tpu_torch.DistributedOptimizer` wraps.
    ``model_dir`` follows the reference's estimator convention: pass a
    path on every rank; only rank 0 writes, every rank restores through
    a rank-0 read and a broadcast.
    """

    def __init__(self, init_fn, model_fn, optimizer, model_dir=None,
                 checkpoint_every=0, device: str = "cuda"):
        hvd.init(device=device)
        self.model_fn = model_fn
        self.model_dir = model_dir
        self.checkpoint_every = checkpoint_every
        self.model = init_fn(0)
        self.opt = hvd.DistributedOptimizer(
            optimizer(self.model.parameters()))
        self.global_step = 0

        def metrics_fn(model, batch):
            loss, preds = model_fn(model, batch)
            return {"loss": loss,
                    "accuracy": (preds == batch[1]).float().mean()}

        self._eval_step = make_eval_step(self.model, metrics_fn)

        if model_dir:
            # Auto-resume: rank 0 scans and restores, the state is
            # broadcast to every rank (also when nothing was found, so a
            # fresh init is rank-consistent too).  The template needs the
            # optimizer's state, which torch fills at the first step.
            _zero_momentum(self.opt)
            like = dict(hvd_checkpoint.model_state(self.model, self.opt),
                        global_step=np.asarray(0, np.int64))
            restored, resume = hvd_checkpoint.restore_and_broadcast(
                model_dir, like)
            hvd_checkpoint.load_model_state(self.model, self.opt, restored)
            if resume >= 0:
                self.global_step = int(
                    np.asarray(restored["global_step"]).item())
        else:
            hvd.broadcast_parameters(self.model, root_rank=0)

    def _save(self):
        if self.model_dir:
            hvd_checkpoint.save(
                self.model_dir,
                dict(hvd_checkpoint.model_state(self.model, self.opt),
                     global_step=self.global_step),
                self.global_step)

    def train(self, input_fn, steps):
        """Run ``steps // size`` optimizer steps (the reference scales
        total work by world size); ``input_fn(step) -> global batch``."""
        local_steps = max(1, steps // hvd.size())
        for _ in range(local_steps):
            batch = _rank_block(input_fn(self.global_step))
            self.opt.zero_grad()
            loss, _ = self.model_fn(self.model, batch)
            loss.backward()
            self.opt.step()
            self.global_step += 1
            if (self.checkpoint_every
                    and self.global_step % self.checkpoint_every == 0):
                self._save()
        self._save()
        return {"loss": float(loss.detach()),
                "global_step": self.global_step}

    def evaluate(self, input_fn, steps):
        totals = {}
        for step in range(steps):
            m = self._eval_step(_rank_block(input_fn(step)))
            for k, v in m.items():
                totals.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in totals.items()}


def _zero_momentum(opt):
    """Fill an SGD optimizer's momentum buffers with zeros: torch creates
    them at the first step, and zeros give that step bit for bit."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p].setdefault("momentum_buffer", torch.zeros_like(p))


def load_data():
    """The JAX example's synthetic stand-in: a class's 4 x 4 blob sits at
    (2c, 2c)."""
    rng = np.random.RandomState(0)
    n_train, n_test = 8192, 1024
    y = rng.randint(0, 10, n_train + n_test)
    x = rng.randn(n_train + n_test, 28, 28).astype(np.float32) * 0.1
    for c in range(10):
        mask = y == c
        x[mask, c * 2:(c * 2) + 4, c * 2:(c * 2) + 4] += 1.0
    return (x[:n_train], y[:n_train].astype(np.int32),
            x[n_train:], y[n_train:].astype(np.int32))


def input_fns(data, global_batch: int, global_step: int):
    """The JAX example's two input_fns: random global batches of the
    training set from a stream seeded with ``global_step + 1`` (a resumed
    run draws anew), and the test set's global batches in order."""
    train_x, train_y, test_x, test_y = data
    rng = np.random.RandomState(global_step + 1)

    def train_input_fn(step):
        idx = rng.randint(0, len(train_x), global_batch)
        return train_x[idx], train_y[idx]

    def eval_input_fn(step):
        sl = slice(step * global_batch, (step + 1) * global_batch)
        return test_x[sl], test_y[sl]

    return train_input_fn, eval_input_fn


def main(argv=None, device: str = "cuda"):
    """Train, evaluate and return the test accuracy; ``device="cpu"`` runs
    on the CPU over gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200,
                   help="total train steps across all ranks")
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--model-dir", type=str, default="")
    p.add_argument("--checkpoint-every", type=int, default=50)
    args = p.parse_args(argv)

    hvd.init(device=device)
    n = hvd.size()
    global_batch = args.batch_size * n
    train_x, train_y, test_x, test_y = load_data()
    dev = hvd.local_devices()[0]

    def model_fn(model, batch):
        imgs, lbls = batch
        logits = model(imgs)
        loss = F.cross_entropy(logits, lbls.long())
        return loss, logits.argmax(-1)

    est = Estimator(lambda seed: ConvNet(seed=seed, device=dev), model_fn,
                    lambda params: torch.optim.SGD(params, lr=args.lr * n,
                                                   momentum=0.9),
                    model_dir=args.model_dir or None,
                    checkpoint_every=args.checkpoint_every, device=device)

    train_input_fn, eval_input_fn = input_fns(
        (train_x, train_y, test_x, test_y), global_batch, est.global_step)
    result = est.train(train_input_fn, steps=args.steps)
    metrics = est.evaluate(eval_input_fn, steps=len(test_x) // global_batch)
    if hvd.rank() == 0:
        print(f"global_step={result['global_step']} "
              f"eval_loss={metrics['loss']:.4f} "
              f"eval_accuracy={metrics['accuracy']:.4f}")
    return metrics["accuracy"]


if __name__ == "__main__":
    main()
