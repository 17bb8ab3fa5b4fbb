"""ImageNet ResNet-50, the port's twin of
``examples/jax_imagenet_resnet50.py``: LR warmup and the staircase
schedule as callbacks, rank-0 checkpointing, and restore-and-broadcast
resume, on the JAX example's synthetic batches.

The model is ResNet-50 in bf16 (its BatchNorm statistics are the aux state
``make_train_step`` keeps equal across ranks); the optimizer SGD with
momentum and weight decay, ``base_lr x size``, wrapped by
``DistributedOptimizer(compression=Compression.bf16)``.  torch SGD's
``weight_decay`` adds ``wd * p`` to the gradient before the momentum, as
the JAX example's ``optax.add_decayed_weights`` before ``optax.sgd``
does.  ``make_train_step`` averages the gradients first; the optimizer's
own reduction then sees every rank's gradient equal, as the JAX
example's does inside its step, and rounds it through bf16.

Usage:  python -m horovod_tpu_torch.examples.imagenet_resnet50 --epochs 90
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.imagenet_resnet50)
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as hvd_callbacks
from horovod_tpu_torch import checkpoint as hvd_checkpoint
from horovod_tpu_torch.models import ResNet50
from horovod_tpu_torch.spmd import make_train_step, shard_batch


def synthetic_batches(global_batch, image_size, steps, seed):
    """The JAX example's synthetic data: NHWC f32 images and labels of
    each global batch."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        x = rng.randn(global_batch, image_size, image_size, 3).astype(
            np.float32)
        y = rng.randint(0, 1000, global_batch).astype(np.int32)
        yield x, y


def make_optimizer(model, base_lr: float, momentum: float, wd: float):
    """SGD with momentum and weight decay at ``base_lr x size`` under the
    bf16 wire; its momentum buffers filled with zeros (torch creates them
    at the first step; zeros give that step bit for bit), so that the
    state is a checkpoint template from the start."""
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=base_lr * hvd.size(),
                        momentum=momentum, weight_decay=wd),
        compression=hvd.Compression.bf16)
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return opt


def loss_fn(model, batch):
    imgs, lbls = batch
    return F.cross_entropy(model(imgs).float(), lbls.long())


def main(argv=None, device: str = "cuda"):
    """Train from the newest checkpoint in ``--checkpoint-dir``; return
    each epoch's mean loss.  ``device="cpu"`` runs on the CPU over
    gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-rank batch size")
    p.add_argument("--base-lr", type=float, default=0.0125,
                   help="per-rank base LR (scaled by size, reference :107)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--checkpoint-dir", type=str, default="./checkpoints")
    p.add_argument("--steps-per-epoch", type=int, default=100,
                   help="synthetic-data steps per epoch")
    p.add_argument("--image-size", type=int, default=224)
    args = p.parse_args(argv)

    hvd.init(device=device)
    n, rank = hvd.size(), hvd.rank()
    dev = hvd.local_devices()[0]
    global_batch = args.batch_size * n

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                     device=dev)
    opt = make_optimizer(model, args.base_lr, args.momentum, args.wd)
    configured = [{k: g[k] for k in ("lr", "momentum")}
                  for g in opt.param_groups]
    train_step = make_train_step(model, loss_fn, opt, sync_aux_state=True)

    # Resume: agree on the epoch, restore on rank 0, broadcast everywhere.
    # Checkpoints without the optimizer's state still resume (momentum
    # then restarts from zero).
    restored, resume_epoch = hvd_checkpoint.restore_and_broadcast(
        args.checkpoint_dir, hvd_checkpoint.model_state(model, opt),
        optional_keys=("opt_state",))
    hvd_checkpoint.load_model_state(model, opt, restored)
    # The restored param groups carry the checkpoint's DECAYED learning
    # rate; the schedule callbacks take the initial one at on_train_begin
    # and re-apply their multipliers each epoch, so the live values go
    # back to the configured ones (the momentum buffers stay restored).
    for g, c in zip(hvd_callbacks.find_hyperparams(opt), configured):
        g.update(c)

    state = hvd_callbacks.TrainingState(params=model, opt_state=opt)
    cbs = hvd_callbacks.CallbackList(
        [
            hvd_callbacks.BroadcastGlobalVariablesCallback(0),
            hvd_callbacks.MetricAverageCallback(),
            # Warmup then the reference's staircase decay.
            hvd_callbacks.LearningRateWarmupCallback(
                warmup_epochs=args.warmup_epochs,
                steps_per_epoch=args.steps_per_epoch, verbose=1),
            hvd_callbacks.LearningRateScheduleCallback(
                multiplier=1.0, start_epoch=args.warmup_epochs,
                end_epoch=30),
            hvd_callbacks.LearningRateScheduleCallback(
                multiplier=1e-1, start_epoch=30, end_epoch=60),
            hvd_callbacks.LearningRateScheduleCallback(
                multiplier=1e-2, start_epoch=60, end_epoch=80),
            hvd_callbacks.LearningRateScheduleCallback(
                multiplier=1e-3, start_epoch=80),
        ],
        state, params={"steps": args.steps_per_epoch})

    epoch_losses = []
    images, seconds = 0, 0.0
    cbs.on_train_begin()
    for epoch in range(resume_epoch + 1, args.epochs):
        cbs.on_epoch_begin(epoch)
        losses = []
        for b, (x, y) in enumerate(synthetic_batches(
                global_batch, args.image_size, args.steps_per_epoch,
                seed=epoch)):
            cbs.on_batch_begin(b)
            t0 = time.perf_counter()
            batch = shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
            losses.append(train_step(batch))
            if b:     # each epoch's first step is left out of the timing
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                seconds += time.perf_counter() - t0
                images += args.batch_size
            cbs.on_batch_end(b)
        logs = {"loss": float(torch.stack(losses).mean())}
        cbs.on_epoch_end(epoch, logs=logs)
        epoch_losses.append(logs["loss"])
        # Rank-0-only checkpoint; other ranks no-op inside save().
        hvd_checkpoint.save(args.checkpoint_dir,
                            hvd_checkpoint.model_state(model, opt), epoch)
        if rank == 0:
            print(f"epoch {epoch}: loss={logs['loss']:.4f} "
                  f"lr={logs.get('lr', float('nan')):.5f}")
    if rank == 0 and seconds:
        line = (f"{images / seconds:.1f} images/sec per rank over "
                f"{images // args.batch_size} steps")
        if dev.type == "cuda":
            line += (f", peak memory "
                     f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        print(line)
    return epoch_losses


if __name__ == "__main__":
    main()
