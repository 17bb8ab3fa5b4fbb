"""Synthetic benchmark, the port's twin of
``examples/jax_synthetic_benchmark.py``: synthetic images, the full
training step, img/sec mean +- 1.96 sigma per rank and in total (the
reference's ``examples/pytorch_synthetic_benchmark.py:93-110``).

``--no-fusion`` reduces the gradients with one collective per tensor
(``make_train_step(fuse=False)``), the counterpart of
``HOROVOD_FUSION_THRESHOLD=0``.

Usage:  python -m horovod_tpu_torch.examples.synthetic_benchmark
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.synthetic_benchmark)
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet50, ResNet101, ResNet152
from horovod_tpu_torch.spmd import make_train_step

MODELS = {"resnet50": ResNet50, "resnet101": ResNet101,
          "resnet152": ResNet152}


def loss_fn(model, data):
    images, labels = data
    return F.cross_entropy(model(images), labels)


def main(argv=None, device: str = "cuda"):
    """Run the benchmark and return the img/sec of each timed iteration
    per rank; ``device="cpu"`` runs on the CPU over gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50", choices=sorted(MODELS))
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-rank batch size (reference default 32)")
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--no-fusion", action="store_true",
                   help="one collective per gradient tensor (fusion off)")
    args = p.parse_args(argv)

    hvd.init(device=device)
    n = hvd.size()
    dev = (torch.device("cpu") if device == "cpu"
           else torch.device("cuda", hvd.local_rank()))
    batch = args.batch_size * n

    model = MODELS[args.model](num_classes=1000, dtype=torch.bfloat16,
                               seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(hvd.rank())
    # This rank's rows of the global batch.
    images = torch.randn(args.batch_size, args.image_size, args.image_size,
                         3, generator=gen, device=dev, dtype=torch.bfloat16)
    labels = torch.zeros(args.batch_size, dtype=torch.long, device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt, sync_aux_state=True,
                           fuse=not args.no_fusion)
    data = (images, labels)

    def run_once():
        for _ in range(args.num_batches_per_iter):
            loss = step(data)
        loss.item()   # host read = hard sync

    print(f"Model: {args.model}, batch size (per rank): {args.batch_size}, "
          f"ranks: {n}, fusion: {not args.no_fusion}")
    for _ in range(max(1, args.num_warmup_batches //
                       args.num_batches_per_iter)):
        run_once()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        run_once()
        dt = time.perf_counter() - t0
        ips = batch * args.num_batches_per_iter / dt
        print(f"Iter #{i}: {ips:.1f} img/sec total")
        img_secs.append(ips / n)

    # Reporting format parity: mean +- 1.96 sigma per rank and in total
    # (reference pytorch_synthetic_benchmark.py:93-110).
    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    print(f"Img/sec per rank: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
    print(f"Total img/sec on {n} rank(s): {n * img_sec_mean:.1f} "
          f"+-{n * img_sec_conf:.1f}")
    return img_secs


if __name__ == "__main__":
    main()
