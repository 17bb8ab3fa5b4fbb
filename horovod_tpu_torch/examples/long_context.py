"""Long-context LM training with sequence parallelism, the port's twin of
``examples/jax_long_context.py``: a causal transformer whose sequence
dimension is sharded across the GPUs, with attention as a K/V ring
(``--attn ring``, or ``--attn ring_zigzag`` for the causal-load-balanced
layout) or by all-to-all head re-sharding (``--attn ulysses``; with
``--attn ulysses_flash`` the local attention runs the port's flash
kernels: linear memory).

Usage:  python -m horovod_tpu_torch.examples.long_context --attn ring
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.long_context --attn ulysses_flash)
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import TransformerLM
from horovod_tpu_torch.parallel.ring_attention import zigzag_indices
from horovod_tpu_torch.spmd import make_train_step, shard_batch


def batches(args, n: int):
    """The JAX example's stream: one (inputs, labels) pair of int32
    ``(batch_size, seq_len)`` a step, permuted to the zigzag layout under
    ``--attn ring_zigzag`` (labels alike, so the mean loss is unchanged)."""
    rng = np.random.RandomState(0)
    zz = (zigzag_indices(n, args.seq_len) if args.attn == "ring_zigzag"
          else None)
    for _ in range(args.steps):
        toks = rng.randint(0, args.vocab,
                           (args.batch_size, args.seq_len + 1)).astype(
            np.int32)
        x, y = toks[:, :-1], toks[:, 1:]
        if zz is not None:
            x, y = x[:, zz], y[:, zz]
        yield x, y


def main(argv=None, device: str = "cuda"):
    """Train and return the losses; ``device="cpu"`` runs on the CPU over
    gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--attn", default="ring",
                   choices=["ring", "ring_zigzag", "ulysses",
                            "ulysses_flash"])
    p.add_argument("--seq-len", type=int, default=8192,
                   help="GLOBAL sequence length (sharded over GPUs)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="global batch size")
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-4)
    args = p.parse_args(argv)

    hvd.init(device=device)
    n = hvd.size()
    dev = hvd.local_devices()[0]
    assert args.seq_len % n == 0, "seq-len must divide across GPUs"
    if args.attn.startswith("ulysses"):
        assert args.heads % n == 0, "ulysses shards heads across GPUs"

    model = TransformerLM(
        vocab=args.vocab, dim=args.dim, depth=args.depth,
        num_heads=args.heads, max_len=args.seq_len, attn=args.attn,
        sp_axis="ranks", seed=0, device=dev)
    hvd.broadcast_parameters(model)
    # optax.adamw's defaults (weight decay 1e-4).
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                            weight_decay=1e-4)

    def loss_fn(model, batch):
        tokens, labels = batch
        logits = model(tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1))

    step = make_train_step(model, loss_fn, opt)
    losses = []
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(batches(args, n)):
        batch = shard_batch((torch.from_numpy(x).long(),
                             torch.from_numpy(y).long()), (None, "ranks"))
        loss = step(batch)
        losses.append(float(loss))
        if hvd.rank() == 0 and i % 5 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")
    if hvd.rank() == 0:
        dt = time.perf_counter() - t0
        tps = args.steps * args.batch_size * args.seq_len / dt
        print(f"{args.attn} attention, seq {args.seq_len} over {n} ranks: "
              f"{tps:.0f} tokens/sec")
    return losses


if __name__ == "__main__":
    main()
