"""Pipeline-parallel transformer, the port's twin of
``examples/jax_pipeline_transformer.py``: GPipe stages on a ``pp`` mesh.

The depth of a transformer LM is partitioned across GPUs: each one owns a
:class:`~horovod_tpu_torch.models.BlockStack` of ``depth_per_stage``
blocks (drawn from a seed folded with its stage index) and microbatches
stream through the stages (:mod:`horovod_tpu_torch.parallel.pipeline`).
The token embedding and LM head stay replicated outside the pipeline:
every GPU computes the same loss and the same gradients for them.  The
JAX example runs its steps as one ``lax.scan`` inside one program; here
they are a Python loop of steps.

Usage:  python -m horovod_tpu_torch.examples.pipeline_transformer --steps 40
        (stages = number of GPUs: python -m horovod_tpu_torch.run -np 4 --
        python -m horovod_tpu_torch.examples.pipeline_transformer)
"""

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import BlockStack
from horovod_tpu_torch.models.layers import Dense, Embed, LayerNorm
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.parallel.pipeline import (microbatch, pipeline_apply,
                                                 stage_params_init,
                                                 unmicrobatch)


class EmbedHead(nn.Module):
    """The replicated ends of the LM: token + position embedding, final
    LayerNorm and head (f32, the JAX example's names)."""

    def __init__(self, vocab: int, dim: int, max_len: int = 2048, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(seed)
        f32 = torch.float32
        self.tok_emb = Embed(vocab, dim, dtype=f32, device=device, gen=gen)
        self.pos_emb = Embed(max_len, dim, dtype=f32, device=device, gen=gen)
        self.ln_f = LayerNorm(dim, dtype=f32, device=device)
        self.head = Dense(dim, vocab, use_bias=False, dtype=f32,
                          device=device, gen=gen)

    def embed(self, tokens):
        T = tokens.shape[1]
        return (self.tok_emb(tokens)
                + self.pos_emb(torch.arange(T, device=tokens.device))[None])

    def logits(self, x):
        return self.head(self.ln_f(x))


def make_data(vocab: int, rows: int, seq_len: int):
    """The JAX example's tokens: (inputs, labels), int32, ``rows`` x
    ``seq_len``."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, vocab, (rows, seq_len + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def main(argv=None, device: str = "cuda"):
    """Train and return the losses; ``device="cpu"`` runs on the CPU over
    gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--depth-per-stage", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--microbatches", type=int, default=0,
                   help="default: 2x stages")
    p.add_argument("--lr", type=float, default=1e-2)
    args = p.parse_args(argv)

    hvd.init(device=device)
    S = hvd.size()
    mesh = build_mesh(hvd.get_topology(), (S,), ("pp",))
    dev = hvd.local_devices()[0]
    M = args.microbatches or 2 * S
    mb = 2

    ends = EmbedHead(args.vocab, args.dim, seed=0, device=dev)
    # One BlockStack per pp GPU, distinct parameters per stage.
    stage = stage_params_init(
        lambda seed: BlockStack(args.dim, args.heads, args.depth_per_stage,
                                dtype=torch.float32, seed=seed,
                                device=dev), 1, mesh=mesh)
    opt = torch.optim.Adam(list(ends.parameters())
                           + list(stage.parameters()), lr=args.lr)
    x, y = (torch.from_numpy(a).long().to(dev)
            for a in make_data(args.vocab, M * mb, args.seq_len))

    def loss_of():
        h = ends.embed(x)
        h = unmicrobatch(pipeline_apply(lambda m, a: m(a), stage,
                                        microbatch(h, M), mesh=mesh))
        logits = ends.logits(h)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))

    losses = []
    for _ in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    if hvd.rank() == 0:
        print(f"pipeline stages={S} microbatches={M} "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
