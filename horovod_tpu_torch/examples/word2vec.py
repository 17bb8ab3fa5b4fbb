"""word2vec skip-gram, the port's twin of ``examples/jax_word2vec.py``:
the embedding gradients take the **sparse allgather route** instead of a
dense allreduce over the whole vocabulary.

The forward gathers only the touched rows (``F.embedding(...,
sparse=True)``), so each table's gradient is a sparse COO tensor of
those rows: the centers' rows for ``emb_in``; for ``emb_out`` the context
rows and the negative rows, one slice set with duplicate indices summed
by the consumer, the IndexedSlices contract.  The stock
``DistributedOptimizer`` takes them as ``sparse.IndexedSlices`` and
all-gathers rows and indices over the ranks (cost grows with the batch,
not the vocabulary), then scatters them into the dense table for the SGD
update; ``sparse_as_dense=True`` would densify them before a plain
allreduce instead.  The route counts what it reduced
(``sparse.allreduces#route=spmd`` in ``hvd.metrics()``), printed at the
end beside the first and final losses unrounded.

Corpus: the JAX example's synthetic Zipf-distributed token stream, and
its skip-gram pairs and negatives from the same ``RandomState`` draws.

Usage:  python -m horovod_tpu_torch.examples.word2vec --steps 200
        (several GPUs: python -m horovod_tpu_torch.run -np 4 -- python -m
        horovod_tpu_torch.examples.word2vec)
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import injit
from horovod_tpu_torch.spmd import shard_batch


def make_corpus(vocab, n_tokens, seed=0):
    rng = np.random.RandomState(seed)
    # Zipf-ish unigram distribution like natural text.
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)


def skipgram_pairs(corpus, window, batch, rng):
    centers = rng.randint(window, len(corpus) - window, batch)
    offs = rng.randint(1, window + 1, batch) * rng.choice([-1, 1], batch)
    return corpus[centers], corpus[centers + offs]


def pair_stream(args, global_batch: int):
    """Each step's (centers, contexts, negatives) of the global batch: the
    JAX example's corpus, and its draws in its order from its seeding,
    kept as it is (Python salts string hashes per process, so the pairs
    differ from run to run unless PYTHONHASHSEED is set)."""
    rng = np.random.RandomState(hash("w2v") % (2 ** 31))
    corpus = make_corpus(args.vocab, 200_000)
    for _ in range(args.steps):
        centers, contexts = skipgram_pairs(corpus, args.window, global_batch,
                                           rng)
        negs = rng.randint(0, args.vocab,
                           (global_batch, args.neg)).astype(np.int32)
        yield centers, contexts, negs


def init_tables(vocab: int, dim: int, device):
    """``emb_in`` and ``emb_out``, uniform in [-0.5 / dim, 0.5 / dim)
    from seed 0, as leaf tensors that take gradients."""
    gen = torch.Generator(device=device).manual_seed(0)
    return [((torch.rand((vocab, dim), generator=gen, device=device) - 0.5)
             / dim).requires_grad_() for _ in range(2)]


def skipgram_loss(emb_in, emb_out, centers, contexts, negs):
    """The mean over pairs of softplus(-pos) + sum of softplus(neg), from
    the touched rows only.  Both gathers are sparse: ``emb_out``'s rows
    are the contexts' and the negatives' in one gather, so its gradient is
    one slice set."""
    b, k = negs.shape
    c = F.embedding(centers, emb_in, sparse=True)
    out = F.embedding(torch.cat([contexts, negs.reshape(-1)]), emb_out,
                      sparse=True)
    ctx, neg = out[:b], out[b:].reshape(b, k, -1)
    pos_logit = (c * ctx).sum(-1)
    neg_logit = torch.einsum("bd,bkd->bk", c, neg)
    return (F.softplus(-pos_logit) + F.softplus(neg_logit).sum(-1)).mean()


def main(argv=None, device: str = "cuda"):
    """Train and return (first loss, final loss), each averaged over the
    ranks; ``device="cpu"`` runs on the CPU over gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=5000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=128,
                   help="per-rank batch size")
    p.add_argument("--neg", type=int, default=8,
                   help="negative samples per pair (NCE-style)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.5)
    args = p.parse_args(argv)

    hvd.init(device=device)
    n, rank = hvd.size(), hvd.rank()
    dev = hvd.local_devices()[0]
    global_batch = args.batch_size * n

    emb_in, emb_out = init_tables(args.vocab, args.dim, dev)
    # Step 4 of the recipe: all ranks start from identical tables.
    hvd.broadcast_parameters([emb_in, emb_out], root_rank=0)
    # The stock wrapper: sparse gradients take the allgather route inside
    # its step.
    opt = hvd.DistributedOptimizer(torch.optim.SGD([emb_in, emb_out],
                                                   lr=args.lr))

    first = loss = None
    t0 = time.perf_counter()
    for i, batch in enumerate(pair_stream(args, global_batch)):
        centers, contexts, negs = (x.long() for x in shard_batch(
            tuple(torch.from_numpy(a) for a in batch)))
        opt.zero_grad()
        loss = skipgram_loss(emb_in, emb_out, centers, contexts, negs)
        loss.backward()
        opt.step()
        if i % 50 == 0:
            mean = float(injit.allreduce(loss.detach(), average=True))
            first = mean if first is None else first
            if rank == 0:
                print(f"step {i}: loss={mean:.4f}")
    final = float(injit.allreduce(loss.detach(), average=True))
    dt = time.perf_counter() - t0
    if rank == 0:
        print(f"{args.steps} steps in {dt:.2f}s "
              f"({args.steps * global_batch / dt:.0f} pairs/sec); "
              f"final loss {final:.4f}")
        counters = hvd.metrics()["counters"]
        print(f"sparse route: "
              f"{counters.get('sparse.allreduces#route=spmd', 0)} slice "
              f"sets, {counters.get('sparse.rows#route=spmd', 0)} rows")
        print(f"losses unrounded: first {first!r}, final {final!r}")
    return first, final


if __name__ == "__main__":
    main()
