"""Model-parallel training, the port's twin of
``examples/jax_model_parallel.py``: tensor parallelism on a (dp 2, tp n/2)
mesh.  Each GPU builds only its slice of the MLP's column and row kernels
(``TPMlp``: drawn from a generator folded with its ``tp`` index), and
``tp_value_and_grad`` gives exact gradients: the ``tp`` reductions are
inside the layers, the ``dp`` mean is its reduction.  The JAX example's
shape trees and ``PartitionSpec`` trees have no counterpart to build:
every rank constructs its own slice, and its optimizer state follows it.

Usage:  python -m horovod_tpu_torch.examples.model_parallel --steps 100
        (an even number of GPUs: python -m horovod_tpu_torch.run -np 4 --
        python -m horovod_tpu_torch.examples.model_parallel)
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.mesh import build_mesh, shard_generator
from horovod_tpu_torch.parallel.tensor_parallel import (TPMlp,
                                                        tp_value_and_grad)


def make_data(batch_size: int, dp: int, dim: int):
    """The JAX example's (X, Y): ``batch_size`` rows a dp shard and
    ``Y = tanh(X @ W)``.  X and W are its draws bit for bit; Y is computed
    in f32 here (XLA's CPU ``tanh`` is an approximation of its own, a few
    ulps away)."""
    rng = np.random.RandomState(0)
    x = rng.randn(batch_size * dp, dim).astype(np.float32)
    w = (rng.randn(dim, dim) * 0.5).astype(np.float32)
    return x, np.tanh(x @ w)


def main(argv=None, device: str = "cuda"):
    """Train and return the losses; ``device="cpu"`` runs on the CPU over
    gloo."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16,
                   help="per-dp-shard batch size")
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--hidden-per-chip", type=int, default=64,
                   help="MLP hidden width per tp GPU")
    p.add_argument("--lr", type=float, default=1e-2)
    args = p.parse_args(argv)

    hvd.init(device=device)
    n = hvd.size()
    if n % 2:
        raise SystemExit("needs an even number of GPUs (dp=2)")
    dp, tp = 2, n // 2
    mesh = build_mesh(hvd.get_topology(), (dp, tp), ("dp", "tp"))
    dev = hvd.local_devices()[0]
    D = args.dim
    # Each tp GPU draws its own kernel slices; the dp shards of one slice
    # draw the same.
    mlp = TPMlp(D, args.hidden_per_chip * tp, D, "tp", dtype=torch.float32,
                mesh=mesh, device=dev,
                gen=shard_generator(dev, 1, mesh.axis("tp")))
    opt = torch.optim.Adam(mlp.parameters(), lr=args.lr)

    X, Y = make_data(args.batch_size, dp, D)
    rows = slice(mesh.axis_index("dp") * args.batch_size,
                 (mesh.axis_index("dp") + 1) * args.batch_size)
    x = torch.from_numpy(X[rows]).to(dev)
    y = torch.from_numpy(Y[rows]).to(dev)

    def loss_fn(model):
        return ((model(x) - y) ** 2).mean()

    losses = []
    for _ in range(args.steps):
        loss, grads = tp_value_and_grad(loss_fn, mlp, dp_axes=("dp",),
                                        mesh=mesh)
        for name, param in mlp.named_parameters():
            param.grad = grads[name]
        opt.step()
        losses.append(float(loss))
    kernel = mlp.col.kernel
    if hvd.rank() == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        print(f"col kernel: global {(kernel.shape[0], kernel.shape[1] * tp)}"
              f", sharded (None, 'tp') over mesh {{'dp': {dp}, 'tp': {tp}}}"
              f", {tuple(kernel.shape)} on each rank")
    return losses


if __name__ == "__main__":
    main()
