"""Torch-only helpers of ``test_torch_distributed_optimizer.py``: the
inputs and the 2-process gloo worker.  Kept apart from the test file so
that a spawned worker imports PyTorch and the port, not JAX."""

import os
import traceback

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.ops import quantized_collectives as tqc
from horovod_tpu_torch.spmd import reduce_gradients

LR, MOMENTUM = 0.05, 0.9


def _ring_inputs(n):
    return np.random.RandomState(5).randn(n, 48, 128).astype(np.float32)


def _grad_steps(n):
    """Per step, per rank: {"w": (64, 256) over the int8 floor, "s": (8,
    16) under it, "b": (256,) 1-D}."""
    rng = np.random.RandomState(11)
    steps = []
    for _ in range(2):
        steps.append([{
            "w": (rng.randn(64, 256) * np.exp(rng.uniform(-3, 3, (64, 256)))
                  ).astype(np.float32),
            "s": rng.randn(8, 16).astype(np.float32),
            "b": rng.randn(256).astype(np.float32)} for _ in range(n)])
    return steps


def _params0():
    rng = np.random.RandomState(12)
    return {"w": rng.randn(64, 256).astype(np.float32),
            "s": rng.randn(8, 16).astype(np.float32),
            "b": rng.randn(256).astype(np.float32)}


class _Leaves(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _params0().items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


def _torch_dopt(rank, n, overlap, group=None):
    """Two steps of the port's wrapper on rank ``rank``'s gradients (made
    by backward, so that the overlap hooks fire); returns per step
    {name: (param, momentum trace, residual)}."""
    model = _Leaves()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        compression="int8", error_feedback=True, overlap=overlap,
        group=group)
    out = []
    for grads in _grad_steps(n):
        opt.zero_grad()
        loss = sum((getattr(model, k) * torch.from_numpy(v)).sum()
                   for k, v in grads[rank].items())
        loss.backward()
        opt.step()
        rec = {}
        for k in ("w", "s", "b"):
            p = getattr(model, k)
            st = opt.state[p]
            res = st.get("residual")
            rec[k] = (p.detach().numpy().copy(),
                      st["momentum_buffer"].numpy().copy(),
                      None if res is None else res.numpy().copy())
        out.append(rec)
    return out


_W = (32, 64)


def _rg_inputs(rank):
    rng = np.random.default_rng(40 + rank)
    return [rng.standard_normal(_W).astype(np.float32),
            rng.standard_normal(64).astype(np.float32),
            rng.standard_normal((16, 64)).astype(np.float32)]


def _gloo_worker(rank, port, results):
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "2", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1"})
        os.environ.pop("HOROVOD_TPU_INJIT_INT8_FLOOR", None)
        os.environ.pop("HOROVOD_TPU_INJIT_WIRE_DTYPE", None)
        hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{port}")
        out = {}
        x = torch.from_numpy(_ring_inputs(2)[rank])
        out["ring"] = tqc.quantized_ring_allreduce(x, average=True).numpy()
        out["ring_sum"] = tqc.quantized_ring_allreduce(x).numpy()
        out["dopt"] = {ov: _torch_dopt(rank, 2, ov) for ov in (False, True)}
        os.environ.update({"HOROVOD_TPU_INJIT_INT8_FLOOR": "0"})
        grads = [torch.from_numpy(g) for g in _rg_inputs(rank)]
        for fuse in (True, False):
            out[("rg", fuse)] = [r.numpy() for r in reduce_gradients(
                grads, compression=Compression.int8, fuse=fuse)]
        out["rg_raw"] = [r.numpy() for r in reduce_gradients(grads)]
        out.update(_broadcasts(rank))
        hvd.shutdown()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def _broadcasts(rank):
    torch.manual_seed(100 + rank)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 2))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    inner = torch.optim.Adam(model.parameters(), lr=0.01 if rank == 0
                             else 0.5, weight_decay=0)
    inner.param_groups[0]["accum_steps"] = 3 if rank == 0 else 7
    # Rank 0 steps alone, in a group of its own; rank 1 stays fresh, its
    # Adam state empty.
    solo = torch.distributed.new_group([0])
    opt = hvd.DistributedOptimizer(inner, compression="int8",
                                   error_feedback=True,
                                   group=solo if rank == 0 else None)
    if rank == 0:
        for _ in range(2):
            opt.zero_grad()
            model(torch.ones(4, 8)).pow(2).sum().backward()
            opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    sd = opt.state_dict()
    group = sd["param_groups"][0]
    return {"params": params, "opt_state": {
        i: {k: v.numpy().copy() for k, v in s.items()}
        for i, s in sd["state"].items()},
        "hyper": {k: (type(group[k]).__name__, group[k]) for k in
                  ("lr", "weight_decay", "accum_steps", "betas")}}
