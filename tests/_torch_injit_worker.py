"""Torch-only workers of ``test_torch_injit.py`` and
``test_torch_subsets.py``: the in-step collectives of
``horovod_tpu_torch.ops.injit`` on a 4-rank gloo group, and a job whose
launched ranks [3, 1, 2] form a rank subset.  Kept apart from the test
files so that a spawned worker imports PyTorch and the port, not JAX."""

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import process_set
from horovod_tpu_torch.ops import injit
from horovod_tpu_torch.parallel.mesh import build_mesh


def _block(a, n, rank, axis=0):
    """Rank ``rank``'s block of the global ``a`` split ``n`` ways along
    ``axis`` (``shard_map``'s ``P("ranks")`` in_spec)."""
    return np.array_split(a, n, axis=axis)[rank]


def _grad_of(fn, x, w):
    """(fn(x), d sum(fn(x) * w) / dx) as numpy."""
    t = torch.from_numpy(x).requires_grad_(True)
    y = fn(t)
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach().numpy(), t.grad.numpy()


def injit_worker(rank, cases):
    """Each case of ``cases`` (name -> (kind, kwargs, x, w)) on this
    rank's block of ``x`` (and of ``w`` for a varying output): the
    output and the gradient of ``sum(out * w)``."""
    n = hvd.size()
    out = {"num_ranks": injit.num_ranks(), "rank_index": injit.rank_index()}
    mesh = build_mesh(hvd.get_topology(), (2, 2), ("dp", "tp"))
    for name, (kind, kw, x, w) in cases.items():
        kw = dict(kw)
        on_mesh = kw.pop("mesh", False)
        if on_mesh:
            kw["mesh"] = mesh
        per_rank = kw.pop("per_rank", False)
        xr = _block(x, n, rank)
        if kind == "allgather" and not per_rank:
            wr = w                        # the gathered value counts once
        else:
            wr = _block(w, n, rank)
        fn = getattr(injit, kind)
        if (kind == "broadcast" and kw.get("mode", "permute") == "permute"
                and isinstance(kw.get("axis_name", "ranks"), str)):
            real = dist.all_reduce

            def refuse(*a, **k):
                raise AssertionError("all_reduce in the permute forward")

            dist.all_reduce = refuse
            t = torch.from_numpy(xr).requires_grad_(True)
            try:
                y = fn(t, **kw)
            finally:
                dist.all_reduce = real
            (y * torch.from_numpy(wr)).sum().backward()
            out[name] = (y.detach().numpy(), t.grad.numpy())
            continue
        out[name] = _grad_of(lambda t: fn(t, **kw), xr, wr)
    # Integer payloads move bit for bit.
    ints = np.arange(n * 6, dtype=np.int64).reshape(n * 2, 3) * 7 + rank
    t = torch.from_numpy(ints)
    out["int"] = (injit.broadcast(t, 1).numpy(),
                  injit.broadcast(t, 1, mode="psum").numpy(),
                  injit.allgather(t, axis=1).numpy(),
                  injit.reducescatter(t).numpy(),
                  injit.alltoall(t, split_axis=0, concat_axis=1).numpy())
    try:
        injit.broadcast(torch.zeros(1), 0, mode="tree")
        out["bad_mode"] = None
    except ValueError as e:
        out["bad_mode"] = str(e)
    return out


def subset_worker(rank, init_method, ranks, sets, lr, steps, data):
    """``hvd.init(ranks=ranks)`` on launched rank ``rank``; a process
    outside the subset reports the error it raised.  A member reports its
    identity, an allreduce, ``injit.broadcast`` of a per-launch value
    from subset rank 2 (both modes), its process set's group and a few
    ``make_train_step`` steps of a linear model on its own rows of
    ``data``.  Launched without ``HOROVOD_TPU_LOCAL_RANK``: host discovery
    gives the local rank."""
    import os
    from horovod_tpu_torch.spmd import make_train_step
    os.environ.update({"HOROVOD_TPU_PROCESS_SETS": sets})
    os.environ.pop("HOROVOD_TPU_LOCAL_RANK", None)
    try:
        hvd.init(ranks, device="cpu", init_method=init_method)
    except RuntimeError as e:
        return {"error": str(e), "initialized": hvd.is_initialized(),
                "dist": dist.is_initialized()}
    me = hvd.rank()
    out = {"rank": me, "size": hvd.size(), "local_rank": hvd.local_rank(),
           "devices": [str(d) for d in hvd.devices()],
           "local_devices": [str(d) for d in hvd.local_devices()],
           "mesh": (hvd.ranks_mesh().shape, hvd.ranks_mesh().axis_names,
                    hvd.ranks_mesh().coords),
           "world": (dist.get_world_size(), dist.get_rank())}
    value = torch.full((4,), float(rank * 10 + 1))
    out["sum"] = injit.allreduce(value, average=False).numpy()
    out["bcast"] = [injit.broadcast(value, 2, mode=m).numpy()
                    for m in ("permute", "psum")]
    ps = process_set.process_set_by_name("pair")
    out["pair"] = (list(ps.ranks), ps.included(me))
    if ps.included(me):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=process_set._groups[ps.id][0])
        out["pair_sum"] = float(t)
    x, y = data
    rows = np.array_split(np.arange(len(x)), hvd.size())[me]
    model = torch.nn.Linear(x.shape[1], 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    opt = torch.optim.SGD(model.parameters(), lr=lr)

    def loss_fn(m, batch):
        return ((m(batch[0]) - batch[1]) ** 2).mean()

    step = make_train_step(model, loss_fn, opt)
    batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    out["losses"] = [float(step(batch)) for _ in range(steps)]
    out["weight"] = model.weight.detach().numpy().copy()
    try:
        hvd.allreduce(value, name="eager")
        out["eager"] = None
    except Exception as e:      # noqa: BLE001 -- its text is the result
        out["eager"] = f"{type(e).__name__}: {e}"
    return out


def examples_worker(rank, runs):
    """Each ``(name, argv)`` of ``runs``: the example twin
    ``horovod_tpu_torch.examples.<name>``'s ``main(argv, device="cpu")``
    in this group, its result and what it printed."""
    import contextlib
    import importlib
    import io
    out = []
    for name, argv in runs:
        module = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = module.main(list(argv), device="cpu")
        out.append((result, buf.getvalue()))
    return out
