"""Inputs and the torch-side worker of ``test_torch_eager_optimizer.py``.

The inputs are numpy only, so that the JAX package's worker (a separate
process, see the test file) makes the same ones; the worker imports
PyTorch and the port, never JAX, and runs in processes spawned by
``_torch_eager_worker.spawn``."""

import numpy as np

# Leaves in JAX's tree-flatten order (sorted keys): f32 of several sizes,
# one fp16, one 2-D leaf over the int8 floor (64 KiB as f32).  Under
# BUCKET_BYTES the overlapped step packs [a, b] into one bucket; c and e
# are larger than the bound and ride alone.
SHAPES = {"a": ((60,), np.float32), "b": ((7, 5), np.float32),
          "c": ((64, 300), np.float32), "d": ((16,), np.float16),
          "e": ((300,), np.float32)}
BUCKET_BYTES = 1024
# A power of two: ``-lr * trace`` is exact, so optax's product-then-sum
# and torch's ``p.add_(buf, alpha=-lr)`` round the same way.
LR, MOMENTUM = 0.125, 0.9
STEPS = 2
CONFIGS = [(comp, overlap) for comp in ("none", "fp16", "int8")
           for overlap in (False, True)]


def params0() -> dict:
    rng = np.random.RandomState(21)
    return {k: rng.randn(*shape).astype(dt)
            for k, (shape, dt) in SHAPES.items()}


def grads(rank: int, step: int) -> dict:
    """Rank ``rank``'s gradients of step ``step``, over several decades so
    that the int8 blocks differ in scale."""
    rng = np.random.RandomState(100 * step + rank + 7)
    return {k: (rng.randn(*shape) * np.exp(rng.uniform(-2, 2, shape))
                ).astype(dt) for k, (shape, dt) in SHAPES.items()}


# Sparse cases: an nn.Embedding(ROWS, DIM, sparse=True) looked up at
# ragged, repeating ids per rank; integer-valued weights of the loss make
# every gradient row an integer, so that all routes are exact.
ROWS, DIM = 12, 4
SPARSE_IDS = {0: [1, 3, 3], 1: [0, 3, 5, 7, 7]}
EQUAL_IDS = {0: [2, 4, 4], 1: [4, 9, 11]}


def _sparse_model(torch, ids, weight):
    emb = torch.nn.Embedding(ROWS, DIM, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.arange(ROWS * DIM, dtype=torch.float32)
                         .reshape(ROWS, DIM) / 8)
    return emb, lambda: (emb(torch.tensor(ids)) * weight).sum()


def _loss_weight(torch, rank, n_ids):
    return torch.arange(n_ids * DIM, dtype=torch.float32).reshape(
        n_ids, DIM) % 5 + rank


def eager_opt_cases(hvd, rank, n, report):
    import torch

    for comp, overlap in CONFIGS:
        tree = {k: torch.from_numpy(v) for k, v in grads(rank, 0).items()}
        red = hvd.allreduce_gradients(tree, eager=True, compression=comp,
                                      overlap=overlap)
        report(("grads", comp, overlap,
                {k: v.numpy() for k, v in red.items()}))
        report(("dopt", comp, overlap) + _dopt_steps(hvd, rank, comp,
                                                     overlap))
    _sparse_cases(hvd, rank, report)
    _metric_average(hvd, rank, report)
    _unused_parameter(hvd, rank, report)


def _dopt_steps(hvd, rank, comp, overlap):
    """Two steps of ``DistributedOptimizer(SGD momentum, eager=True)`` on
    this rank's gradients, made by backward so that the overlap hooks
    fire.  Returns (per step {name: (param, momentum, residual, reduced
    gradient)}, per step the buckets the hooks issued before step())."""
    import torch
    model = torch.nn.Module()
    for k, v in params0().items():
        model.register_parameter(k, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        eager=True, compression=comp, error_feedback=comp == "int8",
        overlap=overlap)
    steps, early = [], []
    for s in range(STEPS):
        g = {k: torch.from_numpy(v) for k, v in grads(rank, s).items()}
        opt.zero_grad()
        sum((p * g[k]).sum().float()
            for k, p in model.named_parameters()).backward()
        red = opt._reduction
        early.append(len(red._issue_seq) if red is not None else 0)
        opt.step()
        out = {}
        for k, p in model.named_parameters():
            st = opt.state[p]
            res = st.get("residual")
            out[k] = (p.detach().numpy().copy(),
                      st["momentum_buffer"].numpy().copy(),
                      None if res is None else res.numpy().copy(),
                      p.grad.numpy().copy())
        steps.append(out)
    return steps, early


def _sparse_cases(hvd, rank, report):
    import torch
    from horovod_tpu_torch import sparse

    # The negotiated allgather, ragged.
    ids = SPARSE_IDS[rank]
    emb, loss = _sparse_model(torch, ids, _loss_weight(torch, rank,
                                                       len(ids)))
    loss().backward()
    slices = sparse.IndexedSlices.from_sparse(emb.weight.grad)
    got = sparse.allreduce_eager(slices, name="sp.ragged")
    report(("sparse_eager", got.values.numpy(), got.indices.numpy()))
    # The SPMD branch: equal row counts gather; unequal ones raise on
    # every rank.
    ids = EQUAL_IDS[rank]
    emb, loss = _sparse_model(torch, ids, _loss_weight(torch, rank,
                                                       len(ids)))
    loss().backward()
    eq = sparse.IndexedSlices.from_sparse(emb.weight.grad)
    spmd = sparse.allreduce(eq)
    report(("sparse_spmd", eq.values.numpy(), eq.indices.numpy(),
            spmd.values.numpy(), spmd.indices.numpy()))
    try:
        sparse.allreduce(slices)
        report(("sparse_unequal", None))
    except ValueError as e:
        report(("sparse_unequal", str(e)))
    # Both branches of the optimizer take sparse gradients, and agree with
    # densifying first.
    finals = {}
    for label, ids, kw in (
            ("eager", SPARSE_IDS, dict(eager=True)),
            ("eager_overlap", SPARSE_IDS, dict(eager=True, overlap=True)),
            ("dense", SPARSE_IDS, dict(sparse_as_dense=True)),
            ("spmd", EQUAL_IDS, {}),
            ("spmd_dense", EQUAL_IDS, dict(sparse_as_dense=True))):
        emb, loss = _sparse_model(torch, ids[rank], _loss_weight(
            torch, rank, len(ids[rank])))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.5, momentum=0.5), **kw)
        for _ in range(3):
            opt.zero_grad()
            loss().backward()
            opt.step()
        finals[label] = emb.weight.detach().numpy().copy()
    report(("sparse_opt", finals))


def _metric_average(hvd, rank, report):
    from horovod_tpu_torch import callbacks
    logs = {"loss": float(rank + 1), "acc": np.asarray(0.5 * rank, np.float32),
            "count": 3 + rank, "name": "not a metric"}
    cb = callbacks.CallbackList([callbacks.MetricAverageCallback()],
                                callbacks.TrainingState())
    cb.on_epoch_end(0, logs=logs)
    report(("metric_average", logs))
    # Rank 0's parameters and optimizer state reach every rank.
    import torch
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(rank + 1.0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1 * (rank + 1))
    state = callbacks.TrainingState(params=model, opt_state=opt)
    callbacks.BroadcastGlobalVariablesCallback(0).on_train_begin(state)
    report(("broadcast", [p.detach().numpy().copy()
                          for p in model.parameters()],
            opt.param_groups[0]["lr"]))


def _unused_parameter(hvd, rank, report):
    """A parameter that no backward reaches (``zero_grad`` leaves its
    gradient None) contributes zeros, submitted by step() on every rank,
    with overlap on."""
    import torch
    torch.manual_seed(5)
    used, unused = torch.nn.Linear(8, 300), torch.nn.Linear(8, 4)
    before = unused.weight.detach().clone()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(list(used.parameters()) + list(unused.parameters()),
                        lr=0.1, momentum=0.9), eager=True, overlap=True)
    x = torch.full((2, 8), float(rank + 1))
    for _ in range(3):
        opt.zero_grad(set_to_none=True)
        used(x).sum().backward()
        opt.step()
    report(("unused", torch.equal(unused.weight.detach(), before),
            used.weight.detach().numpy().copy()))
