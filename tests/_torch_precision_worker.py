"""Inputs and the torch-side worker of ``test_torch_precision.py``.

The inputs are numpy only, so that the test process makes the same ones
for the JAX package; the worker imports PyTorch and the port, never JAX,
and runs in the processes ``_torch_eager_worker.spawn`` starts: two
ranks, one gloo world group, the negotiated plane over the native
coordinator, the precision autopilot armed (``JOB_ENV``)."""

import numpy as np

N = 2
TICKS = 2
JOB_ENV = {"HOROVOD_TPU_PRECISION": "auto",
           "HOROVOD_TPU_PRECISION_TICKS": str(TICKS),
           "HOROVOD_TPU_CONTROL_TIMEOUT_S": "60",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2",
           "HOROVOD_TPU_FUSION_THRESHOLD": "0",
           "HOROVOD_TPU_INJIT_PALLAS": "0",
           "HOROVOD_TPU_BUCKET_BYTES": str(1 << 20)}
# The hosts the two ranks fake, so that hierarchical_mesh() is (dcn 2,
# ici 1).
FINGERPRINTS = ["host-a", "host-b"]

# SPMD leaves (reduce_gradients' list order = the dict's key order) and
# the reports each leaf's bucket gets: 4 healthy ones climb to int8, 2 to
# bf16 (TICKS 2), none leaves fp32.  "c" is 1-D, so its int8 rung goes
# raw.
LEAVES = {"a": (64, 256), "b": (4, 64), "c": (16,), "d": (32, 32)}
REPORTS = {"a": 4, "b": 2, "c": 4, "d": 0}
HEALTHY = 0.001
# Values that survive f32 and round in bf16.
OFFSET = 1.0 + 2.0 ** -12


def leaf_grads(rank: int) -> dict:
    """Rank ``rank``'s own gradients (they vary over the ranks)."""
    rng = np.random.RandomState(31 + rank)
    return {k: (rng.randn(*shape) + OFFSET * (rank + 1)).astype(np.float32)
            for k, shape in LEAVES.items()}


def spmd_names(prefix: str, keyed: bool) -> dict:
    """Each leaf's bucket name: ``prefix['k']`` for a dict, ``prefix[i]``
    for reduce_gradients' list."""
    return {k: f"{prefix}['{k}']" if keyed else f"{prefix}[{i}]"
            for i, k in enumerate(LEAVES)}


def warm(pilot, names: dict) -> None:
    for k, n in REPORTS.items():
        for _ in range(n):
            pilot.note_residual(names[k], HEALTHY)


# The DistributedOptimizer case: LEAVES as the parameters of a module,
# whose parameter names are the flax paths of the same leaves in
# opt_tree's tree.
OPT_PATHS = {"a": "blk.a", "b": "blk.b", "c": "c", "d": "d"}


def opt_names(prefix: str) -> dict:
    """Each leaf's bucket name in opt_tree's tree (keystr of its path)."""
    return {k: prefix + "".join(f"['{part}']" for part in path.split("."))
            for k, path in OPT_PATHS.items()}


def opt_tree(leaves: dict) -> dict:
    return {"blk": {"a": leaves["a"], "b": leaves["b"]},
            "c": leaves["c"], "d": leaves["d"]}


# The small TransformerLM of the make_train_step case, and the rungs its
# buckets are warmed to (flax paths; the rest stay fp32).
LM_CFG = dict(vocab=512, dim=128, depth=1, num_heads=2, max_len=32,
              attn="full")
LM_LR, LM_MOMENTUM = 0.01, 0.9
LM_REPORTS = {"grads['block_0']['attn']['qkv']['kernel']": 4,
              "grads['tok_emb']['embedding']": 4,
              "grads['head']['kernel']": 2,
              "grads['block_0']['fc1']['kernel']": 2,
              "grads['block_0']['ln1']['scale']": 4}


def lm_tokens() -> np.ndarray:
    """The global batch; rank r trains on rows [2r, 2r + 2)."""
    return np.random.RandomState(5).randint(
        0, LM_CFG["vocab"], (2 * N, LM_CFG["max_len"] + 1)).astype(np.int32)


# The eager leaves: one bucket under overlap (BUCKET_BYTES), 2-D and over
# the int8 floor (64 KiB as f32) together.
EAGER = {"w": (128, 160), "b": (160,), "h": (16, 8)}
EAGER_STEPS = 4


def eager_grads(rank: int, step: int) -> dict:
    rng = np.random.RandomState(1000 * step + rank)
    return {k: rng.randn(*shape).astype(np.float32)
            for k, shape in EAGER.items()}


# --------------------------------------------------------------- worker

def precision_cases(hvd, rank, n, report):
    import torch
    from horovod_tpu_torch import basics, cpp_core, precision
    from horovod_tpu_torch.core import ResponseType
    from horovod_tpu_torch.spmd import reduce_gradients

    pilot = precision.get_autopilot()
    report(("armed", pilot.enabled))
    grads = {k: torch.from_numpy(v) for k, v in leaf_grads(rank).items()}
    warm(pilot, spmd_names("grads", keyed=False))
    warm(pilot, spmd_names("DistributedOptimizer.grads", keyed=True))
    report(("rg", [r.numpy() for r in reduce_gradients(
        list(grads.values()), compression="auto")]))
    report(("ag", {k: v.numpy() for k, v in hvd.allreduce_gradients(
        grads, compression="auto").items()}))
    report(("opt", _opt_step(hvd, grads, pilot)))
    mesh = hvd.hierarchical_mesh()
    report(("mesh", (mesh.dcn_size, mesh.ici_size), [
        r.numpy() for r in reduce_gradients(list(grads.values()),
                                            compression="auto",
                                            mesh=mesh)]))
    report(("lm",) + _lm_step(hvd, rank, pilot))

    # The eager branch under overlap: record every allreduce response's
    # stamp, and what the native coordinator's ladder published.
    ex = basics.controller()._executor
    plain = ex.execute
    seen = []

    def execute(resp, entries):
        if resp.response_type == ResponseType.ALLREDUCE:
            seen.append((tuple(resp.tensor_names), resp.wire_dtype))
        return plain(resp, entries)

    ex.execute = execute
    model = torch.nn.Module()
    for k, shape in EAGER.items():
        model.register_parameter(k, torch.nn.Parameter(torch.zeros(shape)))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5), eager=True,
        overlap=True, compression="auto")
    steps = []
    for s in range(EAGER_STEPS):
        g = {k: torch.from_numpy(v) for k, v in eager_grads(rank, s).items()}
        opt.zero_grad()
        # Under overlap the bucket is submitted from the backward's hooks,
        # and its response may execute before the backward returns.
        stamps = len(seen)
        sum((getattr(model, k) * v).sum() for k, v in g.items()).backward()
        opt.step()
        red = {k: getattr(model, k).grad.numpy().copy() for k in EAGER}
        # The bucket again, alone and statically on the wire the
        # coordinator stamped: the host ring must give the same bits.
        wire = [w for names, w in seen[stamps:]
                if names == ("DistributedOptimizer.grads.bucket0",)]
        flat = torch.cat([v.reshape(-1) for v in g.values()])
        static = hvd.allreduce(flat, name=f"static.{s}",
                               compression=wire[0] if wire else "none")
        steps.append((red, wire, static.numpy()))
    ex.execute = plain
    report(("eager", steps, seen))
    nonov = hvd.allreduce_gradients(
        {k: torch.from_numpy(v) for k, v in eager_grads(rank, 9).items()},
        eager=True, compression="auto", name_prefix="plain")
    report(("eager_leaves", {k: v.numpy() for k, v in nonov.items()}))
    # One more negotiation: both ranks' frames since their last reports
    # have reached the coordinator, whose native ladder publishes its
    # gauges in its process.
    hvd.allreduce(torch.ones(1), name="flush")
    gauges = cpp_core.metrics_snapshot().get("gauges", {})
    report(("coordinator", {k: v for k, v in gauges.items()
                            if k.startswith("precision.")}))


def _opt_step(hvd, grads, pilot):
    """One SGD step (lr 1, from ones) of DistributedOptimizer's SPMD
    branch under "auto", its buckets named by ``named_parameters``; the
    parameters after it (one minus the reduced gradients)."""
    import torch
    warm(pilot, opt_names("DistributedOptimizer.grads"))
    model = torch.nn.Module()
    model.blk = torch.nn.Module()
    for k, path in OPT_PATHS.items():
        owner = model.blk if path.startswith("blk.") else model
        owner.register_parameter(path.split(".")[-1], torch.nn.Parameter(
            torch.ones(LEAVES[k])))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1.0), compression="auto",
        named_parameters=model.named_parameters())
    params = dict(model.named_parameters())
    for k, path in OPT_PATHS.items():
        params[path].grad = grads[k].clone()
    opt.step()
    return {k: params[path].detach().numpy().copy()
            for k, path in OPT_PATHS.items()}


def _lm_step(hvd, rank, pilot):
    """One step of make_train_step(compression="auto") on this rank's
    rows of the global batch, weights from the test's flax tree."""
    import pickle
    import os
    import torch
    from horovod_tpu_torch import weights
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    from horovod_tpu_torch.spmd import make_train_step

    with open(os.environ["TEST_LM_PARAMS"], "rb") as f:
        params = pickle.load(f)
    model = TransformerLM(**LM_CFG, dtype=torch.float32,
                          head_dtype=torch.float32, ln_dtype=torch.float32,
                          device="cpu")
    weights.load_flax_params(model, params)
    for name, n in LM_REPORTS.items():
        for _ in range(n):
            pilot.note_residual(name, HEALTHY)

    def loss_fn(m, batch):
        h = m(batch[:, :-1], return_hidden=True)
        return fused_softmax_xent(h.reshape(-1, LM_CFG["dim"]),
                                  m.head.kernel,
                                  batch[:, 1:].reshape(-1)).mean()

    opt = torch.optim.SGD(model.parameters(), lr=LM_LR,
                          momentum=LM_MOMENTUM)
    step = make_train_step(model, loss_fn, opt, compression="auto")
    tokens = torch.from_numpy(lm_tokens()[2 * rank:2 * rank + 2]).long()
    loss = step(tokens)
    return (float(loss), dict(step.route), step.rebuilds,
            {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()})
