"""Torch-only workers of ``test_torch_process_sets.py`` and
``test_torch_publish.py``: one spawned process per rank (the spawner of
``_torch_eager_worker``), the eager plane over the native control plane,
and the process sets of ``HOROVOD_TPU_PROCESS_SETS``.  Kept apart from the
test files so that a spawned worker imports PyTorch and the port, not
JAX."""

import numpy as np
import torch

# Two tenants of two ranks each, a set across the fake hosts A, A, B, B,
# and one over the whole world that the job reconfigures.
SETS = "tenantA:0,1;tenantB:2,3;cross:1,2;wide:0,1,2,3"
HOSTS = ("A", "A", "B", "B")
TENANTS = ("tenantA", "tenantB")
# (case, request kind, dtype, average, set-local root): every tenant runs
# every case under the same tensor names.
CASES = (("sum", "allreduce", "float32", False, -1),
         ("avg", "allreduce", "float32", True, -1),
         ("iavg", "allreduce", "int32", True, -1),
         ("hsum", "allreduce", "float16", False, -1),
         ("gather", "allgather", "float32", False, -1),
         ("bcast0", "broadcast", "float64", False, 0),
         ("bcast1", "broadcast", "int64", False, 1))

# The publish drill: the world trains a small TransformerLM while rank 0
# commits the parameters every CKPT_EVERY steps and ranks 2 and 3 poll
# the publisher of set ``serve`` between steps.
SERVE = "serve:2,3"
LM_CFG = dict(vocab=256, dim=64, depth=2, num_heads=2, max_len=16,
              attn="full")
STEPS, CKPT_EVERY = 8, 2


def contribution(tenant: int, local_rank: int, case: str) -> np.ndarray:
    """Seeded values of one member of one tenant, any process can
    recompute them."""
    rng = np.random.default_rng(
        [tenant, local_rank, [c[0] for c in CASES].index(case)])
    if case == "iavg":
        return rng.integers(-50, 50, size=7).astype(np.int32)
    if case == "hsum":
        return (rng.standard_normal(9) * 3).astype(np.float16)
    if case == "gather":
        return rng.standard_normal((local_rank + 1, 3)).astype(np.float32)
    if case == "bcast0":
        return rng.standard_normal(4)
    if case == "bcast1":
        return rng.integers(-10 ** 9, 10 ** 9, size=4)
    return (rng.standard_normal((5, 3)) * 5).astype(np.float32)


def _counters(hvd) -> dict:
    return {k: v for k, v in hvd.metrics()["counters"].items()
            if "#process_set=" in k}


def tenant_cases(hvd, rank, n, report):
    """Both tenants at once, the same names: every case issued async, then
    waited for; the sets' host rule; a per-set reconfigure."""
    import torch.distributed as dist
    from horovod_tpu_torch import process_set
    tenant = rank // 2
    ps = hvd.process_set_by_name(TENANTS[tenant])
    local = ps.rank()
    ops = {"allreduce": hvd.allreduce_async, "allgather": hvd.allgather_async}

    def run_cases(tag):
        handles = {}
        for case, kind, _, average, root in CASES:
            x = torch.from_numpy(contribution(tenant, local, case))
            name = f"t.{case}.{tag}"
            if kind == "broadcast":
                h = hvd.broadcast_async(x, root, name=name, process_set=ps)
            elif kind == "allreduce":
                h = ops[kind](x, average=average, name=name,
                              process_set=ps.name)
            else:
                h = ops[kind](x, name=name, process_set=ps.id)
            handles[case] = h
        return {case: hvd.synchronize(h).numpy()
                for case, h in handles.items()}

    report(("tenant", TENANTS[tenant], local, run_cases("a")))
    report(("world", hvd.allreduce(torch.full((3,), float(rank)),
                                   average=False, name="w").numpy()))
    hm = hvd.controller().handle_manager
    h = hvd.allreduce_async(torch.ones(2), name="x.cross",
                            process_set="cross")
    status, _ = hm.wait(h, 30)
    hm.release(h)
    report(("cross", int(status.type), status.reason))
    report(("counters", _counters(hvd)))
    # Per-set elastic: every process drops rank 3 from ``wide``, and the
    # world makes its group over the remaining members.
    wide = hvd.process_set_by_name("wide")
    gen = hvd.reconfigure_process_set(wide, 3)
    got = None
    if rank < 3:
        t = torch.full((2,), float(rank + 1))
        dist.all_reduce(t, group=process_set._groups[wide.id][0])
        got = t.numpy()
    report(("reconfigured", gen, wide.ranks, wide.id in process_set._groups,
            got, [hvd.process_set_by_name(t).generation for t in TENANTS]))
    report(("tenant_after", run_cases("b")))
    report(("world_after", hvd.allreduce(torch.full((3,), float(rank)),
                                         average=False, name="w2").numpy()))
    if rank == 0:
        h = hvd.allreduce_async(torch.ones(2), name="x.wide",
                                process_set=wide)
        status, _ = hm.wait(h, 30)
        hm.release(h)
        report(("wide", int(status.type), status.reason))
    # Drain: nobody leaves while a peer still negotiates.
    hvd.allreduce(torch.ones(1), name="drain")


def lm_tokens(rank: int, step: int) -> torch.Tensor:
    rng = np.random.default_rng([7, rank, step])
    return torch.from_numpy(rng.integers(
        0, LM_CFG["vocab"], size=(2, LM_CFG["max_len"] + 1))).long()


def _leg(hvd, rank, directory, publishing):
    """One leg of the drill: STEPS steps of make_train_step on a model
    made from one seed; returns the losses and, on the serving ranks,
    what each publish delivered."""
    from horovod_tpu_torch import checkpoint, ckpt_stream
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.publish import ParameterPublisher
    from horovod_tpu_torch.spmd import make_train_step
    model = TransformerLM(**LM_CFG, dtype=torch.float32,
                          head_dtype=torch.float32, ln_dtype=torch.float32,
                          seed=3, device="cpu")

    def loss_fn(m, batch):
        logits = m(batch[:, :-1])
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, LM_CFG["vocab"]), batch[:, 1:].reshape(-1))

    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    step = make_train_step(model, loss_fn, opt)
    writer = (ckpt_stream.AsyncCheckpointer(directory)
              if publishing and rank == 0 else None)
    pub = (ParameterPublisher(directory, "serve")
           if publishing and rank >= 2 else None)
    losses, published = [], []
    for i in range(STEPS):
        losses.append(float(step(lm_tokens(rank, i))))
        if writer is not None and i % CKPT_EVERY == CKPT_EVERY - 1:
            # Committed before this rank's next step: the serving ranks'
            # poll after that step sees it.
            writer.snapshot(checkpoint.model_state(model), i // CKPT_EVERY)
            writer.flush()
        if pub is not None:
            out = pub.poll()
            if out is not None:
                published.append((pub.last_published_epoch, out))
    if writer is not None:
        writer.close()
    # Every commit is on disk before the serving ranks' last poll.
    hvd.allreduce(torch.ones(1), name=f"leg.{publishing}.end")
    if pub is not None:
        out = pub.poll()
        if out is not None:
            published.append((pub.last_published_epoch, out))
    # And nobody leaves before the serving ranks' last poll is done.
    hvd.allreduce(torch.ones(1), name=f"leg.{publishing}.drained")
    return losses, published


def publish_drill(hvd, rank, n, report):
    import os
    directory = os.environ["TEST_PUBLISH_DIR"]
    base, _ = _leg(hvd, rank, directory, False)
    losses, published = _leg(hvd, rank, directory, True)
    snap = hvd.metrics()
    report(("drill", base, losses, published,
            {k: v for k, v in snap["counters"].items()
             if k.startswith("publish.")},
            sorted(k for k in list(snap["gauges"]) + list(snap["histograms"])
                   if k.startswith("publish."))))
