"""Torch-only helpers of ``test_torch_train_step.py`` and
``test_torch_hierarchical.py``: process groups over gloo and their
workers.  Kept apart from the test files so that a spawned worker imports
PyTorch and the port, not JAX."""

import fcntl
import os
import pickle
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as tmp
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import weights
from horovod_tpu_torch.models import ResNet
from horovod_tpu_torch.ops import injit
from horovod_tpu_torch.parallel.hierarchical import hierarchical_allreduce
from horovod_tpu_torch.spmd import (make_eval_step, make_train_step,
                                    reduce_gradients, shard_batch)

# The small ResNet of the parity tests, and its optimizer.
SMALL = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
LR, MOMENTUM = 0.01, 0.9
# Four ranks on two fake hosts.
HOSTS = ("A", "A", "B", "B")


def once(request, tmp_path_factory, name, fn):
    """``fn()`` computed once per test session and shared, through a file,
    by every xdist worker that needs it."""
    root = tmp_path_factory.getbasetemp()
    if hasattr(request.config, "workerinput"):
        root = root.parent                 # the session's, not the worker's
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(fn()))
        return pickle.loads(path.read_bytes())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(target, n, *args, fingerprints=None):
    """Run ``target(rank, port, results, fingerprint, *args)`` in ``n``
    spawned processes of one gloo group; returns {rank: result}, each
    within 120 s."""
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(
        target, r, n, port, results,
        fingerprints[r] if fingerprints else "", args)) for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=120)
            if isinstance(out, str):
                raise AssertionError(f"rank {rank}:\n{out}")
            got[rank] = out
    except queue.Empty:
        raise AssertionError(
            f"a gloo worker gave no result within {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return got


def _entry(target, rank, n, port, results, fingerprint, args):
    try:
        env = {"HOROVOD_TPU_SIZE": str(n), "HOROVOD_TPU_RANK": str(rank),
               "HOROVOD_TPU_LOCAL_RANK": str(rank),
               "HOROVOD_TPU_LOCAL_SIZE": "1"}
        if fingerprint:
            env["HOROVOD_TPU_HOST_FINGERPRINT"] = fingerprint
        os.environ.update(env)
        for knob in ("HOROVOD_TPU_BUCKET_BYTES", "HOROVOD_TPU_OVERLAP",
                     "HOROVOD_TPU_INJIT_INT8_FLOOR",
                     "HOROVOD_TPU_INJIT_WIRE_DTYPE"):
            os.environ.pop(knob, None)
        # Tiny models: one thread each keeps the group from oversubscribing
        # the cores that the test runner's other workers share.
        torch.set_num_threads(1)
        hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{port}")
        out = target(rank, *args)
        hvd.shutdown()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


# --------------------------------------------------------------- models


def small_resnet(variables, dtype=torch.float32):
    model = ResNet(**SMALL, dtype=dtype, device="cpu")
    weights.load_flax_variables(model, variables)
    return model


def resnet_loss(model, batch):
    images, labels = batch
    return F.cross_entropy(model(images), labels)


def train(model, batches, **kw):
    """SGD-momentum steps through ``make_train_step``; returns the losses
    and the final state (parameters and buffers, numpy)."""
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    step = make_train_step(model, resnet_loss, opt, **kw)
    losses = [float(step(b)) for b in batches]
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    return losses, state


def to_batches(images, labels):
    """numpy (steps, N, H, W, 3) and (steps, N) -> a list of batches."""
    return [(torch.from_numpy(x), torch.from_numpy(y).long())
            for x, y in zip(images, labels)]


# -------------------------------------------------------- two ranks, DP


def sync_aux_worker(rank, variables, images, labels):
    """Three steps of the small ResNet on this rank's half of each global
    batch, ``sync_aux_state=True``; an eval step of the trained model and
    its loss computed locally; this rank's rows of ``shard_batch``; and
    ``sync_aux_state=False`` raising on both ranks with no parameter or
    buffer moved."""
    half = images.shape[1] // 2
    rows = slice(rank * half, (rank + 1) * half)
    batches = to_batches(images[:, rows], labels[:, rows])
    out = {}
    model = small_resnet(variables)
    out["losses"], out["state"] = train(model, batches)
    model.eval()
    with torch.no_grad():
        out["eval_local"] = float(resnet_loss(model, batches[0]))
    model.train()
    out["eval"] = float(make_eval_step(model, resnet_loss)(batches[0]))
    out["shard_rows"] = shard_batch(
        {"rows": torch.arange(images.shape[1])})["rows"].tolist()
    model = small_resnet(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    step = make_train_step(model, resnet_loss, opt, sync_aux_state=False)
    try:
        step(batches[0])
        out["no_sync_error"] = None
    except ValueError as e:
        out["no_sync_error"] = str(e)
    out["moved"] = sorted(n for n, t in model.state_dict().items()
                          if not torch.equal(t, before[n]))
    return out


# ----------------------------------------------- four ranks, two hosts


def rank_grads(rank):
    """Per-rank gradients: odd lengths (padding to the ici size), an
    int8-eligible (64, 512) leaf, a 1-D leaf, and an f16 leaf."""
    rng = np.random.default_rng(70 + rank)
    return [rng.standard_normal((7, 5)).astype(np.float32),
            rng.standard_normal((64, 512)).astype(np.float32),
            rng.standard_normal(301).astype(np.float32),
            rng.standard_normal((3, 11)).astype(np.float16)]


def int_payload(rank):
    rng = np.random.default_rng(90 + rank)
    return rng.integers(-1000, 1000, 12_345).astype(np.float32)


def hier_worker(rank, variables, images, labels):
    mesh = hvd.hierarchical_mesh()
    out = {"mesh": (mesh.grid, mesh.ici_size, mesh.dcn_size,
                    mesh.ici_rank, mesh.dcn_rank)}
    x = torch.from_numpy(int_payload(rank))
    for average in (False, True):
        hier = hierarchical_allreduce(x, average=average, mesh=mesh)
        flat = injit.allreduce(x, average=average)
        out[("int", average)] = (hier.numpy(), flat.numpy())
    grads = [torch.from_numpy(g) for g in rank_grads(rank)]
    for fuse in (True, False):
        for overlap in (False, True):
            for comp in ("none", "bf16", "int8"):
                red = reduce_gradients(grads, compression=comp, fuse=fuse,
                                       overlap=overlap, bucket_bytes=4096,
                                       mesh=mesh)
                out[(comp, fuse, overlap)] = [r.numpy() for r in red]
    out["sum"] = [r.numpy() for r in reduce_gradients(
        grads, average=False, mesh=mesh)]
    fixed = hvd.hierarchical_mesh(ici_size=4)
    out["fixed"] = (fixed.grid, fixed.ici_size, fixed.dcn_size)
    try:
        hvd.hierarchical_mesh(ici_size=3)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    quarter = images.shape[1] // 4
    rows = slice(rank * quarter, (rank + 1) * quarter)
    batches = to_batches(images[:, rows], labels[:, rows])
    out["step_mesh"] = train(small_resnet(variables), batches, mesh=mesh)
    out["step_flat"] = train(small_resnet(variables), batches)
    return out
