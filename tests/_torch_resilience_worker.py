"""Torch-only workers of ``test_torch_checkpoint.py``: the resume protocol
on two gloo ranks over the native control plane (spawned by
``_torch_eager_worker.spawn``).  Kept apart from the test file so that a
spawned worker imports PyTorch and the port, not JAX."""

import hashlib
import json
import os

import torch

# The chain the ranks restore from: epochs 1-3, the tip corrupt.
EPOCHS = (1, 2, 3)


def chain_state(epoch: int) -> dict:
    return {"w": torch.linspace(-1, 1, 6) * epoch,
            "b": torch.arange(3, dtype=torch.int64) * epoch,
            "h": (torch.arange(4, dtype=torch.float32) / 7 * epoch).to(
                torch.bfloat16),
            "lr": 0.125 * epoch}


def like() -> dict:
    return {"w": torch.zeros(6), "b": torch.zeros(3, dtype=torch.int64),
            "h": torch.zeros(4, dtype=torch.bfloat16), "lr": 0.0}


def digest(state) -> str:
    from horovod_tpu_torch import checkpoint
    h = hashlib.sha256()
    for key, value in sorted(checkpoint.flatten_state(state).items()):
        h.update(key.encode())
        h.update(value.tobytes())
    return h.hexdigest()


def restore_cases(hvd, rank, n, report):
    """Rank 0 writes a chain whose tip link is corrupt; both ranks then
    run ``restore_and_broadcast``: with the scan (the epoch agreed from
    rank 0's), with the torn tip passed explicitly (the fallback), with
    the world sidecar naming another size (replicated state restores, a
    DTensor shard raises with its leaf named)."""
    from horovod_tpu_torch import checkpoint
    d = os.environ["TEST_CKPT_DIR"]
    if rank == 0:
        prev = None
        for e in EPOCHS:
            flat = checkpoint.flatten_state(chain_state(e))
            checkpoint.save_chain(d, flat, e,
                                  prev_epoch=e - 1 if prev else -1,
                                  prev_flat=prev)
            prev = flat
        shard = os.path.join(checkpoint.checkpoint_path(d, 3),
                             checkpoint.CHAIN_SHARDS)
        with open(shard, "r+b") as f:
            data = f.read()
            f.seek(len(data) // 2)
            f.write(bytes([data[len(data) // 2] ^ 0x5A]))
    # Every rank waits for rank 0's writes.
    hvd.allreduce(torch.zeros(1), name="chain.written")
    state, epoch = checkpoint.restore_and_broadcast(d, like())
    report(("scan", epoch, digest(state), state["lr"]))
    state, epoch = checkpoint.restore_and_broadcast(d, like(), epoch=3)
    report(("explicit", epoch, digest(state)))
    if rank == 0:
        with open(checkpoint._world_meta_path(d, 2), "w") as f:
            json.dump({"world_size": n + 1}, f)
    hvd.allreduce(torch.zeros(1), name="sidecar.written")
    state, epoch = checkpoint.restore_and_broadcast(d, like())
    report(("resized", epoch, digest(state)))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (n,))
    sharded = dict(like(), w=distribute_tensor(torch.zeros(6), mesh,
                                               [Shard(0)]))
    try:
        checkpoint.restore_and_broadcast(d, sharded)
        report(("sharded", "no error"))
    except ValueError as exc:
        report(("sharded", str(exc)))
