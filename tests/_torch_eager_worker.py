"""Torch-only workers of ``test_torch_eager_multiprocess.py``: one spawned
process per rank, one gloo world group, and the eager plane over the
native control plane (``HOROVOD_TPU_COORD_ADDR``) or without it (jit-only
mode).  Kept apart from the test file so that a spawned worker imports
PyTorch and the port, not JAX."""

import os
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as tmp

# The wire-compressed ring's payload: several 64K-element sub-chunks a
# segment and an odd tail.
WIRE_N = 3 * 65536 + 37
# The response cache's async bursts: CACHE_BURSTS of CACHE_TENSORS in the
# three-process job, CACHE_BYTES_BURSTS in the two-process one.
CACHE_BURSTS, CACHE_TENSORS, CACHE_BYTES_BURSTS = 31, 16, 61
EXIT_CRASH = 42


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target, n: int, env: dict, timeout: float = 120.0,
          fingerprints=None) -> dict:
    """Run ``target(hvd, rank, n, report)`` in ``n`` spawned processes,
    each with ``env`` plus its rank and a gloo rendezvous, after
    ``hvd.init``; returns {rank: [messages]} and each process's exit code
    under "exit".  A target that returns "crash" makes its process die
    without the shutdown handshake.  ``fingerprints``: one faked host
    fingerprint a rank."""
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    envs = [dict(env) for _ in range(n)]
    for r, fp in enumerate(fingerprints or ()):
        envs[r]["HOROVOD_TPU_HOST_FINGERPRINT"] = fp
    procs = [ctx.Process(target=_entry, args=(target, r, n, port, envs[r],
                                              results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {r: [] for r in range(n)}
    try:
        done = 0
        while done < n:
            try:
                rank, msg = results.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(
                    f"no worker message within {timeout} s: {got}") from None
            if msg == "done":
                done += 1
            elif isinstance(msg, str):
                raise AssertionError(f"rank {rank}:\n{msg}")
            else:
                got[rank].append(msg)
                done += msg == ("crash",)   # its last message
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    got["exit"] = [p.exitcode for p in procs]
    return got


def _entry(target, rank, n, port, env, results):
    try:
        os.environ.update(env)
        os.environ.update({"HOROVOD_TPU_SIZE": str(n),
                           "HOROVOD_TPU_RANK": str(rank),
                           "HOROVOD_TPU_LOCAL_SIZE": "1"})
        torch.set_num_threads(1)
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{port}")
        if target(hvd, rank, n, lambda msg: results.put((rank, msg))) \
                == "crash":
            # Die without the shutdown handshake, once the parent has the
            # message that says so.
            results.put((rank, ("crash",)))
            results.close()
            results.join_thread()
            os._exit(EXIT_CRASH)
        results.put((rank, "done"))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def payload(rank: int, n: int, seed: int) -> np.ndarray:
    """Seeded per-rank float32 values every process can recompute."""
    return (np.random.default_rng(1000 * seed + rank)
            .standard_normal(n) * 5).astype(np.float32)


def eager_cases(hvd, rank, n, report):
    """The eager cases that one rank per process can run, in one job:
    each result goes to the parent, which holds it against numpy and the
    JAX package.  Rank 1 then dies without the shutdown handshake, and
    the others' next collective must fail, not hang."""
    from horovod_tpu_torch import basics
    report(("layout", hvd.local_rank(), hvd.process_index(),
            hvd.process_count(), hvd.mpi_threads_supported()))

    # Fused async: several tensors in one negotiation window, per-rank
    # values; poll until done, then synchronize.
    hs = [hvd.allreduce_async(torch.full((8,), float(rank) * (i + 1)),
                              average=False, name=f"mp.fused.{i}")
          for i in range(6)]
    while not all(hvd.poll(h) for h in hs):
        pass
    report(("fused", [hvd.synchronize(h).numpy() for h in hs]))

    # Mixed average flags in one fusion buffer.
    hs = [hvd.allreduce_async(torch.full((4,), float(rank + 1) * (i + 1)),
                              average=bool(i % 2), name=f"mp.mixed.{i}")
          for i in range(4)]
    report(("mixed", [hvd.synchronize(h).numpy() for h in hs]))

    # Ragged allgather: rank r contributes r + 1 rows of value r.
    out = hvd.allgather(torch.full((rank + 1, 2), float(rank)),
                        name="mp.gather")
    report(("gather", out.numpy()))

    # Broadcast from every root, bf16 included.
    outs = [hvd.broadcast(torch.full((3,), float(10 * rank + 1)), root,
                          name=f"mp.bcast.{root}").numpy()
            for root in range(n)]
    bf = hvd.broadcast(torch.full((3,), rank + 0.5, dtype=torch.bfloat16),
                       n - 1, name="mp.bcast.bf16")
    report(("bcast", outs, bf.float().numpy()))

    # Integer average: the executor's floor division.
    ints = torch.tensor([rank + 1, 2 * rank - 7, 5], dtype=torch.int64)
    out = hvd.allreduce(ints, average=True, name="mp.intavg")
    report(("intavg", out.numpy(), str(out.dtype)))

    # The wire-compressed ring beside the raw one.
    ctrl = basics.controller()._control
    mine = torch.from_numpy(payload(rank, WIRE_N, 1))
    wires = {}
    for wire in ("", "bf16", "int8"):
        s0, _ = ctrl.data_bytes()
        out = hvd.allreduce(mine, average=False, name=f"mp.wire.{wire}",
                            compression=wire or "none")
        s1, _ = ctrl.data_bytes()
        wires[wire] = (out.numpy(), s1 - s0)
    report(("wire", wires))

    # Response cache: the same async burst again and again.
    cache_bursts(hvd, rank, n, CACHE_BURSTS)
    report(("cache", hvd.metrics()["counters"]))

    # A dtype mismatch: the coordinator's error, on every rank.
    bad = torch.zeros(2, dtype=torch.int32 if rank == 0 else torch.float32)
    try:
        hvd.allreduce(bad, name="mp.bad")
        report(("mismatch", None))
    except hvd.CollectiveError as e:
        report(("mismatch", str(e)))
    out = hvd.allreduce(torch.ones(2), average=False, name="mp.after")
    report(("after", out.numpy()))

    # A peer dies without the shutdown handshake.
    if rank == 1:
        return "crash"
    try:
        hvd.allreduce(torch.ones(4), name="mp.crash")
        report(("crashed", None))
    except hvd.CollectiveError as e:
        report(("crashed", type(e).__name__, str(e)))
    hvd.shutdown()     # must not hang after the failure


def cache_bursts(hvd, rank, n, bursts):
    """The reference's async burst (tests/test_multiprocess.py
    CACHE_BYTES_WORKER): ``CACHE_TENSORS`` small allreduces enqueued
    together, then synchronized, ``bursts`` times; returns each burst's
    control bytes.  The first negotiates in full; later ones ride the
    response cache's bits."""
    def neg_bytes():
        return hvd.metrics()["counters"].get("control.negotiation_bytes", 0)

    per_burst = []
    for _ in range(bursts):
        b0 = neg_bytes()
        hs = [hvd.allreduce_async(torch.full((8,), float(rank + 1)),
                                  average=False, name=f"cache.tensor.{j:02d}")
              for j in range(CACHE_TENSORS)]
        for h in hs:
            assert hvd.synchronize(h).tolist() == [n * (n + 1) / 2] * 8
        per_burst.append(neg_bytes() - b0)
    return per_burst


def cache_cases(hvd, rank, n, report):
    """The reference's cached-negotiation case: the bursts' control
    bytes, and the coordinator's count of ticks served from the cache."""
    per_burst = cache_bursts(hvd, rank, n, CACHE_BYTES_BURSTS)
    m = hvd.metrics()
    report((m["counters"], per_burst,
            m["histograms"].get("control.tick_seconds#cached=1",
                                {}).get("count", 0)))
    hvd.shutdown()


def jit_only_cases(hvd, rank, n, report):
    """No control plane: host discovery over the torch.distributed store
    gives ``local_rank``; an integer metric averages through
    ``make_eval_step``; an eager collective fails fast."""
    from horovod_tpu_torch.spmd import make_eval_step
    counts = torch.tensor([rank + 3, 2 * rank + 1], dtype=torch.int64)
    step = make_eval_step(torch.nn.Identity(), lambda model, batch: batch)
    mean = step(counts)
    try:
        hvd.allreduce(torch.ones(2), name="jit.only")
        err = None
    except hvd.CollectiveError as e:
        err = str(e)
    report((hvd.local_rank(), mean.numpy(), str(mean.dtype), err))
    hvd.shutdown()
