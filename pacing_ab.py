"""Does the multi-process tick loop's pacing move the eager plane?  For
each checkout named on the command line, in that order, a job of four
processes (one card each, or gloo on the CPU with ``--cpu``) imports
that checkout's ``horovod_tpu_torch`` and times, on the eager plane:

* the 4 KiB allreduce: the median host time of one synchronous
  ``hvd.allreduce`` until its result is on the device (phase 19's
  measure, 200 after 20 untimed);
* the 64 x 1 MiB burst: enqueue all, synchronize all, 5 times (phase
  19's), the median of the last 4, and its response-cache hits;
* the control ticks under them, read from the native tick call
  (``Controller._control.tick``) on the shared monotonic clock: the
  median period between a process's tick starts, its time at the
  coordinator (start to response), and the spread of the four
  processes' start times at the same tick.

Prints one line of medians over the ranks a run, and the card's name and
power limit.  Run from the root of a checkout, with the other checkout
unpacked into a directory of this one that ``.gitignore`` lists, in the
order parent, change, change, parent, ...::

    python3 pacing_ab.py build/parent . . build/parent

(``chip_smoke.py``'s phases 19 and 21 can be run from each checkout the
same way, ``import chip_smoke as c; c.phase_eager_nccl()``.)
"""

import bisect
import json
import os
import socket
import statistics
import subprocess
import sys
import time

SMALL, LAT_REPS, LAT_WARM = 1024, 200, 20
BURST, BURST_N, BURSTS = 64, 1 << 18, 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker() -> None:
    """One process of a job: the measures above, one JSON line."""
    import torch
    import horovod_tpu_torch as hvd
    cpu = os.environ.get("PACING_CPU") == "1"
    if cpu:
        torch.set_num_threads(1)
        hvd.init(device="cpu")
    else:
        hvd.init(init_method=os.environ["PACING_INIT"])
    dev = (torch.device("cpu") if cpu
           else torch.device("cuda", torch.cuda.current_device()))

    def sync():
        if not cpu:
            torch.cuda.synchronize(dev)
    ctl = hvd.controller()
    sends, times = [], []
    native = ctl._control.tick

    def tick(blob, threshold):
        t0 = time.monotonic()
        out = native(blob, threshold)
        sends.append(t0)
        times.append(time.monotonic() - t0)
        return out
    ctl._control.tick = tick
    x = torch.ones(SMALL, device=dev)
    hvd.allreduce(x, name="pacing.warm")
    lat = []
    first = len(sends)
    for i in range(LAT_WARM + LAT_REPS):
        t0 = time.perf_counter()
        hvd.allreduce(x, name="pacing.small")
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat_ticks = (first, len(sends))
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randint(-8, 8, (BURST_N,), generator=gen,
                        device=dev).float() for _ in range(BURST)]
    sync()
    bursts, hits = [], []
    for _ in range(BURSTS):
        c0 = hvd.metrics()["counters"].get("control.cache_hits", 0)
        t0 = time.perf_counter()
        hs = [hvd.allreduce_async(t, average=False, name=f"pacing.b.{i}")
              for i, t in enumerate(xs)]
        for h in hs:
            hvd.synchronize(h)
        sync()
        bursts.append((time.perf_counter() - t0) * 1e3)
        hits.append(hvd.metrics()["counters"].get("control.cache_hits", 0)
                    - c0)
    a, b = lat_ticks
    print("PACING " + json.dumps({
        "rank": hvd.rank(), "latency_ms": statistics.median(lat[LAT_WARM:]),
        "burst_ms": statistics.median(bursts[1:]), "burst_hits": hits,
        "lat_sends": sends[a:b], "lat_at_coordinator": times[a:b]}),
        flush=True)
    hvd.shutdown()


def job(tree: str, cpu: bool) -> list:
    """Run the four processes of one job from ``tree``; their results."""
    coord, master = _free_port(), _free_port()
    procs = []
    for r in range(4):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HOROVOD_TPU_", "MASTER_"))}
        env.update(PYTHONPATH=tree, HOROVOD_TPU_SIZE="4",
                   HOROVOD_TPU_RANK=str(r), HOROVOD_TPU_LOCAL_SIZE="1",
                   HOROVOD_TPU_COORD_ADDR=f"127.0.0.1:{coord}",
                   PACING_INIT=f"tcp://127.0.0.1:{master}")
        if cpu:
            env.update(PACING_CPU="1", HOROVOD_TPU_LOCAL_RANK=str(r),
                       HOROVOD_TPU_PROCESS_INDEX=str(r),
                       HOROVOD_TPU_PROCESS_COUNT="4",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            cwd=tree, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    got = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        lines = [ln for ln in out.splitlines() if ln.startswith("PACING ")]
        if p.returncode or not lines:
            raise RuntimeError(f"a process of the job failed:\n{out[-3000:]}")
        got.append(json.loads(lines[0][len("PACING "):]))
    return sorted(got, key=lambda g: g["rank"])


def summary(got: list) -> dict:
    """Medians over the ranks, and over the latency loop's ticks: the
    period, the time at the coordinator and the spread of start times.
    A tick's response reaches every process at about the same moment, so
    each of rank 0's ticks is matched with the tick of each other rank
    whose response came nearest to its own."""
    resp = [[t + d for t, d in zip(g["lat_sends"], g["lat_at_coordinator"])]
            for g in got]
    spread = []
    for i, r0 in enumerate(resp[0]):
        starts = [got[0]["lat_sends"][i]]
        for g, rs in zip(got[1:], resp[1:]):
            j = bisect.bisect_left(rs, r0)
            j = min((k for k in (j - 1, j) if 0 <= k < len(rs)),
                    key=lambda k: abs(rs[k] - r0))
            starts.append(g["lat_sends"][j])
        spread.append(max(starts) - min(starts))
    period = [statistics.median(
        b - a for a, b in zip(g["lat_sends"], g["lat_sends"][1:]))
        for g in got]
    med = statistics.median
    return {"latency_ms": round(med(g["latency_ms"] for g in got), 4),
            "burst_ms": round(med(g["burst_ms"] for g in got), 3),
            "burst_hits": got[0]["burst_hits"],
            "ticks_per_allreduce": round(
                len(resp[0]) / (LAT_WARM + LAT_REPS), 3),
            "tick_period_ms": round(med(period) * 1e3, 4),
            "at_coordinator_ms": round(med(
                med(g["lat_at_coordinator"]) for g in got) * 1e3, 4),
            "start_spread_ms": round(med(spread) * 1e3, 4)}


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    cpu = "--cpu" in sys.argv
    if not cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout, end="", flush=True)
    for i, tree in enumerate(args or ["."]):
        t0 = time.perf_counter()
        s = summary(job(os.path.abspath(tree), cpu))
        print(f"run {i} {tree} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(s)}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker()
    else:
        main()
