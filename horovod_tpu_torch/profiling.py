"""Device-side profiling: the device time of captured work and per-kernel
roofline attribution on the GPU.

Port of ``horovod_tpu/profiling.py`` (``capture`` :66,
``load_trace_events`` :41, ``device_time_ms`` :84, ``per_op_rooflines``
:101, ``print_rooflines`` :143) onto ``torch.profiler`` in place of
``jax.profiler``.  :func:`capture` writes the Chrome trace gzipped under
``log_dir/plugins/profile/<stamp>/<host>.trace.json.gz``, the layout the
reference reads, so both packages' loaders find it.

Device events are picked by their Kineto category: ``kernel``, and
``gpu_memcpy`` / ``gpu_memset`` as copies.  Annotation rows
(``gpu_user_annotation``, and the ``nccl:*`` and ``Optimizer.*`` ranges
recorded on the device) span the kernels inside them and are never
counted, so no kernel's time is counted twice.

Divergences from the reference, whose rows come from XLA's per-op cost
model:

* a row is a group of kernels by name stem, its ``source`` the name of
  the op that launched them (joined through the kernel's ``External id``);
* FLOPs are the launching op's ``flops`` as ``with_flops=True`` counts
  them (matrix products and convolutions; :func:`capture` writes them into
  the op's args, which the exported trace leaves out), shared among that
  op's kernels by their time; a kernel of an op PyTorch counts no FLOPs
  for (the port's own kernels among them) reports 0;
* bytes are the sizes of the launching op's recorded inputs (its outputs
  where the trace records them), a lower bound of what it moved;
* the peaks default to the H100 SXM's dense bf16 rate and HBM3 bandwidth.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import socket
import tempfile
import time
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

# H100 SXM: dense bf16 tensor-core peak and HBM3 bandwidth (NVIDIA's data
# sheet), the roofline's defaults.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

KERNEL_CATS = ("kernel",)
COPY_CATS = ("gpu_memcpy", "gpu_memset")

# Bytes of one element of each dtype name the profiler records.
_ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
             "long int": 8, "int": 4, "short int": 2, "signed char": 1,
             "unsigned char": 1, "bool": 1, "c10::Float8_e4m3fn": 1,
             "c10::Float8_e5m2": 1, "c10::complex<float>": 8}


def _latest_trace_file(log_dir: str) -> Optional[str]:
    paths = glob.glob(os.path.join(
        log_dir, "plugins/profile/*/*.trace.json.gz"))
    return max(paths, key=os.path.getmtime) if paths else None


def load_trace_events(log_dir: str) -> List[dict]:
    """Raw Chrome-trace events from the newest trace under ``log_dir``
    (as written by :func:`capture`)."""
    path = _latest_trace_file(log_dir)
    if path is None:
        return []
    with gzip.open(path) as fh:
        return json.load(fh).get("traceEvents", [])


def _synchronize() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def capture(run: Callable[[], None], *, warmup: int = 1,
            iters: int = 2, log_dir: Optional[str] = None) -> str:
    """Run ``run()`` ``iters`` times under ``torch.profiler`` (CPU and,
    where there is a GPU, CUDA activities, with FLOPs and shapes
    recorded), after ``warmup`` untraced calls; synchronize the device,
    write the trace and return its directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        run()
    _synchronize()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or tempfile.mkdtemp(prefix="htpu_profile")
    with profile(activities=activities, record_shapes=True,
                 with_flops=True) as prof:
        for _ in range(iters):
            run()
        _synchronize()
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S") + f"_{time.time_ns():d}"
    out = os.path.join(log_dir, "plugins", "profile", stamp)
    os.makedirs(out, exist_ok=True)
    raw = os.path.join(out, "trace.json")
    prof.export_chrome_trace(raw)
    with open(raw) as fh:
        trace = json.load(fh)
    os.remove(raw)
    # The exported trace leaves out the FLOPs that ``with_flops`` counted;
    # each op's count goes into its args under "flops" (an op's
    # ``External id`` is its event id).
    flops = {e.id: e.flops for e in prof.events() if getattr(e, "flops", 0)}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "cpu_op":
            n = flops.get(e.get("args", {}).get("External id"))
            if n:
                e["args"]["flops"] = n
    with gzip.open(os.path.join(out, f"{socket.gethostname()}"
                                     ".trace.json.gz"), "wt") as fh:
        json.dump(trace, fh)
    return log_dir


def device_events(events: List[dict]) -> List[dict]:
    """The device's own work in a trace: kernels and copies (``ph`` X),
    never the annotation ranges that span them."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in KERNEL_CATS + COPY_CATS]


def device_time_ms(log_dir: str, *, per: int = 1) -> Optional[float]:
    """The device span of the captured work, in ms / ``per``: from the
    first kernel's (or copy's) start to the last one's end -- the
    counterpart of the reference's longest device-side module span.  None
    when the trace has no device events (the CPU)."""
    dev = device_events(load_trace_events(log_dir))
    if not dev:
        return None
    start = min(float(e["ts"]) for e in dev)
    end = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in dev)
    return (end - start) / 1e3 / per


def kernel_stem(name: str) -> str:
    """A kernel's name without ``void``, template arguments and parameter
    list: ``void at::native::f<4, ...>(...)`` -> ``at::native::f``."""
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def kernel_table(log_dir: str, *,
                 per: int = 1) -> List[Tuple[str, float, float]]:
    """The device events of a captured trace grouped by
    :func:`kernel_stem`: [(stem, ms, launches)] over ``per`` (the captured
    steps or reps), by time, descending.  Their ms add up to the card's
    busy time, which :func:`device_time_ms` spans; empty without device
    events (the CPU)."""
    tot, cnt = defaultdict(float), defaultdict(int)
    for e in device_events(load_trace_events(log_dir)):
        stem = kernel_stem(e.get("name", ""))
        tot[stem] += float(e.get("dur", 0.0)) / 1e3
        cnt[stem] += 1
    return sorted(((n, ms / per, cnt[n] / per) for n, ms in tot.items()),
                  key=lambda r: -r[1])


def _op_bytes(args: dict) -> float:
    total = 0.0
    for dims_key, type_key in (("Input Dims", "Input type"),
                               ("Output Dims", "Output type")):
        for dims, dtype in zip(args.get(dims_key) or [],
                               args.get(type_key) or []):
            if isinstance(dims, list) and dims and all(
                    isinstance(d, int) for d in dims):
                n = 1
                for d in dims:
                    n *= d
                total += n * _ITEMSIZE.get(dtype, 0)
    return total


def per_op_rooflines(log_dir: str, *, peak_flops: float = PEAK_FLOPS,
                     peak_bytes: float = PEAK_BYTES) -> List[dict]:
    """Per-kernel roofline table from a captured trace: device events
    grouped by (name stem, launching op), each with total ms, achieved
    FLOP/s and bytes/s, and their fractions of the given peaks (the H100
    SXM's by default), sorted by time, descending.  The keys are the
    reference's; see the module docstring for what FLOPs and bytes
    count."""
    events = load_trace_events(log_dir)
    dev = device_events(events)
    ops = {e["args"]["External id"]: e for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and "External id" in e.get("args", {})}
    # Each op's FLOPs and bytes are shared among its kernels by time.
    op_dur = defaultdict(float)
    for e in dev:
        op_dur[e.get("args", {}).get("External id")] += float(e.get("dur",
                                                                    0.0))
    agg = defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for e in dev:
        ext = e.get("args", {}).get("External id")
        op = ops.get(ext)
        dur = float(e.get("dur", 0.0))
        key = (kernel_stem(e.get("name", "")),
               op["name"] if op else "?")
        agg[key][0] += dur                                    # us
        if op and op_dur[ext] > 0:
            share = dur / op_dur[ext]
            agg[key][1] += float(op["args"].get("flops", 0) or 0) * share
            agg[key][2] += _op_bytes(op["args"]) * share
        agg[key][3] += 1
    rows = []
    for (stem, src), (dur, fl, by, n) in sorted(
            agg.items(), key=lambda kv: -kv[1][0]):
        sec = dur * 1e-6
        rows.append({
            "op": stem, "source": src, "count": n,
            "ms": round(dur / 1e3, 3),
            "tflops_per_sec": round(fl / sec / 1e12, 2) if sec else 0.0,
            "pct_of_peak_flops": round(100 * fl / sec / peak_flops, 1)
            if sec else 0.0,
            "gbytes_per_sec": round(by / sec / 1e9, 1) if sec else 0.0,
            "pct_of_peak_bw": round(100 * by / sec / peak_bytes, 1)
            if sec else 0.0,
        })
    return rows


def print_rooflines(rows: List[dict], top: int = 30) -> None:
    print(f"{'ms':>9} {'n':>5} {'TF/s':>7} {'%TC':>5} {'GB/s':>7} "
          f"{'%HBM':>5}  kernel @ op")
    for r in rows[:top]:
        print(f"{r['ms']:9.3f} {r['count']:5d} "
              f"{r['tflops_per_sec']:7.1f} {r['pct_of_peak_flops']:5.1f} "
              f"{r['gbytes_per_sec']:7.1f} {r['pct_of_peak_bw']:5.1f}  "
              f"{r['op']} @ {r['source']}")
