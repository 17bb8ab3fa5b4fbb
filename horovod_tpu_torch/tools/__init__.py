"""The port's twins of the JAX package's kernel tools (``tools/devtime.py``,
``tools/tsweep.py``, ``tools/step_profile.py``), run as ``python -m
horovod_tpu_torch.tools.<name>`` on the card.  They read device time from
the card's kernel events through :mod:`horovod_tpu_torch.profiling`."""

import math
import shutil
import tempfile
import time

import torch

from horovod_tpu_torch import profiling

# A capture of a few milliseconds recorded no kernel events on the card
# (H100 80GB HBM3, torch 2.11), and the first capture of a process
# stretched its span: the tools capture passes for at least this long,
# after one throwaway capture a process.
MIN_CAPTURE_S = 0.2
_warm = {"profiler": False}


def require_device(device: str) -> torch.device:
    """The device a tool runs on: the card unless the caller asks for the
    CPU.  A tool asked for the card on a machine without one raises; it
    never times the CPU in its place."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this tool times the card's kernels and needs a CUDA GPU "
            "(torch.cuda.is_available() is false); device='cpu' runs its "
            "programs on the plain versions, untimed")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return torch.device(device)


def device_ms(run, reps: int, device: torch.device):
    """The device time of one rep of ``run`` (a pass of ``reps`` reps):
    one pass timed on the host, then ``profiling.capture`` of as many
    passes as last ``MIN_CAPTURE_S`` on the card (the first capture of a
    process thrown away; one pass on the CPU).  Returns (ms, span ms,
    passes): ms is the time of the card's kernels and copies a rep (the
    sum of ``profiling.kernel_table``), the counterpart of the TPU's
    device time of the program; the span, from the first device event to
    the last over reps x passes, adds the card's waits on the host
    between them.  Both are None without device events (the CPU)."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    run()
    if cuda:
        torch.cuda.synchronize(device)
    passes = (max(1, math.ceil(MIN_CAPTURE_S
                               / max(time.perf_counter() - t0, 1e-9)))
              if cuda else 1)
    if cuda and not _warm["profiler"]:
        shutil.rmtree(profiling.capture(run, warmup=0, iters=1),
                      ignore_errors=True)
        _warm["profiler"] = True
    log_dir = profiling.capture(run, warmup=0, iters=passes,
                                log_dir=tempfile.mkdtemp(prefix="tools"))
    per = reps * passes
    span = profiling.device_time_ms(log_dir, per=per)
    rows = profiling.kernel_table(log_dir, per=per)
    shutil.rmtree(log_dir, ignore_errors=True)
    return (sum(ms for _, ms, _ in rows) if rows else None), span, passes
