"""Long-context T sweep, the port's twin of ``tools/tsweep.py``: flash
(P1, P2, P3) against ``parallel.ring_attention.full_attention`` (the (T, T)
scores materialised in f32), forward + backward, on the card.

For each T (argv; default 2048, 4096, 8192, 16384) at B 1, H 16, D 128,
bf16, causal, ``REPS`` chained forward + backward passes of ``sum(o *
dO)`` make a pass (each dq the next q).  The table gives the device ms
of one forward + backward: the time of the card's kernels and copies
over as many passes as fill ``tools.MIN_CAPTURE_S``, a rep, the
counterpart of the JAX tool's device time.  Where the span of those
events is more than ``SPAN_NOTE`` longer (the card waiting on the
host between launches, as at B 1 and T 2048), it stands beside the
time as ``(span x)``.  Tokens/s = B * T / the device time.  The "peak
temp GB" column gives the peak memory the passes allocated beyond their
inputs: ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, less what was allocated before (q, k, v,
dO).  The JAX tool gave XLA's compiled ``temp_size_in_bytes`` there.  A
pass that fails (out of memory) gives its row in the JAX tool's OOM
form, and the sweep goes on.

Usage:  python -m horovod_tpu_torch.tools.tsweep [T ...]
"""

import functools
import gc
import sys

import torch

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.ring_attention import full_attention
from horovod_tpu_torch.tools import device_ms, require_device
from horovod_tpu_torch.tools.devtime import grad_program, inputs

B, H, D = 1, 16, 128
REPS = 8
HEADER = ("| T | impl | fwd+bwd ms | tokens/s (B*T/step) | peak temp GB |",
          "|---|------|-----------:|--------------------:|-------------:|")
# A span more than this share above the device time stands beside it.
SPAN_NOTE = 0.03
IMPLS = (("flash", functools.partial(flash_attention, causal=True)),
         ("full", functools.partial(full_attention, causal=True)))


def measure(attn_fn, q, k, v, do) -> dict:
    """One untimed pass of REPS, then
    :func:`~horovod_tpu_torch.tools.device_ms`: the device ms of a
    forward + backward and its span (both None without device events:
    the CPU), the peak bytes of the timed passes beyond the inputs (None
    on the CPU) and the kernel launches a forward + backward."""
    cuda = q.device.type == "cuda"
    counts = {}

    def run():
        _cuda.reset_launches()
        grad_program(attn_fn, q, k, v, do, REPS)
        counts.update((n, c) for n, c in _cuda.LAUNCHES.items() if c)
    run()
    if cuda:
        torch.cuda.synchronize(q.device)
        torch.cuda.reset_peak_memory_stats(q.device)
        before = torch.cuda.memory_allocated(q.device)
    ms, span_ms, _ = device_ms(run, REPS, q.device)
    peak = (torch.cuda.max_memory_allocated(q.device) - before
            if cuda else None)
    return {"ms": ms, "span_ms": span_ms, "peak_bytes": peak,
            "launches": {n: c / REPS for n, c in counts.items()}}


def row(T: int, name: str, r: dict) -> str:
    """The JAX tool's table row of one result (its OOM form for a pass
    that failed), the span beside the device ms where it is more than
    ``SPAN_NOTE`` longer."""
    if "error" in r:
        return f"| {T} | {name} | OOM/fail ({r['error']}) | — | — |"
    ms, span = r["ms"], r.get("span_ms")
    if not ms:
        return f"| {T} | {name} | not measured | — | — |"
    note = (f" (span {span:.2f})" if span and span > ms * (1 + SPAN_NOTE)
            else "")
    return (f"| {T} | {name} | {ms:.2f}{note} | {B * T / (ms / 1e3):,.0f} "
            f"| {r['peak_bytes'] / 1e9:.2f} |")


def main(argv=None, device: str = "cuda") -> dict:
    """Print the table for the Ts of ``argv``; returns {(T, impl):
    result}."""
    args = sys.argv[1:] if argv is None else argv
    Ts = [int(a) for a in args] or [2048, 4096, 8192, 16384]
    dev = require_device(device)
    for text in HEADER:
        print(text)
    results = {}
    for T in Ts:
        q, k, v, do = inputs(dev, B, T, H, D)
        for name, fn in IMPLS:
            try:
                r = measure(fn, q, k, v, do)
            except (RuntimeError, ValueError) as e:
                r = {"error": f"{type(e).__name__}: {str(e)[:60]}"}
            results[(T, name)] = r
            print(row(T, name, r), flush=True)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        del q, k, v, do
    return results


if __name__ == "__main__":
    main()
