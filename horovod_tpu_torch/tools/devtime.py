"""Device-time microbench of the flash kernels, the port's twin of
``tools/devtime.py``.

Each spec runs ``REPS`` chained calls at B 8, T 2048, H 16, D 128, bf16,
causal, through ``ops.flash_attention.flash_attention``: ``fwd,bq,bk``
chains forwards (P1), each output the next call's q; ``bwd,bq,bk,impl``
chains forward + backward, each dq the next call's q, with ``impl`` one of
``flash_attention``'s ``bwd_impl`` values (``pallas``/``pallas_split``:
P1 + P2 + P3; ``pallas_fused``: P1 + P6 while ``_bwd_form`` takes the
one-pass form; ``xla``: P1 and the plain chunked backward).  The device
time a rep is the time of the card's kernels and copies over the reps
(``profiling.capture`` + ``profiling.kernel_table``, over as many passes
of REPS as fill ``tools.MIN_CAPTURE_S``), the counterpart of the TPU
trace's module time the JAX tool read.  Each line also gives the span of
those events a rep (``device_time_ms``: the kernels and the card's waits
on the host between them) and the kernel launches a rep of one pass,
from ``ops._cuda.LAUNCHES``.

The block sizes are validated as the JAX package validates them (a block
must divide T and be a multiple of 8; otherwise the port's ``ValueError``
text is printed for that spec).  The Hopper kernels choose their own
64-row tiles, so a valid block size does not change what runs.

Usage:  python -m horovod_tpu_torch.tools.devtime fwd,128,128 \\
            bwd,128,128,pallas_split bwd,128,128,pallas_fused
"""

import functools
import sys

import torch

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.tools import device_ms, require_device

B, T, H, D = 8, 2048, 16, 128
REPS = 16


def parse_spec(spec: str):
    """``fwd,bq,bk`` -> ("fwd", bq, bk, None); ``bwd,bq,bk,impl`` ->
    ("bwd", bq, bk, impl), the JAX tool's grammar."""
    parts = spec.split(",")
    kind = parts[0]
    if kind == "fwd":
        return kind, int(parts[1]), int(parts[2]), None
    return "bwd", int(parts[1]), int(parts[2]), parts[3]


def fwd_program(q, k, v, bq, bk, reps=REPS):
    """``reps`` chained causal forwards: each output is the next q."""
    out = q
    with torch.no_grad():
        for _ in range(reps):
            out = flash_attention(out, k, v, causal=True, block_q=bq,
                                  block_k=bk)
    return out


def grad_program(attn_fn, q, k, v, do, reps=REPS):
    """``reps`` chained forward + backward passes of the JAX tools' loss
    ``sum(f32(attn_fn(q, k, v)) * f32(dO))``: dq, dk and dv are computed,
    dq (in q's dtype) is the next q.  The loss's gradient with respect to
    the output is dO itself, so dO goes to autograd as the output's
    cotangent: the f32 product and sum, which XLA folds away in the JAX
    tools, would be extra elementwise passes over (B, T, H, D) here."""
    c = q
    k, v = (x.detach().requires_grad_() for x in (k, v))
    for _ in range(reps):
        c = c.detach().requires_grad_()
        dq, _, _ = torch.autograd.grad(attn_fn(c, k, v), (c, k, v), do)
        c = dq.to(q.dtype)
    return c.detach()


def bwd_program(q, k, v, do, bq, bk, impl, reps=REPS):
    """:func:`grad_program` over causal flash attention at blocks (bq, bk)
    with backward ``impl``."""
    return grad_program(functools.partial(
        flash_attention, causal=True, block_q=bq, block_k=bk,
        bwd_impl=impl), q, k, v, do, reps)


def inputs(device, b=B, t=T, h=H, d=D, dtype=torch.bfloat16, seed=0):
    """q, k, v and dO, normal from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=gen, device=device,
                        dtype=torch.float32).to(dtype) for _ in range(4)]


def measure(spec: str, q, k, v, do) -> dict:
    """Run one spec: one untimed pass (its first call builds the kernels'
    plans), then :func:`~horovod_tpu_torch.tools.device_ms`.  Returns its
    kind, blocks and impl, the device ms a rep and its span (None without
    device events: the CPU) and the kernel launches a rep of the captured
    passes."""
    kind, bq, bk, impl = parse_spec(spec)
    if kind == "fwd":
        def run():
            fwd_program(q, k, v, bq, bk)
    else:
        def run():
            bwd_program(q, k, v, do, bq, bk, impl)
    run()
    counts = {}

    def counted():
        _cuda.reset_launches()
        run()
        counts.update((n, c) for n, c in _cuda.LAUNCHES.items() if c)
    ms, span_ms, _ = device_ms(counted, REPS, q.device)
    return {"kind": kind, "bq": bq, "bk": bk, "impl": impl, "ms": ms,
            "span_ms": span_ms,
            "launches": {n: c / REPS for n, c in counts.items()}}


def line(r: dict) -> str:
    """The JAX tool's line for one result, the launches a rep beside it."""
    causal_area = T * T / 2
    fwd_flops = B * H * 2 * 2 * causal_area * D
    bwd_flops = B * H * 5 * 2 * causal_area * D
    t = r["ms"]
    launches = " ".join(f"{n}={c:g}"
                        for n, c in sorted(r["launches"].items()))
    if r["kind"] == "fwd":
        head = f"fwd  bq={r['bq']:5d} bk={r['bk']:5d}: "
        rate = f"{fwd_flops / t / 1e9:6.1f} TF/s useful" if t else ""
    else:
        head = f"f+b  bq={r['bq']:5d} bk={r['bk']:5d} {r['impl']:13s}: "
        rate = (f"{(fwd_flops + bwd_flops) / t / 1e9:6.1f} TF/s eff"
                if t else "")
    timed = (f"{t:7.3f} ms/rep ({rate}); span {r['span_ms']:.3f}"
             if t else "not measured (no device events)")
    return f"{head}{timed}  launches/rep: {launches or 'none'}"


def main(argv=None, device: str = "cuda") -> list:
    """Measure each spec of ``argv`` and print its line; returns the
    results (a spec whose blocks the entry point refuses gives its
    ``ValueError`` text under ``"error"``)."""
    specs = sys.argv[1:] if argv is None else argv
    dev = require_device(device)
    q, k, v, do = inputs(dev)
    results = []
    for spec in specs:
        try:
            r = measure(spec, q, k, v, do)
        except ValueError as exc:
            r = {"spec": spec, "error": str(exc)}
            print(f"{spec}: {exc}", flush=True)
        else:
            print(line(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
