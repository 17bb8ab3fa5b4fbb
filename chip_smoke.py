"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without a CUDA device or outside
the checkout.  Phases, in order; any failure ends the run:

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``horovod_tpu_torch/csrc`` (timed), with ptxas'
   registers and spills for each kernel of the ``kernels`` line.
2. Kernels: each Hopper flash kernel (forward P1, dk/dv P2, dq P3) at the
   training shape (B 8, H 16, T 2048, D 128, bf16, causal, q/k/v read
   from one (B, T, 3C) projection) and on four small cases (non-causal
   T 512; a ragged ``seq_len`` at D 64; D 80, which the kernels pad to 128
   columns; T 192 with ``seq_len`` 130, a ragged edge inside a 128-row
   tile and across a 64-row one), held against its plain PyTorch version
   on the same inputs; P1, P2 and P3 launched twice on the training shape
   must give bit-identical results.  Then timed (CUDA events around 10
   launches, median of 20 such batches) beside its plain version, its
   bound at the H100 SXM peaks and ``scaled_dot_product_attention`` as a
   yardstick.  One line ``{"kernels": [...]}`` carries the numbers.
3. One-pass backward: P6 (``flash_bwd_fused``) on the same five cases,
   held against its plain version and against P2 + P3 on the same inputs,
   then timed at the training shape beside its plain version and the
   ``scaled_dot_product_attention`` backward.
4. General family: G1-G3 (``flash_general.cu``, the inputs P1-P3 do not
   take) against the plain versions in f32 at the training shape and on
   the small cases, at D 8, 12 and 200, in fp16 at D 64 and in bf16 at
   D 8, with TF32 off so that the f32 reference is full f32; timed at the
   training shape in f32 beside the plain versions and f32
   ``scaled_dot_product_attention``.  D 257 must raise.
5. f32 models: the reference's own checks
   (``tests/test_flash_attention.py``): ``TransformerLM(dim=256,
   num_heads=2, attn="flash", dtype=float32)`` (D 128 through
   ``flash_qkv_proj``) and dim 32 with 4 heads (D 8 through
   ``flash_attention_auto``) against ``attn="full"`` on the card, logits
   within 1e-4; G1-G3 run, P1-P3 do not (counters zeroed just before).
6. Reference: a small bf16 TransformerLM step through the kernels against
   the same model on the oracle attention, same parameters, on the
   card.
7. Train: the full-width TransformerLM (d 2048, 16 heads, vocab 32768,
   seq 2048, batch 8, bf16) through ``make_train_step`` with the fused
   cross-entropy and SGD with momentum, 2 warm-up and 5 timed steps.  The
   kernels' launch counters are zeroed just before and read just after;
   each flash kernel must equal depth x steps.  Losses must be finite and
   fall.  One more step runs under torch.profiler for the device time by
   kernel.
8. Train, one-pass: phase 7 again (model rebuilt from the same seed) under
   ``HOROVOD_TPU_FLASH_BWD=fullunroll``: P6 must launch depth x steps times
   and P2/P3 never; the first loss equals phase 7's bit for bit (the
   forward is the same) and every loss stays within ``TOL_ONE_PASS`` of
   phase 7's.  The knob is unset afterwards.
9. Routing: ``flash_attention(bwd_impl="pallas_fused")`` at B 2, H 16,
   D 128 runs P6 at T 8192 (T * D * 4 bytes = 4 MiB, the JAX package's
   limit) and P2 + P3 at T 16384; at T 8192 its gradients agree with the
   split pair's, and ``bwd_impl="xla"`` (plain PyTorch, chunked) agrees
   with the split pair's at T 2048.
10. Codec: the int8 kernels (quantize P4, dequantize P5) against their
   plain versions on the card, bit for bit, on edge blocks (all zero, tiny,
   subnormal, near 1e38, randn * exp(U(-6, 6))), a 1025-element tail
   through ``snap_to_grid`` and the timing shape (n = 67,108,864, the
   ``head`` leaf); then timed beside their plain versions and their bound,
   and dequantize beside ``torch.mul(q, scales)`` as a yardstick.
11. Ring: the int8 ring of 4 ranks driven in lockstep on the card, 16,777,216
   elements each: bit-identical to the same ring on the plain codec and
   within 5% (relative Frobenius) of the f32 mean.
12. Train, int8: the model of phase 7 (freed and rebuilt from the same
   seed) through ``hvd.DistributedOptimizer(SGD momentum,
   Compression.int8, error_feedback=True)``, 2 warm-up and 5 timed steps,
   counters zeroed just before and read just after: each codec kernel
   launches once per int8-eligible leaf per step (51 leaves at depth 12),
   each flash kernel depth x steps.  Losses finite and falling, the first
   equal to phase 7's first to 1e-5 relative, every one within 1e-4.  One
   more step runs under torch.profiler.  Then one wrapper step of the
   ``head`` leaf is replayed from the trained state on the kernels and on
   the plain codec: bit-identical, the residual bit for bit ``g - Q(g)``,
   momentum and parameter within a bf16 step of the step written out.
13. NCCL ring: two processes, one card each, only with two or more cards;
   otherwise a line says it did not run.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL_O = 2e-2                 # bf16 output max abs error
TOL_LSE = 1e-3               # f32 lse max abs error
TOL_GRAD = 1e-2              # relative Frobenius error of dq/dk/dv
SEED = 0

# Training shape of the headline leg (bench.py:332-356).
VOCAB, DIM, DEPTH, HEADS, SEQ, BATCH = 32768, 2048, 12, 16, 2048, 8
WARMUP, TIMED = 2, 5
FLASH = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
FUSED = "flash_bwd_fused"
CODEC_N = VOCAB * DIM              # the head leaf: 67,108,864 elements
RING_RANKS, RING_N = 4, 16_777_216
TOL_RING = 5e-2                    # ring vs f32 mean, relative Frobenius
TOL_FIRST_LOSS = 1e-5              # int8 phase vs plain phase, relative
# Every int8 loss against the plain phase's, relative: about 8x the
# 1.21e-5 measured on an H100 80GB HBM3 at 700 W (PERF.md, PR 2).
TOL_LOSS_TRACK = 1e-4
# Every loss of the one-pass phase against the split phase's, relative.
# P6 sums dq with atomics in another order than P3, and dk and dv in
# another order than P2, so the gradients differ in their last bits and
# the losses drift apart a little: about 7x the 1.51e-5 measured on an
# H100 80GB HBM3 at 700 W (PERF.md).
TOL_ONE_PASS = 1e-4
GENERAL = ("flash_fwd_general", "flash_bwd_dkdv_general",
           "flash_bwd_dq_general")
# The general family in f32 against the plain versions in f32 with TF32
# off: the same products summed in another order, a few 1e-7 relative
# (2.5e-7 measured on an H100 80GB HBM3 at 700 W, PERF.md); 1e-5 leaves
# room.  lse reaches ~10, so 1e-4 absolute is the same margin.
TOL_F32 = 1e-5
TOL_F32_LSE = 1e-4
# f32 models against attn="full": the reference's own tolerance
# (tests/test_flash_attention.py:274-300, rtol = atol = 1e-4).
TOL_MODEL = 1e-4
# The ptxas entry of each kernel of the kernels line (the instantiation
# the training shape runs: D 128, or f32 for the general family).
PTXAS_NAMES = {
    "flash_fwd": "flash_fwd_kernelILi128E",
    "flash_bwd_dkdv": "flash_bwd_dkdv_kernelILi128E",
    "flash_bwd_dq": "flash_bwd_dq_kernelILi128E",
    "flash_bwd_fused": "flash_bwd_fused_kernelILi128E",
    "int8_quantize": "int8_quantize_kernel",
    "int8_dequantize": "int8_dequantize_kernel",
    "flash_fwd_general": "flash_fwd_general_kernelIfE",
    "flash_bwd_dkdv_general": "flash_bwd_dkdv_general_kernelIfE",
    "flash_bwd_dq_general": "flash_bwd_dq_general_kernelIfE",
}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _clocks() -> str:
    """The card's SM clock, power draw and temperature right now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, runs: int = 20, warmup: int = 3, reps: int = 10) -> float:
    """Median over ``runs`` of the CUDA-event time of ``reps`` back-to-back
    calls of ``fn()``, per call.  Events around a single call would also
    count the host's launch overhead (tens of microseconds for a wrapper
    that encodes tensor maps) whenever that exceeds the device's time
    queued ahead; a batch keeps the device busy from the first call on."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_fro(a, b) -> float:
    d = torch.linalg.vector_norm(a.float() - b.float()).item()
    return d / max(torch.linalg.vector_norm(b.float()).item(), 1e-30)


def _visible_pairs(T: int, causal: bool, seq_len) -> int:
    n = T if seq_len is None else seq_len
    return n * (n + 1) // 2 if causal else n * n


def phase_device():
    import horovod_tpu_torch
    from horovod_tpu_torch.ops import _cuda
    here = Path(__file__).resolve().parent
    _check(Path(horovod_tpu_torch.__file__).resolve().parents[1] == here,
           f"horovod_tpu_torch was imported from {horovod_tpu_torch.__file__}"
           f", not from this checkout ({here})")
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    libs, seconds, log = _cuda.build()
    print(f"kernels built in {seconds:.1f} s: "
          + ", ".join(p.name for p in libs.values()))
    # ptxas' registers and spills for the kernels of the kernels line, and
    # any ptxas warning (a setmaxnreg that ptxas ignored, or wgmma
    # instructions it serialized, shows there).
    lines = log.splitlines()
    usage = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            for name, key in PTXAS_NAMES.items():
                if key not in line:
                    continue
                text = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", text)
                usage[name] = {
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                    if spill else None)}
        elif "warning" in line.lower():
            print(f"  {line.strip()}")
    for name in PTXAS_NAMES:
        _check(name in usage, f"no ptxas entry for {name}")
        print(f"  {name}: {usage[name]['registers']} registers, "
              f"{usage[name]['spill_bytes']} bytes spilled")
    return usage


def _case(B, H, T, D, causal, seq_len, gen, dtype=torch.bfloat16):
    """q/k/v as column regions of one (B, T, 3C) projection, dO."""
    C = H * D
    qkv = torch.randn((B, T, 3 * C), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    do = torch.randn((B, T, C), generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    return dict(q=q, k=k, v=v, do=do, H=H, D=D, T=T, B=B, causal=causal,
                seq_len=seq_len, scale=1.0 / math.sqrt(D), dtype=dtype)


def _run_case(c, label, timing=False):
    """Hold the three kernels against their plain versions on one case;
    with ``timing``, also time kernel, plain and library call."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dk_ref, dv_ref = fa._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, H,
                                              **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    dq_ref = fa._flash_bwd_dq_plain(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    errs = {
        "o": _max_abs(o, o_ref), "lse": _max_abs(lse, lse_ref),
        "dk": _rel_fro(dk, dk_ref), "dv": _rel_fro(dv, dv_ref),
        "dq": _rel_fro(dq, dq_ref),
        "dq_abs": _max_abs(dq, dq_ref),
        "dkdv_abs": max(_max_abs(dk, dk_ref), _max_abs(dv, dv_ref)),
    }
    print(f"  {label}: o max abs {errs['o']:.3e}, lse max abs "
          f"{errs['lse']:.3e}, rel fro dq {errs['dq']:.3e} dk "
          f"{errs['dk']:.3e} dv {errs['dv']:.3e}")
    for name in ("o", "lse", "dq", "dk", "dv"):
        _check(math.isfinite(errs[name]), f"{label}: {name} not finite")
    _check(errs["o"] <= TOL_O, f"{label}: o error {errs['o']} > {TOL_O}")
    _check(errs["lse"] <= TOL_LSE,
           f"{label}: lse error {errs['lse']} > {TOL_LSE}")
    for name in ("dq", "dk", "dv"):
        _check(errs[name] <= TOL_GRAD,
               f"{label}: {name} rel error {errs[name]} > {TOL_GRAD}")
    if not timing:
        return errs, None
    del o_ref, lse_ref, dk_ref, dv_ref, dq_ref
    times = {
        "fwd": _median_ms(lambda: _cuda.flash_fwd(q, k, v, H, **kw)),
        "dkdv": _median_ms(lambda: _cuda.flash_bwd_dkdv(
            q, k, v, do, lse, delta, H, **kw)),
        "dq": _median_ms(lambda: _cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, H, **kw)),
        "fwd_plain": _median_ms(lambda: fa._flash_fwd_plain(
            q, k, v, H, **kw), runs=3, warmup=1, reps=1),
        "dkdv_plain": _median_ms(lambda: fa._flash_bwd_dkdv_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
        "dq_plain": _median_ms(lambda: fa._flash_bwd_dq_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
    }
    # Yardstick only: PyTorch's own fused attention on the same data in
    # its (B, H, T, D) layout.  The port never calls it.
    B, T, D = c["B"], c["T"], c["D"]
    F = torch.nn.functional

    def bhtd(x):
        return x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()

    qs, ks, vs = (bhtd(x).requires_grad_() for x in (q, k, v))
    dos = bhtd(do)
    times["sdpa_fwd"] = _median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=c["causal"]))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=c["causal"])
    times["sdpa_bwd"] = _median_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True))
    del out, qs, ks, vs, dos
    return errs, times


def _kernel_row(name, replaces, source, launches, err, ms, plain_ms,
                flops, nbytes, library_ms, library_call, usage,
                peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "library_call": library_call,
        "flops": flops, "bytes": nbytes, **usage,
    }


def phase_kernels():
    """Returns the timing case's numbers; the launch counts are filled in
    by the train phase."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("kernels vs plain versions (bf16):")
    _run_case(_case(2, 2, 512, 128, False, None, gen), "non-causal T=512")
    _run_case(_case(2, 3, 200, 64, True, 150, gen),
              "ragged T=200 seq_len=150 D=64")
    _run_case(_case(2, 3, 200, 80, True, 150, gen),
              "padded head T=200 seq_len=150 D=80")
    _run_case(_case(2, 2, 192, 128, True, 130, gen),
              "ragged T=192 seq_len=130 D=128")
    main = _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen)
    errs, times = _run_case(main, "main B=8 H=16 T=2048 D=128 causal",
                            timing=True)
    _check_deterministic(main)
    B, H, T, D = BATCH, HEADS, SEQ, DIM // HEADS
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 2          # one (B, T, C) bf16 tensor
    rows = B * H * T * 4                # one (B, H, T) f32 tensor
    work = {
        "flash_fwd": (4 * D * pairs, 4 * tensor + rows),
        "flash_bwd_dkdv": (8 * D * pairs, 6 * tensor + 2 * rows),
        "flash_bwd_dq": (6 * D * pairs, 5 * tensor + 2 * rows),
        # Five products per pair; q, k, v, dO read, dq, dk, dv written,
        # lse and delta read.
        FUSED: (10 * D * pairs, 7 * tensor + 2 * rows),
    }
    for name, key, lib in (("flash_fwd", "fwd", "sdpa_fwd"),
                           ("flash_bwd_dkdv", "dkdv", "sdpa_bwd"),
                           ("flash_bwd_dq", "dq", "sdpa_bwd")):
        flops = work[name][0]
        bound = flops / PEAK_BF16_FLOPS * 1e3
        print(f"  main: {name} {times[key]:.4f} ms, "
              f"{flops / times[key] / 1e9:.1f} TFLOP/s, "
              f"{bound / times[key]:.3f} of its bound ({bound:.4f} ms); "
              f"{times[key] / times[lib]:.2f}x the "
              f"scaled_dot_product_attention "
              f"{'forward' if lib == 'sdpa_fwd' else 'backward'} "
              f"({times[lib]:.4f} ms)")
    return {"errs": errs, "times": times, "work": work}


def _check_deterministic(c) -> None:
    """P1, P2 and P3 launched twice on the same inputs give the same bits
    (no atomics, a fixed order); P6 is not deterministic (its dq)."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o2, lse2 = _cuda.flash_fwd(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dk2, dv2 = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    dq2 = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    same = {"o": _bits_equal(o, o2), "lse": _bits_equal(lse, lse2),
            "dk": _bits_equal(dk, dk2), "dv": _bits_equal(dv, dv2),
            "dq": _bits_equal(dq, dq2)}
    print("  main: P1, P2 and P3 launched twice: " + ", ".join(
        f"{n} {'bit-identical' if ok else 'DIFFERENT'}"
        for n, ok in same.items()))
    _check(all(same.values()), f"P1/P2/P3 are not deterministic: {same}")


def _fused_case(c, label, timing=False):
    """Hold P6 against its plain version and against P2 + P3 on one case;
    with ``timing``, also time P6 and its plain version.  dk and dv are
    held to P2's tolerance; dq too, though P6 sums it in f32 with TMA
    adds whose order varies from run to run (a few ulps of f32 before the
    bf16 rounding that dominates)."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    got = _cuda.flash_bwd_fused(q, k, v, do, lse, delta, H, **kw)
    ref = fa._flash_bwd_fused_plain(q, k, v, do, lse, delta, H, **kw)
    dk2, dv2 = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dq2 = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    errs = {n: _rel_fro(g, r) for n, g, r in zip(names, got, ref)}
    split = {n: _rel_fro(g, r) for n, g, r in zip(names, got, (dq2, dk2,
                                                                dv2))}
    errs["abs"] = max(_max_abs(g, r) for g, r in zip(got, ref))
    same = [n for n, g, r in zip(names, got, (dq2, dk2, dv2))
            if torch.equal(g, r)]
    print(f"  {label}: rel fro vs plain dq {errs['dq']:.3e} dk "
          f"{errs['dk']:.3e} dv {errs['dv']:.3e}; vs P2 + P3 dq "
          f"{split['dq']:.3e} dk {split['dk']:.3e} dv {split['dv']:.3e} "
          f"(bit-identical: {', '.join(same) or 'none'})")
    for n in names:
        _check(math.isfinite(errs[n]) and errs[n] <= TOL_GRAD,
               f"{label}: P6 {n} rel error vs plain {errs[n]} > {TOL_GRAD}")
        _check(math.isfinite(split[n]) and split[n] <= TOL_GRAD,
               f"{label}: P6 {n} rel error vs P2 + P3 {split[n]} > "
               f"{TOL_GRAD}")
    if not timing:
        return errs, None
    del ref, dk2, dv2, dq2
    times = {
        FUSED: _median_ms(lambda: _cuda.flash_bwd_fused(
            q, k, v, do, lse, delta, H, **kw)),
        FUSED + "_plain": _median_ms(lambda: fa._flash_bwd_fused_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
    }
    return errs, times


def phase_fused_kernel(k):
    """P6 against its plain version and P2 + P3; adds its numbers to the
    kernel phase's ``k``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    print("one-pass backward P6 vs its plain version and P2 + P3 (bf16):")
    _fused_case(_case(2, 2, 512, 128, False, None, gen), "non-causal T=512")
    _fused_case(_case(2, 3, 200, 64, True, 150, gen),
                "ragged T=200 seq_len=150 D=64")
    _fused_case(_case(2, 3, 200, 80, True, 150, gen),
                "padded head T=200 seq_len=150 D=80")
    _fused_case(_case(2, 2, 192, 128, True, 130, gen),
                "ragged T=192 seq_len=130 D=128")
    errs, times = _fused_case(
        _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen),
        "main B=8 H=16 T=2048 D=128 causal", timing=True)
    t = k["times"]
    print(f"  main: P6 {times[FUSED]:.3f} ms (plain "
          f"{times[FUSED + '_plain']:.2f}) against P2 + P3 "
          f"{t['dkdv'] + t['dq']:.3f} ms and the scaled_dot_product_attention "
          f"backward {t['sdpa_bwd']:.3f} ms; bound "
          f"{k['work'][FUSED][0] / PEAK_BF16_FLOPS * 1e3:.3f} ms")
    k["errs"][FUSED] = errs["abs"]
    t.update(times)


def _run_general(c, label, timing=False):
    """G1-G3 against the plain versions on one case (the wrappers must
    route it to the general family); with ``timing``, also time kernels,
    plain versions and f32 ``scaled_dot_product_attention``."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    _check(_cuda.flash_family(q.dtype, c["D"], q.stride(), q.data_ptr())
           == "general", f"{label}: not routed to the general family")
    _cuda.reset_launches()
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o_ref, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, H, **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse_ref, delta, H, **kw)
    ref = fa._flash_bwd_fused_plain(q, k, v, do, lse_ref, delta, H, **kw)
    torch.cuda.synchronize()
    launches = {n: _cuda.LAUNCHES[n] for n in FLASH + GENERAL}
    _check(launches == {n: int(n in GENERAL) for n in launches},
           f"{label}: launches {launches}")
    errs = {"o": _rel_fro(o, o_ref), "lse": _max_abs(lse, lse_ref),
            "dq": _rel_fro(dq, ref[0]), "dk": _rel_fro(dk, ref[1]),
            "dv": _rel_fro(dv, ref[2]), "o_abs": _max_abs(o, o_ref),
            "grad_abs": max(_max_abs(g, r) for g, r in zip((dq, dk, dv),
                                                            ref))}
    print(f"  {label}: rel fro o {errs['o']:.3e} dq {errs['dq']:.3e} dk "
          f"{errs['dk']:.3e} dv {errs['dv']:.3e}, lse max abs "
          f"{errs['lse']:.3e}")
    f32 = c["dtype"] == torch.float32
    tol, tol_lse = (TOL_F32, TOL_F32_LSE) if f32 else (TOL_GRAD, TOL_LSE)
    for name in ("o", "dq", "dk", "dv"):
        _check(math.isfinite(errs[name]) and errs[name] <= tol,
               f"{label}: {name} rel error {errs[name]} > {tol}")
    _check(errs["lse"] <= tol_lse,
           f"{label}: lse error {errs['lse']} > {tol_lse}")
    if not timing:
        return errs, None
    del o_ref, ref
    slow = dict(runs=3, warmup=1, reps=2)
    times = {
        "flash_fwd_general": _median_ms(lambda: _cuda.flash_fwd(
            q, k, v, H, **kw), **slow),
        "flash_bwd_dkdv_general": _median_ms(lambda: _cuda.flash_bwd_dkdv(
            q, k, v, do, lse, delta, H, **kw), **slow),
        "flash_bwd_dq_general": _median_ms(lambda: _cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, H, **kw), **slow),
        "fwd_plain": _median_ms(lambda: fa._flash_fwd_plain(
            q, k, v, H, **kw), runs=3, warmup=1, reps=1),
        "dkdv_plain": _median_ms(lambda: fa._flash_bwd_dkdv_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
        "dq_plain": _median_ms(lambda: fa._flash_bwd_dq_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
    }
    # Yardstick only, as in _run_case, here in f32.
    D = c["D"]

    def bhtd(x):
        return x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()

    F = torch.nn.functional
    qs, ks, vs = (bhtd(x).requires_grad_() for x in (q, k, v))
    dos = bhtd(do)
    times["sdpa_fwd"] = _median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=c["causal"]), **slow)
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=c["causal"])
    times["sdpa_bwd"] = _median_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True), **slow)
    del out, qs, ks, vs, dos
    return errs, times


def phase_general():
    """G1-G3 against the plain versions: f32 at the training shape, on
    the small cases and at head sizes P1-P3 do not take, fp16, bf16 at
    D 8; D 257 raises.  Returns the training shape's numbers."""
    from horovod_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 reference
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    print("general family G1-G3 vs plain versions (f32 unless named; "
          f"tolerance f32 {TOL_F32} rel fro, fp16/bf16 {TOL_GRAD}):")
    for B, H, T, D, causal, sl, dt, label in (
            (2, 2, 512, 128, False, None, f32, "non-causal T=512"),
            (2, 3, 200, 64, True, 150, f32, "ragged T=200 seq_len=150 D=64"),
            (2, 3, 200, 80, True, 150, f32, "T=200 seq_len=150 D=80"),
            (2, 2, 192, 128, True, 130, f32, "ragged T=192 seq_len=130"),
            (2, 4, 256, 8, True, None, f32, "D=8"),
            (2, 3, 256, 12, True, 200, f32, "D=12 seq_len=200"),
            (2, 2, 256, 200, True, None, f32, "D=200"),
            (2, 2, 256, 64, True, 230, f16, "fp16 D=64 seq_len=230"),
            (2, 4, 256, 8, True, None, bf16, "bf16 D=8")):
        _run_general(_case(B, H, T, D, causal, sl, gen, dt), label)
    errs, times = _run_general(
        _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen, f32),
        "main f32 B=8 H=16 T=2048 D=128 causal", timing=True)
    for name in GENERAL:
        print(f"  main f32: {name} {times[name]:.3f} ms")
    wide = torch.zeros((1, 64, 2 * 257), device="cuda")
    try:
        _cuda.flash_fwd(wide, wide, wide, 2, scale=1.0, causal=True)
    except ValueError as e:
        print(f"  D=257: ValueError: {e}")
        _check("from 1 to 256" in str(e), f"D=257: unexpected error {e}")
    else:
        _fail("D=257 did not raise")
    B, H, T, D = BATCH, HEADS, SEQ, DIM // HEADS
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 4          # one (B, T, C) f32 tensor
    rows = B * H * T * 4
    work = {"flash_fwd_general": (4 * D * pairs, 4 * tensor + rows),
            "flash_bwd_dkdv_general": (8 * D * pairs,
                                       6 * tensor + 2 * rows),
            "flash_bwd_dq_general": (6 * D * pairs, 5 * tensor + 2 * rows)}
    return {"errs": errs, "times": times, "work": work}


def phase_models_f32():
    """The reference's f32 model checks on the card: the flash model's
    logits equal the attn="full" model's elementwise within ``TOL_MODEL``
    (relative and absolute), through the general family, and so do its
    gradients (relative Frobenius: the same f32 sums in another order).
    Counters are zeroed before each flash model's forward and backward and
    read after: G1-G3 run once per layer, P1-P3 never.  Returns the
    launches of both flash models."""
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops import _cuda
    f32 = torch.float32
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    for vocab, dim, depth, heads in ((64, 256, 1, 2), (64, 32, 2, 4)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        tokens = torch.randint(0, vocab, (2, 32), generator=gen,
                               device="cuda")
        cot = torch.randn((2, 32, vocab), generator=gen, device="cuda")
        logits, grads = {}, {}
        for attn in ("full", "flash"):
            model = TransformerLM(vocab=vocab, dim=dim, depth=depth,
                                  num_heads=heads, max_len=32, attn=attn,
                                  dtype=f32, head_dtype=f32, ln_dtype=f32,
                                  seed=SEED, device="cuda")
            _cuda.reset_launches()
            logits[attn] = model(tokens)
            (logits[attn] * cot).sum().backward()
            torch.cuda.synchronize()
            ran = dict(_cuda.LAUNCHES)
            grads[attn] = torch.cat([p.grad.flatten()
                                     for p in model.parameters()])
        a, b = logits["flash"].detach(), logits["full"].detach()
        bad = int(((a - b).abs() > TOL_MODEL + TOL_MODEL * b.abs()).sum())
        rel = _rel_fro(grads["flash"], grads["full"])
        print(f"f32 model dim {dim} heads {heads} (D {dim // heads}): "
              f"logits flash vs full max abs {_max_abs(a, b):.3e}, "
              f"{bad} outside rtol = atol = {TOL_MODEL}; gradients rel fro "
              f"{rel:.3e}; launches { {n: c for n, c in ran.items() if c} }")
        _check(bad == 0, f"f32 model dim {dim}: {bad} logits differ")
        _check(rel <= TOL_MODEL, f"f32 model dim {dim}: grads rel {rel}")
        want = {n: depth if n in GENERAL else 0 for n in FLASH + GENERAL}
        _check({n: ran[n] for n in want} == want,
               f"f32 model dim {dim}: launches {ran}")
        for n, c in ran.items():
            launches[n] += c
    return launches


def phase_reference():
    """A small model through the kernels against the oracle attention."""
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    bf16 = torch.bfloat16
    results = {}
    for attn in ("flash", "full"):
        model = TransformerLM(vocab=512, dim=256, depth=2, num_heads=2,
                              max_len=128, attn=attn, dtype=bf16,
                              head_dtype=bf16, ln_dtype=bf16, seed=SEED,
                              device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        tokens = torch.randint(0, 512, (4, 129), generator=gen,
                               device="cuda")
        h = model(tokens[:, :-1], return_hidden=True)
        loss = fused_softmax_xent(h.reshape(-1, 256), model.head.kernel,
                                  tokens[:, 1:].reshape(-1)).mean()
        loss.backward()
        grads = torch.cat([p.grad.flatten() for p in model.parameters()])
        results[attn] = (loss.item(), grads)
    (lf, gf), (lr, gr) = results["flash"], results["full"]
    rel = _rel_fro(gf, gr)
    print(f"reference: small model loss flash {lf:.6f} oracle {lr:.6f}, "
          f"grad rel fro {rel:.3e}")
    _check(math.isfinite(lf) and abs(lf - lr) <= 2e-2 * abs(lr),
           f"small-model loss {lf} vs oracle {lr}")
    _check(rel <= 5e-2, f"small-model grads rel error {rel}")


def _train_setup(depth: int):
    """The full-width model (random weights from ``SEED``), one batch and
    the loss of the headline leg."""
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    bf16 = torch.bfloat16
    model = TransformerLM(vocab=VOCAB, dim=DIM, depth=depth,
                          num_heads=HEADS, max_len=SEQ, attn="flash",
                          dtype=bf16, head_dtype=bf16, ln_dtype=bf16,
                          seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                           device="cuda")

    def loss_fn(model, batch):
        h = model(batch[:, :-1], return_hidden=True)
        return fused_softmax_xent(h.reshape(-1, DIM), model.head.kernel,
                                  batch[:, 1:].reshape(-1)).mean()

    return model, tokens, loss_fn


@contextlib.contextmanager
def _one_pass(on: bool):
    """Within the block, ``HOROVOD_TPU_FLASH_BWD=fullunroll`` when ``on``:
    the backward of every layer is then P6."""
    if on:
        os.environ.update(HOROVOD_TPU_FLASH_BWD="fullunroll")
    try:
        yield
    finally:
        if on:
            os.environ.pop("HOROVOD_TPU_FLASH_BWD", None)


def _model_flops(depth: int) -> int:
    """Model FLOPs of one step, as bench.py counts them: 6 x matmul
    parameters + 12 x depth x seq x dim per token."""
    n_matmul = 12 * depth * DIM * DIM + VOCAB * DIM
    return (6 * n_matmul + 12 * depth * SEQ * DIM) * (BATCH * SEQ)


def phase_train(depth: int, one_pass: bool = False):
    """The headline step; with ``one_pass``, under
    ``HOROVOD_TPU_FLASH_BWD=fullunroll``."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.spmd import make_train_step
    label = "train one-pass" if one_pass else "train"
    torch.cuda.reset_peak_memory_stats()
    model, tokens, loss_fn = _train_setup(depth)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt)
    torch.cuda.synchronize()
    with _one_pass(one_pass):
        _cuda.reset_launches()
        losses, times = [], []
        for i in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            loss = step(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
        launches = dict(_cuda.LAUNCHES)
    steps = WARMUP + TIMED
    step_s = statistics.median(times[WARMUP:])
    tokens_per_s = BATCH * SEQ / step_s
    mfu = _model_flops(depth) / step_s / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: depth {depth} of {DEPTH}, losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"{label}: step {step_s * 1e3:.1f} ms (median of {TIMED}; all "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms), "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.3f} at 989 TFLOP/s, "
          f"peak memory {peak_gb:.2f} GiB, launches {launches}")
    print(f"{label}: after the timed steps, SM clock, power, temperature: "
          f"{_clocks()}")
    _check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    _check(losses[-1] < losses[0],
           f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    bwd = (FUSED,) if one_pass else FLASH[1:]
    for name in FLASH + (FUSED,) + GENERAL:
        want = depth * steps if name == "flash_fwd" or name in bwd else 0
        _check(launches[name] == want,
               f"{label}: {name} launched {launches[name]} times, expected "
               f"{want}")
    with _one_pass(one_pass):
        _profile_step(step, tokens)
    return {"launches": launches, "losses": losses, "step_s": step_s}


def check_one_pass(one: dict, plain: dict) -> None:
    """The one-pass phase's losses against the split phase's: the first
    bit for bit (the forward is the same), every one within
    ``TOL_ONE_PASS``."""
    track = max(abs(a - b) / abs(b) for a, b in zip(one["losses"],
                                                     plain["losses"]))
    print(f"train one-pass: step {one['step_s'] * 1e3:.1f} ms against "
          f"{plain['step_s'] * 1e3:.1f} ms split; first loss "
          f"{'bit-identical' if one['losses'][0] == plain['losses'][0] else 'DIFFERENT'}"
          f", every loss vs split {track:.2e} relative at most")
    _check(one["losses"][0] == plain["losses"][0],
           f"one-pass first loss {one['losses'][0]} differs from the split "
           f"phase's {plain['losses'][0]}")
    _check(track <= TOL_ONE_PASS,
           f"one-pass losses {one['losses']} stray from the split phase's "
           f"{plain['losses']}")


def phase_routing():
    """``bwd_impl`` picks the backward on the card as the JAX package
    does: P6 while T * D * 4 bytes <= 4 MiB, else P2 + P3; ``"xla"`` is
    plain PyTorch and agrees with the split pair."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, H, D = 2, HEADS, DIM // HEADS

    def inputs(T):
        ins = [torch.randn((B, T, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3)]
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        return ins, g

    def run(T, impl, ins, g):
        _cuda.reset_launches()
        grads = torch.autograd.grad(flash_attention(*ins, bwd_impl=impl),
                                    ins, g)
        torch.cuda.synchronize()
        return grads, {n: _cuda.LAUNCHES[n] for n in FLASH[1:] + (FUSED,)}

    def routed(T, impl, ins, g, want):
        grads, launches = run(T, impl, ins, g)
        print(f"routing: T={T} bwd_impl={impl!r}, T*D*4 = "
              f"{T * D * 4 / 2 ** 20:g} MiB: backward launches {launches}")
        _check(tuple(launches.values()) == want,
               f"routing: T={T} {impl}: launches {launches}, expected "
               f"{dict(zip(launches, want))}")
        return grads

    ins, g = inputs(8192)
    fused = routed(8192, "pallas_fused", ins, g, (0, 0, 1))
    split = routed(8192, "pallas", ins, g, (1, 1, 0))
    errs = [_rel_fro(a, b) for a, b in zip(fused, split)]
    print("routing: T=8192 P6 vs P2 + P3 gradients, rel fro "
          + ", ".join(f"{e:.3e}" for e in errs))
    _check(max(errs) <= TOL_GRAD, f"routing: P6 vs split {errs}")
    del ins, g, fused, split
    ins, g = inputs(16384)
    routed(16384, "pallas_fused", ins, g, (1, 1, 0))
    del ins, g
    ins, g = inputs(SEQ)
    split, _ = run(SEQ, "pallas", ins, g)
    t0 = time.perf_counter()
    xla, launches = run(SEQ, "xla", ins, g)
    seconds = time.perf_counter() - t0
    errs = [_rel_fro(a, b) for a, b in zip(xla, split)]
    print(f"routing: T={SEQ} bwd_impl='xla' (plain PyTorch, "
          f"{seconds * 1e3:.1f} ms host clock for forward and backward) vs "
          f"P2 + P3, rel fro " + ", ".join(f"{e:.3e}" for e in errs)
          + f"; kernel launches in its backward {launches}")
    _check(not any(launches.values()),
           f"routing: the xla backward launched kernels {launches}")
    _check(max(errs) <= TOL_GRAD, f"routing: xla vs split {errs}")


# --------------------------------------------------------------------------
# The int8 codec (P4, P5), the ring and the DistributedOptimizer.


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _snap_plain(x):
    """``snap_to_grid`` on the plain codec."""
    from horovod_tpu_torch.ops import quantized_collectives as qc
    n = x.numel()
    flat = torch.nn.functional.pad(x.reshape(-1).float(),
                                   (0, -n % qc.BLOCK_ELEMS))
    q, s = qc._quantize_plain(flat.reshape(-1, qc.BLOCK_ELEMS))
    return qc._dequantize_plain(q, s).reshape(-1)[:n].reshape(x.shape)


def _edge_blocks(gen):
    """Five 1024-element blocks: all zero; two tiny normal values; a
    subnormal absmax; values near 1e38; randn * exp(U(-6, 6))."""
    def uniform(lo, hi):
        return torch.rand(1024, generator=gen, device="cuda") * (hi - lo) \
            + lo

    zero = torch.zeros(1024, device="cuda")
    tiny = torch.zeros(1024, device="cuda")
    tiny[7], tiny[100] = 2e-38, -1.5e-38
    sub = uniform(-1.1e-38, 1.1e-38)
    big = uniform(-1e38, 1e38)
    big[5] = 3e38
    wide = torch.randn(1024, generator=gen, device="cuda") \
        * torch.exp(uniform(-6, 6))
    return torch.cat([zero, tiny, sub, big, wide])


def _codec_agrees(x, label):
    """P4 and P5 against their plain versions on ``x`` (a multiple of 1024
    elements), bit for bit."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    grid = x.reshape(-1, qc.BLOCK_ELEMS)
    q, s = _cuda.int8_quantize(grid)
    q_ref, s_ref = qc._quantize_plain(grid)
    d = _cuda.int8_dequantize(q_ref, s_ref)
    d_ref = qc._dequantize_plain(q_ref, s_ref)
    torch.cuda.synchronize()
    ok = {"q": _bits_equal(q, q_ref), "scales": _bits_equal(s, s_ref),
          "dequantized": _bits_equal(d, d_ref)}
    print(f"  {label}: " + ", ".join(
        f"{k} {'bit-identical' if v else 'DIFFERENT'}" for k, v in ok.items())
        + f"; max abs error of the round trip vs input "
        f"{_max_abs(d, x.reshape(grid.shape)):.3e}")
    _check(all(ok.values()), f"{label}: codec kernel differs from its "
           f"plain version: {ok}")
    return max(_max_abs(d, d_ref), _max_abs(q, q_ref), _max_abs(s, s_ref))


def phase_codec():
    """Returns the timing shape's numbers; launches come from the int8
    train phase."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    print("int8 codec kernels vs plain versions:")
    _codec_agrees(_edge_blocks(gen), "edge blocks")
    tail = torch.randn(1025, generator=gen, device="cuda")
    snapped, snapped_ref = qc.snap_to_grid(tail), _snap_plain(tail)
    torch.cuda.synchronize()
    print(f"  1025-element tail through snap_to_grid: "
          f"{'bit-identical' if _bits_equal(snapped, snapped_ref) else 'DIFFERENT'}")
    _check(_bits_equal(snapped, snapped_ref), "snap_to_grid tail differs")
    x = torch.randn(CODEC_N, generator=gen, device="cuda") \
        * torch.exp(torch.rand(CODEC_N, generator=gen, device="cuda") * 12
                    - 6)
    err = _codec_agrees(x, f"n={CODEC_N}")
    grid = x.reshape(-1, qc.BLOCK_ELEMS)
    q, s = _cuda.int8_quantize(grid)
    times = {
        "int8_quantize": _median_ms(lambda: _cuda.int8_quantize(grid)),
        "int8_dequantize": _median_ms(lambda: _cuda.int8_dequantize(q, s)),
        "int8_quantize_plain": _median_ms(lambda: qc._quantize_plain(grid)),
        "int8_dequantize_plain": _median_ms(
            lambda: qc._dequantize_plain(q, s)),
        # Yardstick only: one PyTorch call, int8 x f32 promoted to f32.
        "int8_dequantize_library": _median_ms(lambda: torch.mul(q, s)),
    }
    lib_same = _bits_equal(torch.mul(q, s), qc._dequantize_plain(q, s))
    blocks = CODEC_N // qc.BLOCK_ELEMS
    nbytes = CODEC_N * 4 + CODEC_N + blocks * 4   # f32 <-> int8 + scales
    print(f"  n={CODEC_N}: quantize {times['int8_quantize']:.4f} ms (plain "
          f"{times['int8_quantize_plain']:.4f}), dequantize "
          f"{times['int8_dequantize']:.4f} ms (plain "
          f"{times['int8_dequantize_plain']:.4f}, torch.mul "
          f"{times['int8_dequantize_library']:.4f}, "
          f"{'bit-identical' if lib_same else 'DIFFERENT'}); bound "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms each ({nbytes} bytes at "
          f"3.35 TB/s)")
    _check(lib_same, "torch.mul(q, scales) differs from the plain "
           "dequantize")
    return {"err": err, "times": times, "work": {
        # abs, max, scale, clamp x2, round per element; a convert and a
        # multiply per element.
        "int8_quantize": (6 * CODEC_N, nbytes),
        "int8_dequantize": (2 * CODEC_N, nbytes)}}


class _PlainCodec:
    """Within the block, the codec's CUDA entry points run the plain
    versions: the ring on the same data without the kernels."""

    def __enter__(self):
        from horovod_tpu_torch.ops import _cuda
        from horovod_tpu_torch.ops import quantized_collectives as qc
        self.saved = (_cuda.int8_quantize, _cuda.int8_dequantize)
        _cuda.int8_quantize = qc._quantize_plain
        _cuda.int8_dequantize = qc._dequantize_plain

    def __exit__(self, *exc):
        from horovod_tpu_torch.ops import _cuda
        _cuda.int8_quantize, _cuda.int8_dequantize = self.saved


def _ring_inputs(rank: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + rank)
    return torch.randn(RING_N, generator=gen, device="cuda") * (1 + rank)


def phase_ring():
    from horovod_tpu_torch.ops import quantized_collectives as qc
    xs = [_ring_inputs(r) for r in range(RING_RANKS)]
    t0 = time.perf_counter()
    out = qc.lockstep_ring_allreduce(xs, average=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with _PlainCodec():
        ref = qc.lockstep_ring_allreduce(xs, average=True)
    mean = torch.stack(xs).mean(0)
    rel = _rel_fro(out[0], mean)
    same = all(_bits_equal(o, r) for o, r in zip(out, ref))
    print(f"ring: {RING_RANKS} ranks in lockstep x {RING_N} elements, "
          f"kernels vs plain codec "
          f"{'bit-identical' if same else 'DIFFERENT'}, rel fro vs f32 "
          f"mean {rel:.3e}, {seconds * 1e3:.1f} ms host clock")
    _check(same, "ring on the kernels differs from the ring on the plain "
           "codec")
    _check(rel <= TOL_RING, f"ring vs mean rel error {rel} > {TOL_RING}")


def phase_train_int8(depth: int, plain: dict):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    torch.cuda.reset_peak_memory_stats()
    model, tokens, loss_fn = _train_setup(depth)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=hvd.Compression.int8, error_feedback=True)
    leaves = sum(qc.int8_eligible(p.shape, p.dtype)
                 for p in model.parameters())
    _check(leaves == 3 + 4 * depth,
           f"{leaves} int8-eligible leaves, expected {3 + 4 * depth}")

    def step(batch):
        opt.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses, times = [], []
    for _ in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(_cuda.LAUNCHES)
    steps = WARMUP + TIMED
    step_s = statistics.median(times[WARMUP:])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    first = abs(losses[0] - plain["losses"][0]) / abs(plain["losses"][0])
    track = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    print(f"train int8: depth {depth}, DistributedOptimizer(SGD momentum, "
          f"int8, error feedback), losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"train int8: step {step_s * 1e3:.1f} ms against "
          f"{plain['step_s'] * 1e3:.1f} ms plain (median of {TIMED}; all "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms), "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, MFU "
          f"{_model_flops(depth) / step_s / PEAK_BF16_FLOPS:.3f} at 989 "
          f"TFLOP/s, peak memory "
          f"{peak_gb:.2f} GiB, {leaves} int8 leaves, first loss vs plain "
          f"{first:.2e} relative, every loss vs plain {track:.2e} at most, "
          f"launches {launches}")
    print(f"train int8: after the timed steps, SM clock, power, "
          f"temperature: {_clocks()}")
    _check(all(math.isfinite(x) for x in losses), "int8: non-finite loss")
    _check(losses[-1] < losses[0],
           f"int8: loss did not fall: {losses[0]} -> {losses[-1]}")
    _check(first <= TOL_FIRST_LOSS,
           f"int8: first loss {losses[0]} vs plain {plain['losses'][0]}")
    _check(track <= TOL_LOSS_TRACK,
           f"int8: losses {losses} stray from plain {plain['losses']}")
    for name in FLASH:
        _check(launches[name] == depth * steps,
               f"int8: {name} launched {launches[name]} times, expected "
               f"{depth * steps}")
    for name in ("int8_quantize", "int8_dequantize"):
        _check(launches[name] == leaves * steps,
               f"int8: {name} launched {launches[name]} times, expected "
               f"{leaves * steps}")
    _profile_step(step, tokens)
    _replay_head_step(model, opt, tokens, loss_fn)
    return {"launches": launches, "losses": losses, "step_s": step_s}


def _replay_head_step(model, opt, tokens, loss_fn) -> None:
    """The wrapper's arithmetic on the card: one ``DistributedOptimizer``
    step of the ``head`` leaf from the trained state (parameter, momentum,
    residual) and its gradient there, on the kernels and on the plain
    codec.  The two must agree bit for bit, and with the step written out
    here: carry-in ``g + r``, residual ``g - Q(g)`` (bit for bit), momentum
    ``0.9 buf + g`` and ``p - lr buf`` (each element to one bf16 step of
    its value; at world size 1 the reduction is the identity)."""
    import contextlib
    import horovod_tpu_torch as hvd
    src = model.head.kernel
    grad, = torch.autograd.grad(loss_fn(model, tokens), [src])
    st = opt.state[src]
    lr, momentum = opt.param_groups[0]["lr"], 0.9
    out = []
    for codec in (contextlib.nullcontext(), _PlainCodec()):
        p = torch.nn.Parameter(src.detach().clone())
        one = hvd.DistributedOptimizer(
            torch.optim.SGD([p], lr=lr, momentum=momentum),
            compression=hvd.Compression.int8, error_feedback=True,
            overlap=False)
        one.state[p]["momentum_buffer"] = st["momentum_buffer"].clone()
        one.state[p]["residual"] = st["residual"].clone()
        p.grad = grad.clone()
        with codec:
            one.step()
        out.append((p.detach(), one.state[p]["momentum_buffer"],
                    one.state[p]["residual"]))
    g = grad + st["residual"].to(grad.dtype)
    residual = g.float() - _snap_plain(g.float())
    buf = st["momentum_buffer"] * momentum + g
    param = torch.add(src.detach(), buf, alpha=-lr)

    def off(a, b):
        """Elements of ``a`` more than one bf16 step from ``b``."""
        a, b = a.float(), b.float()
        return int(((a - b).abs() > 2 ** -7 * b.abs()).sum().item())

    same = all(_bits_equal(a, b) for a, b in zip(*out))
    res_ok = _bits_equal(out[0][2], residual)
    buf_off, p_off = off(out[0][1], buf), off(out[0][0], param)
    moved = int((out[0][0] != src.detach()).sum().item())
    print(f"train int8: one head step replayed, kernels vs plain codec "
          f"{'bit-identical' if same else 'DIFFERENT'}; residual vs "
          f"g - Q(g) {'bit-identical' if res_ok else 'DIFFERENT'} (max "
          f"{residual.abs().max().item():.3e}); momentum and parameter vs "
          f"the step written out: {buf_off} and {p_off} elements more than "
          f"one bf16 step off, {_max_abs(out[0][1], buf):.3e} and "
          f"{_max_abs(out[0][0], param):.3e} max abs; {moved} of "
          f"{src.numel()} parameters moved")
    _check(same, "int8: the wrapper's step on the kernels differs from the "
           "plain codec")
    _check(res_ok, "int8: the residual is not g - Q(g) of the carried-in "
           "gradient")
    _check(buf_off == 0 and p_off == 0,
           f"int8: {buf_off} momentum and {p_off} parameter elements off "
           f"the step")
    _check(moved > 0 and residual.abs().max().item() > 0,
           "int8: the replayed step moved nothing")


def _nccl_worker(rank: int, port: int, results) -> None:
    try:
        import torch.distributed as dist
        from horovod_tpu_torch.ops import quantized_collectives as qc
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        out = qc.quantized_ring_allreduce(_ring_inputs(rank), average=True)
        want = qc.lockstep_ring_allreduce(
            [_ring_inputs(r) for r in range(2)], average=True)[rank]
        torch.cuda.synchronize()
        ok = _bits_equal(out, want)
        dist.destroy_process_group()
        results.put((rank, ok))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_nccl_ring():
    if torch.cuda.device_count() < 2:
        print("nccl ring: not run (one CUDA device; it needs two)")
        return
    import queue
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_nccl_worker, args=(r, port, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + 300
    try:
        while len(got) < len(procs):
            try:
                rank, ok = results.get(timeout=5)
                got[rank] = ok
            except queue.Empty:
                if time.monotonic() > deadline:
                    got["timeout"] = "no result within 300 s"
                    break
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    got["exit"] = f"a worker exited with {dead}"
                    break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    print(f"nccl ring: 2 processes x {RING_N} elements, distributed vs "
          f"lockstep ring: {got}")
    _check(got == {0: True, 1: True}, f"nccl ring failed: {got}")


def _category(name: str) -> str:
    for kernel in GENERAL + FLASH + (FUSED, "int8_quantize",
                                     "int8_dequantize"):
        if f"{kernel}_" in name:   # P6's dq cast kernel counts as P6
            return kernel
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                              "cublas")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "copy", "fill")):
        return "elementwise and copies"
    return "other"


def _profile_step(step, tokens) -> None:
    """One more step under torch.profiler: device time by kernel and
    category, and the device's busy share of the (profiled) step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        print("profile: the profiler recorded no device time")
        return
    print(f"profile: one step {wall_ms:.1f} ms wall under the profiler, "
          f"{busy:.1f} ms of kernels, device busy "
          f"{busy / wall_ms:.3f}")
    cats: dict = {}
    for name, ms, _ in kernels:
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {ms:.2f} ms ({ms / busy:.3f} of kernel time)")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  top: {ms:8.2f} ms x{n:<4d} {name[:90]}")


# Every TPU kernel of the JAX package (each function that reaches
# pl.pallas_call), in PERF.md's order, with the port kernel that replaces
# it.
TPU_KERNELS = (
    ("flash_fwd", "horovod_tpu/ops/flash_attention.py:255"),
    ("flash_fwd", "horovod_tpu/ops/flash_attention.py:351"),
    ("flash_fwd", "horovod_tpu/ops/flash_attention.py:418"),
    ("flash_bwd_dkdv", "horovod_tpu/ops/flash_attention.py:675"),
    ("flash_bwd_dq", "horovod_tpu/ops/flash_attention.py:730"),
    ("flash_bwd_dkdv", "horovod_tpu/ops/flash_attention.py:955"),
    ("flash_bwd_dq", "horovod_tpu/ops/flash_attention.py:1013"),
    (FUSED, "horovod_tpu/ops/flash_attention.py:776"),
    (FUSED, "horovod_tpu/ops/flash_attention.py:1152"),
    ("int8_quantize", "horovod_tpu/ops/quantized_collectives.py:166"),
    ("int8_dequantize", "horovod_tpu/ops/quantized_collectives.py:176"),
)
SOURCES = {
    "flash_fwd": "horovod_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dkdv": "horovod_tpu_torch/csrc/flash_bwd_dkdv.cu",
    "flash_bwd_dq": "horovod_tpu_torch/csrc/flash_bwd_dq.cu",
    FUSED: "horovod_tpu_torch/csrc/flash_bwd_fused.cu",
    "int8_quantize": "horovod_tpu_torch/csrc/int8_codec.cu",
    "int8_dequantize": "horovod_tpu_torch/csrc/int8_codec.cu",
    "general": "horovod_tpu_torch/csrc/flash_general.cu",
}
SDPA_BWD = "scaled_dot_product_attention backward (dq, dk and dv)"


def main() -> None:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this needs a CUDA GPU")
    gpu = _gpu_line()
    usage = phase_device()
    import horovod_tpu_torch as hvd
    hvd.init()
    k = phase_kernels()
    phase_fused_kernel(k)
    general = phase_general()
    f32_launches = phase_models_f32()
    gc.collect()
    torch.cuda.empty_cache()
    phase_reference()
    plain = phase_train(DEPTH)
    gc.collect()
    torch.cuda.empty_cache()
    one = phase_train(DEPTH, one_pass=True)
    check_one_pass(one, plain)
    gc.collect()
    torch.cuda.empty_cache()
    phase_routing()
    gc.collect()
    torch.cuda.empty_cache()
    codec = phase_codec()
    phase_ring()
    int8 = phase_train_int8(DEPTH, plain)
    phase_nccl_ring()
    t, e = k["times"], k["errs"]
    flash = {
        "flash_fwd": (t["fwd"], t["fwd_plain"], e["o"], t["sdpa_fwd"],
                      "scaled_dot_product_attention forward",
                      plain["launches"]),
        "flash_bwd_dkdv": (t["dkdv"], t["dkdv_plain"], e["dkdv_abs"],
                           t["sdpa_bwd"], SDPA_BWD, plain["launches"]),
        "flash_bwd_dq": (t["dq"], t["dq_plain"], e["dq_abs"], t["sdpa_bwd"],
                         SDPA_BWD, plain["launches"]),
        FUSED: (t[FUSED], t[FUSED + "_plain"], e[FUSED], t["sdpa_bwd"],
                SDPA_BWD, one["launches"]),
    }
    rows = []
    for name, rep in TPU_KERNELS:
        if name in flash:
            ms, plain_ms, err, lib, call, launches = flash[name]
            flops, nbytes = k["work"][name]
            rows.append(_kernel_row(name, rep, SOURCES[name], launches[name],
                                    err, ms, plain_ms, flops, nbytes, lib,
                                    call, usage[name]))
            continue
        lib, call = None, None
        if name == "int8_dequantize":
            lib = codec["times"]["int8_dequantize_library"]
            call = "torch.mul (int8 x f32 promotion)"
        flops, nbytes = codec["work"][name]
        rows.append(_kernel_row(
            name, rep, SOURCES[name], int8["launches"][name], codec["err"],
            codec["times"][name], codec["times"][name + "_plain"], flops,
            nbytes, lib, call, usage[name], peak_flops=PEAK_F32_FLOPS))
    # The general family: the same TPU kernels, for the inputs P1-P3 do
    # not take; timed in f32 at the training shape, launched by the f32
    # models.
    gt, ge = general["times"], general["errs"]
    for name, rep, plain_key, err, lib, call in (
            ("flash_fwd_general", "horovod_tpu/ops/flash_attention.py:255",
             "fwd_plain", ge["o_abs"], gt["sdpa_fwd"],
             "scaled_dot_product_attention forward, f32"),
            ("flash_bwd_dkdv_general",
             "horovod_tpu/ops/flash_attention.py:675", "dkdv_plain",
             ge["grad_abs"], gt["sdpa_bwd"], SDPA_BWD + ", f32"),
            ("flash_bwd_dq_general", "horovod_tpu/ops/flash_attention.py:730",
             "dq_plain", ge["grad_abs"], gt["sdpa_bwd"], SDPA_BWD + ", f32")):
        flops, nbytes = general["work"][name]
        rows.append(_kernel_row(
            name, rep, SOURCES["general"], f32_launches[name], err, gt[name],
            gt[plain_key], flops, nbytes, lib, call, usage[name],
            peak_flops=PEAK_F32_FLOPS))
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
