"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without a CUDA device or outside
the checkout.  Phases, in order; any failure ends the run:

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``horovod_tpu_torch/csrc`` (timed), with ptxas'
   registers and spills for each kernel of the ``kernels`` line and for
   each of the 24 instantiations of G1-G3 (none may spill).
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
   the small cases, at D 1, 8, 12, 13, 129 (two dk/dv column halves),
   200 and 256, T 1 and seq_len 1, in fp16 at D 12 and 64 and in bf16 at
   D 8, 13 and 256 (each staging copy width: 16 bytes, 4, one element),
   with TF32 off so that the f32 reference is full f32; G1-G3 launched
   twice on the training shape must give the same bits; timed at the
   training shape in f32 beside the plain versions, both bounds (FFMA,
   and the three TF32 products G1-G3 run) and f32
   ``scaled_dot_product_attention``, whose kernels are named from the
   profiler (G2 + G3 beside its backward).  Then the wide route W1-W3
   (``flash_wide.cu``, head sizes above 256) against the plain versions
   in f32 at D 264, 384 and 1000 (B 1, H 2, T 512, causal; 1e-5) and in
   bf16 at D 320 with a ragged seq_len; W1-W3 launched twice give the
   same bits; timed at D 384 beside f32 ``scaled_dot_product_attention``,
   whose kernels (the backend PyTorch picked) are named.
5. f32 models: the reference's own checks
   (``tests/test_flash_attention.py``): ``TransformerLM(dim=256,
   num_heads=2, attn="flash", dtype=float32)`` (D 128 through
   ``flash_qkv_proj``), dim 32 with 4 heads (D 8 through
   ``flash_attention_auto``) and dim 768 with 2 heads (D 384) against
   ``attn="full"`` on the card, logits within 1e-4; G1-G3 run (W1-W3 at
   D 384), P1-P3 do not (counters zeroed just before).
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
14. ResNet steps_per_call: a small ResNet (stages [1, 1], 8 filters, bf16)
   on the card, one call with ``steps_per_call=3`` against three
   single-step calls on the same batches: the call's loss equals the
   mean of theirs within 1e-5 relative.
15. ResNet-50 against the CPU: the full-width model with the last
   BatchNorm scale of every block drawn from U(0.05, 0.15) (zero at init,
   which leaves the blocks' convolutions without a gradient), one
   train-mode forward and backward of 4 random 224 x 224 images with
   random labels on the card and on the CPU from the same state: in f32
   (TF32 off) the loss and logits within 1e-4 relative, all gradients
   together within 1e-2, every gradient and buffer within 5e-2; in bf16
   the loss and the logits within 2e-2.  The CPU pass on inputs moved by
   1e-6 prints how far the problem amplifies such a change (the floor the
   limits sit a few times above).
16. ResNet-50 (the bench's judged leg, ``bench.py:150-256``):
   ``ResNet50(num_classes=1000)`` in bf16, batch 128 of 224 x 224 NHWC
   images from a seeded generator, zero labels, SGD lr 0.01 momentum 0.9
   through ``make_train_step(sync_aux_state=True)``.  After its first
   step ``bn_init``'s running mean must equal 0.1 x the f32 batch mean of
   ``conv_init``'s output computed directly, and its running var 0.9 +
   0.1 x the biased variance (1e-3 relative).  Then 1 warm-up call and 3
   timed calls with ``steps_per_call=5``: images/s per GPU, ms per step,
   MFU by ``bench.py:270-281``'s formula (3 x 4.1e9 x images / 989
   TFLOP/s; 4.1e9 counts multiply-accumulates), peak memory, clocks.
   Losses finite and falling, no port kernel launched (the leg runs
   cuDNN convolutions and PyTorch elementwise ops, as the JAX package
   runs XLA's), an eval step's logits finite; one profiled step by
   category (convolution, BatchNorm and elementwise, other).
17. Hierarchical NCCL: four processes, one card each, on two fake hosts
   (``HOROVOD_TPU_HOST_FINGERPRINT`` A, A, B, B), only with four or more
   cards; otherwise a line says it did not run.  The two-tier allreduce
   of integer-valued f32 equals the flat ``all_reduce`` bit for bit;
   ``reduce_gradients(compression="int8", mesh=)`` launches P4 and P5,
   equals the plain codec's snap reduced over the mesh bit for bit and
   the flat sum of that snap within 1e-2; two small-ResNet steps on
   ``hierarchical_mesh()`` match the flat steps within 1e-5 relative.
18. Eager plane, one card: ``hvd.allreduce`` (sum and average),
   ``allgather`` and ``broadcast`` of CUDA f32, bf16 and int64 tensors,
   async with ``poll`` and ``synchronize``, equal to what one rank gives;
   the latency of one 4 KiB allreduce; a burst of 64 async 1 MiB f32
   allreduces three times, fused into 64 MiB responses and served from
   the response cache from the second burst on (``hvd.metrics()``), timed
   beside one ``dist.all_reduce`` of the same 64 MiB on a one-rank NCCL
   group.  The controller's background thread ticks beside every phase
   above (``hvd.init()`` starts it).
19. Eager plane, NCCL: four processes, one card each, launched without
   ``HOROVOD_TPU_LOCAL_RANK``, only with four or more cards; otherwise a
   line says it did not run.  Host discovery must give four distinct
   GPUs; each fused eager allreduce (f32, bf16, int64) equals
   ``dist.all_reduce`` of the same fused buffer bit for bit; the integer
   average floor-divides; a ragged allgather and a broadcast are exact; a
   dtype mismatch raises the coordinator's error on every rank; then the
   phase-18 latency and burst on four cards.

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
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor cores
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
WIDE = ("flash_fwd_wide", "flash_bwd_dkdv_wide", "flash_bwd_dq_wide")
GENERAL = ("flash_fwd_general", "flash_bwd_dkdv_general",
           "flash_bwd_dq_general")
# The general family in f32 against the plain versions in f32 with TF32
# off: G1-G3 split each f32 operand into two TF32 halves (three products
# a term, the lo.lo term dropped); at the training shape 1.8e-6 (G2's dk)
# and 1.5e-6 (G3's dq) relative, at most 2.7e-6 over the phase's f32
# cases, measured on an H100 80GB HBM3 at 700 W (PERF.md), so 1e-5 leaves
# room.  lse reaches ~10, so 1e-4 absolute is the same margin.
TOL_F32 = 1e-5
TOL_F32_LSE = 1e-4
# f32 models against attn="full": the reference's own tolerance
# (tests/test_flash_attention.py:274-300, rtol = atol = 1e-4).
TOL_MODEL = 1e-4
# The ptxas entry of each kernel of the kernels line (the instantiation
# the training shape runs: D 128, or f32 at D 128 for the general family).
PTXAS_NAMES = {
    "flash_fwd": "flash_fwd_kernelILi128E",
    "flash_bwd_dkdv": "flash_bwd_dkdv_kernelILi128E",
    "flash_bwd_dq": "flash_bwd_dq_kernelILi128E",
    "flash_bwd_fused": "flash_bwd_fused_kernelILi128E",
    "int8_quantize": "int8_quantize_kernel",
    "int8_dequantize": "int8_dequantize_kernel",
    "flash_fwd_general": "flash_fwd_general_kernelIfLi16EE",
    "flash_bwd_dkdv_general": "flash_bwd_dkdv_general_kernelIfLi16EE",
    "flash_bwd_dq_general": "flash_bwd_dq_general_kernelIfLi16EE",
    "flash_fwd_wide": "flash_fwd_wide_kernelIfE",
    "flash_bwd_dkdv_wide": "flash_bwd_dkdv_wide_kernelIfE",
    "flash_bwd_dq_wide": "flash_bwd_dq_wide_kernelIfE",
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
    from horovod_tpu_torch import cpp_core
    t0 = time.perf_counter()
    _check(cpp_core.available(), "the native core (cpp/) did not build")
    print(f"native core {cpp_core._LIB_PATH} ready in "
          f"{time.perf_counter() - t0:.1f} s")
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
    # Every instantiation of G1-G3 that general_plan can pick: element
    # type and the columns of o (G1), dk and dv (G2) or dq (G3) a warp
    # holds; none may spill.
    types = {"f": "f32", "6__half": "fp16", "13__nv_bfloat16": "bf16"}
    found = 0
    for i, line in enumerate(lines):
        m = re.search(r"(flash_fwd_general|flash_bwd_dkdv_general|"
                      r"flash_bwd_dq_general)_kernelI"
                      r"(f|6__half|13__nv_bfloat16)Li(\d+)E",
                      line)
        if "Compiling entry function" not in line or not m:
            continue
        text = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", text)
        _check(spill is not None, f"no spill line for {m.group(0)}")
        spilled = int(spill.group(1)) + int(spill.group(2))
        print(f"  {m.group(1)} {types[m.group(2)]} {8 * int(m.group(3))} "
              f"columns: "
              f"{regs.group(1) if regs else '?'} registers, {spilled} bytes "
              f"spilled")
        _check(spilled == 0, f"{m.group(0)} spills")
        found += 1
    _check(found == 24, f"{found} G1-G3 instantiations in ptxas' log, "
           f"expected 24")
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


def _device_kernels(fn) -> list:
    """The device kernels ``fn()`` launches, by name, with their device
    ms, longest first (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda k: -k[1])


def _run_general(c, label, timing=False, one_key=False, family="general"):
    """G1-G3 (W1-W3 with ``family="wide"``) against the plain versions on
    one case (the wrappers must route it to that family); with ``timing``,
    also time kernels,
    plain versions and f32 ``scaled_dot_product_attention``, and name the
    kernels that ran the latter.  ``one_key``: every row sees at most one
    key (T 1, or seq_len 1), so the softmax has no gradient and the exact
    dq and dk are 0; both versions' dq and dk are rounding noise, held to
    the same tolerance relative to dv's norm, the gradient scale of the
    case, instead of their own."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    names = GENERAL if family == "general" else WIDE
    _check(_cuda.flash_family(q.dtype, c["D"], q.stride(), q.data_ptr())
           == family, f"{label}: not routed to the {family} family")
    copy = _cuda.general_plan(
        "flash_bwd_dkdv_general", c["B"], H, c["T"], c["D"], q.dtype,
        [(x.stride(), x.data_ptr()) for x in (q, k, v, do)]).copy_bytes \
        if family == "general" else q.dtype.itemsize
    _cuda.reset_launches()
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o_ref, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, H, **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse_ref, delta, H, **kw)
    ref = fa._flash_bwd_fused_plain(q, k, v, do, lse_ref, delta, H, **kw)
    torch.cuda.synchronize()
    launches = {n: _cuda.LAUNCHES[n] for n in FLASH + GENERAL + WIDE}
    _check(launches == {n: int(n in names) for n in launches},
           f"{label}: launches {launches}")
    errs = {"o": _rel_fro(o, o_ref), "lse": _max_abs(lse, lse_ref),
            "dq": _rel_fro(dq, ref[0]), "dk": _rel_fro(dk, ref[1]),
            "dv": _rel_fro(dv, ref[2]), "o_abs": _max_abs(o, o_ref),
            "grad_abs": max(_max_abs(g, r) for g, r in zip((dq, dk, dv),
                                                            ref))}
    if one_key:
        norm = max(torch.linalg.vector_norm(ref[2].float()).item(), 1e-30)
        for name, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1])):
            errs[name] = torch.linalg.vector_norm(
                got.float() - want.float()).item() / norm
    print(f"  {label} ({copy}-byte copies): rel fro o {errs['o']:.3e} dq "
          f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e}, lse "
          f"max abs {errs['lse']:.3e}"
          + (" (dq, dk against dv's norm)" if one_key else ""))
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
        names[0]: _median_ms(lambda: _cuda.flash_fwd(
            q, k, v, H, **kw), runs=10, reps=5),
        names[1]: _median_ms(lambda: _cuda.flash_bwd_dkdv(
            q, k, v, do, lse, delta, H, **kw), runs=10, reps=5),
        names[2]: _median_ms(lambda: _cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, H, **kw), runs=10, reps=5),
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
    times["sdpa_fwd_kernels"] = _device_kernels(
        lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                               is_causal=c["causal"]))
    times["sdpa_bwd_kernels"] = _device_kernels(
        lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                    retain_graph=True))
    del out, qs, ks, vs, dos
    return errs, times


def _check_general_deterministic(c, label="main f32: G1-G3") -> None:
    """G1, G2 and G3 (or W1-W3) launched twice on the same inputs give the
    same bits (no atomics, a fixed order of every sum)."""
    from horovod_tpu_torch.ops import _cuda
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    from horovod_tpu_torch.ops import flash_attention as fa
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
    print(f"  {label} launched twice: " + ", ".join(
        f"{n} {'bit-identical' if ok else 'DIFFERENT'}"
        for n, ok in same.items()))
    _check(all(same.values()), f"{label} are not deterministic: {same}")


def phase_general():
    """G1-G3 against the plain versions: f32 at the training shape, on
    the small cases, at head sizes P1-P3 do not take and at the edges of
    the tiles (D 1, 129 and 256, T 1, seq_len 1, each copy width), fp16,
    bf16; G1-G3 deterministic.  Returns the
    training shape's numbers."""
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
            (2, 4, 256, 8, True, None, bf16, "bf16 D=8"),
            (2, 3, 100, 1, True, None, f32, "D=1"),
            (2, 2, 200, 129, True, None, f32, "D=129 (two dk/dv halves)"),
            (2, 2, 256, 256, True, 250, f32, "D=256 seq_len=250"),
            (2, 2, 192, 256, False, None, bf16, "bf16 D=256 non-causal"),
            (2, 3, 150, 13, False, None, f32, "D=13 non-causal"),
            (2, 3, 150, 12, True, None, f16, "fp16 D=12"),
            (2, 3, 150, 13, True, None, bf16, "bf16 D=13")):
        _run_general(_case(B, H, T, D, causal, sl, gen, dt), label)
    for B, H, T, D, sl, label in ((2, 3, 1, 64, None, "T=1"),
                                  (2, 3, 200, 64, 1, "seq_len=1")):
        _run_general(_case(B, H, T, D, True, sl, gen, f32), label,
                     one_key=True)
    main = _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen, f32)
    errs, times = _run_general(main, "main f32 B=8 H=16 T=2048 D=128 causal",
                               timing=True)
    _check_general_deterministic(main)
    B, H, T, D = BATCH, HEADS, SEQ, DIM // HEADS
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 4          # one (B, T, C) f32 tensor
    rows = B * H * T * 4
    work = {"flash_fwd_general": (4 * D * pairs, 4 * tensor + rows),
            "flash_bwd_dkdv_general": (8 * D * pairs,
                                       6 * tensor + 2 * rows),
            "flash_bwd_dq_general": (6 * D * pairs, 5 * tensor + 2 * rows)}
    # G1-G3 run three TF32 products a term on the tensor cores: that
    # bound, beside the FFMA bound of the same sums.
    bounds = {name: {"ffma": flops / PEAK_F32_FLOPS * 1e3,
                     "tf32x3": 3 * flops / PEAK_TF32_FLOPS * 1e3}
              for name, (flops, _) in work.items()}
    for name in GENERAL:
        b = bounds[name]
        print(f"  main f32: {name} {times[name]:.3f} ms; bounds: FFMA at 67 "
              f"TFLOP/s {b['ffma']:.3f} ms, three TF32 products at 495 "
              f"TFLOP/s {b['tf32x3']:.3f} ms")
    for key in ("fwd", "bwd"):
        top = times[f"sdpa_{key}_kernels"]
        print(f"  main f32: scaled_dot_product_attention {key} "
              f"{times['sdpa_' + key]:.3f} ms ran "
              + "; ".join(f"{n[:100]} {ms:.3f} ms" for n, ms in top[:3]))
    pair = times["flash_bwd_dkdv_general"] + times["flash_bwd_dq_general"]
    print(f"  main f32: G2 + G3 {pair:.3f} ms, "
          f"{pair / times['sdpa_bwd']:.3f}x the scaled_dot_product_attention "
          f"backward ({times['sdpa_bwd']:.3f} ms, dq, dk and dv)")
    return {"errs": errs, "times": times, "work": work, "bounds": bounds}


# The wide route's timing case: head size 384, where G1-G3 cannot stage
# their tiles.
WIDE_CASE = dict(B=1, H=2, T=512, D=384, causal=True)


def phase_wide():
    """W1-W3 (``flash_wide.cu``, head sizes above 256) against the plain
    versions in f32 at D 264, 384 and 1000 (B 1, H 2, T 512, causal),
    within 1e-5 relative with TF32 off, at the route's largest head size
    ``WIDE_MAX_D`` (T 16: its shared memory, static and dynamic, must fit
    a block), plus bf16 at D 320 with a ragged seq_len; launched twice,
    the same bits; timed at D 384 beside the
    plain versions and f32 ``scaled_dot_product_attention``, whose kernels
    (the backend PyTorch picked) are named from the profiler."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    w = WIDE_CASE
    print("wide route W1-W3 vs plain versions (f32: tolerance "
          f"{TOL_F32} rel fro; bf16 {TOL_GRAD}):")
    from horovod_tpu_torch.ops import _cuda
    for D in (264, 1000):
        _run_general(_case(w["B"], w["H"], w["T"], D, True, None, gen,
                           torch.float32), f"f32 D={D}", family="wide")
    _run_general(_case(1, 1, 16, _cuda.WIDE_MAX_D, True, None, gen,
                       torch.float32), f"f32 D={_cuda.WIDE_MAX_D} T=16",
                 family="wide")
    _run_general(_case(2, 3, 200, 320, True, 150, gen, torch.bfloat16),
                 "bf16 D=320 T=200 seq_len=150", family="wide")
    main = _case(w["B"], w["H"], w["T"], w["D"], True, None, gen,
                 torch.float32)
    errs, times = _run_general(main, f"f32 D={w['D']}", timing=True,
                               family="wide")
    _check_general_deterministic(main, f"f32 D={w['D']}: W1-W3")
    B, H, T, D = w["B"], w["H"], w["T"], w["D"]
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 4
    rows = B * H * T * 4
    work = {"flash_fwd_wide": (4 * D * pairs, 4 * tensor + rows),
            "flash_bwd_dkdv_wide": (8 * D * pairs, 6 * tensor + 2 * rows),
            "flash_bwd_dq_wide": (6 * D * pairs, 5 * tensor + 2 * rows)}
    for name in WIDE:
        flops, nbytes = work[name]
        print(f"  f32 D={D}: {name} {times[name]:.3f} ms; bound (3xTF32 "
              f"at 495/3 TFLOP/s) {3 * flops / PEAK_TF32_FLOPS * 1e3:.4f} "
              f"ms, FFMA (67 TFLOP/s) {flops / PEAK_F32_FLOPS * 1e3:.4f} ms")
    for key in ("fwd", "bwd"):
        top = times[f"sdpa_{key}_kernels"]
        print(f"  f32 D={D}: scaled_dot_product_attention {key} "
              f"{times['sdpa_' + key]:.3f} ms ran "
              + "; ".join(f"{n[:100]} {ms:.3f} ms" for n, ms in top[:3]))
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
    for vocab, dim, depth, heads in ((64, 256, 1, 2), (64, 32, 2, 4),
                                     (64, 768, 1, 2)):
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
        names = WIDE if dim // heads > 256 else GENERAL
        want = {n: depth if n in names else 0
                for n in FLASH + GENERAL + WIDE}
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
    got = _spawn(_nccl_worker, 2)
    print(f"nccl ring: 2 processes x {RING_N} elements, distributed vs "
          f"lockstep ring: {got}")
    _check(got == {0: True, 1: True}, f"nccl ring failed: {got}")


# The ResNet-50 leg (bench.py:150-256): batch 128 per GPU, 224 x 224,
# bf16, SGD lr 0.01 momentum 0.9, sync_aux_state=True, steps_per_call=5.
RESNET_BATCH, RESNET_SIZE, RESNET_SPC, RESNET_TIMED = 128, 224, 5, 3
# bench.py:270-281: 4.1e9 is ResNet-50's multiply-accumulates per 224 x
# 224 image (8.2 GFLOP); the bench's analytic MFU counts 3 x 4.1e9 per
# image for forward and backward, and so does this script.
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9
TOL_BN_STATS = 1e-3      # bn_init's running statistics, relative
TOL_SPC = 1e-5           # steps_per_call vs single steps, losses, relative
# ResNet-50 on the card against the CPU on RESNET_CHECK images, relative
# Frobenius.  The backward of this problem amplifies small changes: on the
# CPU alone, inputs moved by 1e-6 moved its f32 gradients by 1.3e-3 taken
# together and one BatchNorm bias gradient by 9e-3, and its bf16 logits by
# 3.8e-3 (phase 15 prints this floor in every run; H100 80GB HBM3 host,
# PERF.md).  So the limits sit a few times above that floor, and far
# below the O(1) error of a wrong gradient: f32 loss and logits 1e-4, all
# f32 gradients together 1e-2, every f32 gradient and buffer 5e-2; bf16
# loss and logits 2e-2 (the bf16 gradients are not held: bf16 rounding
# alone moves them by ~6e-2).
RESNET_CHECK = 4
TOL_RESNET_FWD = 1e-4
TOL_RESNET_GRADS = 1e-2
TOL_RESNET_TENSOR = 5e-2
TOL_RESNET_BF16 = 2e-2
SMALL_RESNET = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)


def _resnet_loss(model, batch):
    import torch.nn.functional as F
    images, labels = batch
    return F.cross_entropy(model(images), labels)


def _resnet_category(name: str) -> str:
    low = name.lower()
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "xmma",
                              "implicit", "cudnn", "nhwc", "nchw")):
        return "convolution (cuDNN)"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "reduce", "copy", "fill", "batch_norm",
                              "cat")):
        return "BatchNorm and elementwise"
    return "other (pooling, head, optimizer)"


def phase_resnet_steps_per_call():
    """A small ResNet on the card: one call with ``steps_per_call=3``
    against three single-step calls of the same model, same batches."""
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.spmd import make_train_step
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    images = torch.randn(3, 16, 32, 32, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (3, 16), generator=gen, device="cuda")
    losses = {}
    for spc in (1, 3):
        model = ResNet(**SMALL_RESNET, seed=SEED, device="cuda")
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, _resnet_loss, opt,
                               steps_per_call=spc)
        if spc == 1:
            losses[spc] = [step((images[i], labels[i])).item()
                           for i in range(3)]
        else:
            losses[spc] = step((images, labels)).item()
    want = sum(losses[1]) / 3
    err = abs(losses[3] - want) / abs(want)
    print(f"resnet steps_per_call: one call of 3 gives {losses[3]:.6f}, "
          f"3 single steps {losses[1]} (mean {want:.6f}), {err:.2e} "
          f"relative")
    _check(err <= TOL_SPC, f"steps_per_call=3 differs from 3 single steps "
           f"by {err} > {TOL_SPC}")


def _resnet_pass(model, images, labels) -> dict:
    """One train-mode forward and backward: loss, logits, every
    parameter's gradient and every buffer after the forward, as f64 on
    the CPU."""
    import torch.nn.functional as F
    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    out = {"loss": loss.detach().reshape(1), "logits": logits.detach()}
    out.update({"grad " + n: p.grad for n, p in model.named_parameters()})
    out.update({"buffer " + n: b for n, b in model.named_buffers()})
    return {k: v.detach().double().cpu() for k, v in out.items()}


def phase_resnet_cpu():
    """ResNet-50 at full width on the card against the same model and
    inputs on the CPU, in f32 (TF32 off) and in the leg's bf16, on
    ``RESNET_CHECK`` images of 224 x 224 with random labels.  The last
    BatchNorm scale of every block, zero at init, is drawn from U(0.05,
    0.15): every block's convolutions then get a gradient while the
    residual branches stay small.  (With every scale drawn from U(0.5,
    1.5) the backward is chaotic: a 1e-6 change of the inputs moved
    gradients by 3e-2, so no two devices can agree on them.)  The CPU
    pass is repeated on inputs moved by 1e-6 relative, to print how far
    the problem itself amplifies a change that small.  In f32 the loss
    and the logits within ``TOL_RESNET_FWD``, all gradients together
    within ``TOL_RESNET_GRADS``, every gradient and buffer within
    ``TOL_RESNET_TENSOR``; in bf16 the loss and the logits within
    ``TOL_RESNET_BF16``."""
    from horovod_tpu_torch.models import ResNet50
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 5)
    images = torch.randn(RESNET_CHECK, RESNET_SIZE, RESNET_SIZE, 3,
                         generator=gen)
    moved = images * (1 + 1e-6 * torch.randn(images.shape, generator=gen))
    labels = torch.randint(0, 1000, (RESNET_CHECK,), generator=gen)
    state = None
    errs, floor, cpu_s = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        got = {}
        for device, x in (("cpu", images), ("cpu moved", moved),
                          ("cuda", images)):
            model = ResNet50(num_classes=1000, dtype=dtype, seed=SEED,
                             device=device.split()[0])
            if state is None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        if n.endswith("BatchNorm_2.scale"):
                            p.uniform_(0.05, 0.15, generator=gen)
                state = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            t0 = time.perf_counter()
            got[device] = _resnet_pass(model, x.to(device.split()[0]),
                                       labels.to(device.split()[0]))
            if device == "cpu":
                cpu_s[dtype] = time.perf_counter() - t0
            del model
        errs[dtype] = _resnet_errs(got["cuda"], got["cpu"])
        floor[dtype] = _resnet_errs(got["cpu moved"], got["cpu"])
    f32, bf16 = errs[torch.float32], errs[torch.bfloat16]
    worst = max(f32, key=f32.get)
    for dtype, e in errs.items():
        w = max(e, key=e.get)
        fl = floor[dtype]
        print(f"resnet50 card vs CPU, {str(dtype)[6:]} ({RESNET_CHECK} "
              f"images, {len(e) - 1} tensors): loss {e['loss']:.2e}, "
              f"logits {e['logits']:.2e}, all gradients "
              f"{e['all gradients']:.2e}, worst {w} {e[w]:.2e}; CPU vs "
              f"CPU on inputs moved by 1e-6: logits {fl['logits']:.2e}, "
              f"all gradients {fl['all gradients']:.2e}, worst "
              f"{max(fl.values()):.2e}")
    print(f"resnet50 card vs CPU: one CPU pass {cpu_s[torch.float32]:.1f} "
          f"s; held: f32 loss and logits within {TOL_RESNET_FWD}, all "
          f"gradients within {TOL_RESNET_GRADS}, every tensor within "
          f"{TOL_RESNET_TENSOR}; bf16 loss and logits within "
          f"{TOL_RESNET_BF16}")
    for key, tol in (("loss", TOL_RESNET_FWD), ("logits", TOL_RESNET_FWD),
                     ("all gradients", TOL_RESNET_GRADS),
                     (worst, TOL_RESNET_TENSOR)):
        _check(f32[key] <= tol,
               f"resnet50: f32 card vs CPU, {key} {f32[key]} > {tol}")
    for key in ("loss", "logits"):
        _check(bf16[key] <= TOL_RESNET_BF16,
               f"resnet50: bf16 card vs CPU, {key} {bf16[key]} > "
               f"{TOL_RESNET_BF16}")


def _resnet_errs(got: dict, want: dict) -> dict:
    """Relative Frobenius error of every tensor of ``_resnet_pass``, and
    of all the gradients together."""
    errs = {k: _rel_fro(got[k], want[k]) for k in want}
    grads = [k for k in want if k.startswith("grad ")]
    errs["all gradients"] = _rel_fro(
        torch.cat([got[k].reshape(-1) for k in grads]),
        torch.cat([want[k].reshape(-1) for k in grads]))
    return errs


def phase_resnet():
    """The ResNet-50 leg at full width: the first step's BatchNorm
    statistics against a direct computation, 1 warm-up call and 3 timed
    calls of 5 steps, an eval step, two profiled steps."""
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.spmd import make_eval_step, make_train_step
    torch.cuda.reset_peak_memory_stats()
    model = ResNet50(num_classes=1000, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    images = torch.randn(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3,
                         generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.zeros(RESNET_BATCH, dtype=torch.long, device="cuda")
    # The bench stacks one batch steps_per_call times (bench.py:232-234).
    stacked = (images.expand(RESNET_SPC, *images.shape),
               labels.expand(RESNET_SPC, *labels.shape))
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    one = make_train_step(model, _resnet_loss, opt, sync_aux_state=True)
    call = make_train_step(model, _resnet_loss, opt, sync_aux_state=True,
                           steps_per_call=RESNET_SPC)
    with torch.no_grad():
        y = model.conv_init(images.permute(0, 3, 1, 2)).float()
        want_mean = 0.1 * y.mean(dim=(0, 2, 3))
        want_var = 0.9 + 0.1 * y.var(dim=(0, 2, 3), unbiased=False)
        del y
    _cuda.reset_launches()
    first = one((images, labels)).item()
    bn = model.bn_init
    errs = (_rel_fro(bn.mean, want_mean), _rel_fro(bn.var, want_var))
    print(f"resnet50: first step loss {first:.4f}; bn_init running mean "
          f"and var against 0.1 x the batch's (and 0.9 + 0.1 x): "
          f"{errs[0]:.2e}, {errs[1]:.2e} relative")
    _check(max(errs) <= TOL_BN_STATS,
           f"resnet50: bn_init statistics {errs} > {TOL_BN_STATS}")
    losses, times = [first], []
    for i in range(1 + RESNET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = call(stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(_cuda.LAUNCHES)
    call_s = statistics.median(times[1:])
    step_s = call_s / RESNET_SPC
    images_s = RESNET_BATCH / step_s
    mfu = RESNET_FLOPS_PER_IMAGE * images_s / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"resnet50: batch {RESNET_BATCH} x {RESNET_SIZE}^2 bf16, "
          f"steps_per_call {RESNET_SPC}, losses (first step, then the mean "
          f"of each call) " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"resnet50: {images_s:.1f} images/s per GPU, {step_s * 1e3:.2f} ms "
          f"per step (median of {RESNET_TIMED} calls; calls "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms, the first "
          f"a warm-up), MFU {mfu:.4f} (3 x 4.1e9 per image at 989 "
          f"TFLOP/s), peak memory {peak_gb:.2f} GiB, port kernels "
          f"launched {sum(launches.values())}")
    print(f"resnet50: after the timed calls, SM clock, power, "
          f"temperature: {_clocks()}")
    _check(all(math.isfinite(x) for x in losses), "resnet50: non-finite loss")
    _check(losses[-1] < losses[0],
           f"resnet50: loss did not fall: {losses[0]} -> {losses[-1]}")
    # The leg runs no Pallas kernel in the JAX package either.
    _check(not any(launches.values()),
           f"resnet50: port kernels launched: {launches}")
    logits = make_eval_step(model, lambda m, b: m(b))(images)
    _check(tuple(logits.shape) == (RESNET_BATCH, 1000)
           and bool(torch.isfinite(logits).all()),
           f"resnet50: eval logits {tuple(logits.shape)} not finite")
    print(f"resnet50: eval step on the running statistics: logits "
          f"{tuple(logits.shape)}, finite, mean {logits.mean().item():.4f}")
    # One profiled step's busy share varies from profile to profile at
    # the same kernel time (0.80-0.955 on an H100, PERF.md §5): two.
    for _ in range(2):
        _profile_step(one, (images, labels), _resnet_category)
    return {"images_s": images_s, "step_s": step_s, "mfu": mfu,
            "peak_gb": peak_gb}


HIER_HOSTS = ("A", "A", "B", "B")
# int8 on the mesh against the flat sum of the same snapped leaves: the
# two-tier path sums the bf16 wire in another order than the flat
# all_reduce of f32, a few bf16 roundings (2^-8) apart.
TOL_HIER_INT8 = 1e-2


def _hier_worker(rank: int, port: int, results) -> None:
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_HOST_FINGERPRINT": HIER_HOSTS[rank]})
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import ResNet
        from horovod_tpu_torch.ops import _cuda, injit
        from horovod_tpu_torch.parallel.hierarchical import (
            hierarchical_allreduce)
        from horovod_tpu_torch.spmd import make_train_step, reduce_gradients
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        mesh = hvd.hierarchical_mesh()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + rank)
        x = torch.randint(-1000, 1000, (RING_N + 3,), generator=gen,
                          device="cuda").float()
        same = _bits_equal(hierarchical_allreduce(x, mesh=mesh),
                           injit.allreduce(x, average=False))
        # int8 on the two-tier path: eligible leaves snapped through P4/P5,
        # reduced in bf16 over the mesh, against the plain snap.
        grads = [torch.randn(1024, 1024, generator=gen, device="cuda"),
                 torch.randn(301, generator=gen, device="cuda")]
        _cuda.reset_launches()
        got = reduce_gradients(grads, compression="int8", mesh=mesh)
        torch.cuda.synchronize()
        codec = {k: _cuda.LAUNCHES[k]
                 for k in ("int8_quantize", "int8_dequantize")}
        wire = [_snap_plain(grads[0]).to(torch.bfloat16),
                grads[1].to(torch.float32)]
        int8_same = all(_bits_equal(g, hierarchical_allreduce(
            w, average=True, mesh=mesh).to(g.dtype))
            for g, w in zip(got, wire))
        flat = [injit.allreduce(w.float(), average=True) for w in wire]
        int8_err = max(_rel_fro(g, f) for g, f in zip(got, flat))
        images = torch.randn(2, 8, 32, 32, 3, generator=gen, device="cuda")
        labels = torch.randint(0, 10, (2, 8), generator=gen, device="cuda")
        losses = {}
        for key, m in (("mesh", mesh), ("flat", None)):
            model = ResNet(**SMALL_RESNET, seed=SEED, device="cuda")
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            step = make_train_step(model, _resnet_loss, opt, mesh=m)
            losses[key] = [step((images[i], labels[i])).item()
                           for i in range(2)]
        torch.cuda.synchronize()
        hvd.shutdown()
        results.put((rank, {"grid": mesh.grid, "same": same,
                            "int8_same": int8_same, "int8_err": int8_err,
                            "codec": codec, "losses": losses}))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_hierarchical_nccl():
    """Four processes, one card each, on two fake hosts (A, A, B, B):
    the two-tier allreduce of integer-valued f32 against the flat
    all_reduce, bit for bit; ``reduce_gradients(compression="int8",
    mesh=)`` against the plain snap reduced over the mesh (bit for bit)
    and over the flat group; and two small-ResNet steps on the mesh
    against the flat step."""
    if torch.cuda.device_count() < 4:
        print("hierarchical nccl: not run (it needs four CUDA devices, "
              f"this machine has {torch.cuda.device_count()})")
        return
    got = _spawn(_hier_worker, 4)
    print(f"hierarchical nccl: 4 processes on hosts {HIER_HOSTS}: {got}")
    _check(all(isinstance(got.get(r), dict) for r in range(4)),
           f"hierarchical nccl failed: {got}")
    for r in range(4):
        out = got[r]
        _check(out["grid"] == ((0, 1), (2, 3)), f"rank {r}: {out['grid']}")
        _check(out["same"], f"rank {r}: two-tier allreduce differs from "
               f"the flat one")
        _check(out["int8_same"] and min(out["codec"].values()) > 0,
               f"rank {r}: int8 on the mesh differs from the plain snap's "
               f"two-tier reduce, or P4/P5 did not launch: {out['codec']}")
        _check(out["int8_err"] <= TOL_HIER_INT8,
               f"rank {r}: int8 on the mesh vs the flat sum of the plain "
               f"snap {out['int8_err']} > {TOL_HIER_INT8}")
        err = max(abs(a - b) / abs(b) for a, b in
                  zip(out["losses"]["mesh"], out["losses"]["flat"]))
        _check(err <= TOL_SPC, f"rank {r}: mesh step vs flat {err}")


# The eager plane's timing shapes: one 4 KiB allreduce for latency, and a
# burst of 64 float32 tensors of 1 MiB each, which the planner fuses into
# 64 MiB responses (HOROVOD_TPU_FUSION_THRESHOLD's default).
EAGER_SMALL = 1024                       # f32 elements: 4 KiB
EAGER_BURST, EAGER_BURST_N = 64, 1 << 18  # 64 x 1 MiB of f32
EAGER_REPS = 50


def _eager_latency_ms(hvd, device) -> float:
    """Median host time of one synchronous 4 KiB eager allreduce, until
    its result is on the device."""
    x = torch.ones(EAGER_SMALL, device=device)
    times = []
    for i in range(EAGER_REPS + 5):
        t0 = time.perf_counter()
        hvd.allreduce(x, name="eager.small")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[5:])


def _eager_burst(hvd, device, tag: str):
    """The 64 x 1 MiB burst, async: enqueue all, then synchronize all.
    Returns (the inputs, the results, host ms until every result is on the
    device, the cache hits the burst added, host ms of the enqueues alone,
    the control plane's ticks during the enqueues)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    xs = [torch.randint(-8, 8, (EAGER_BURST_N,), generator=gen,
                        device=device).float() for _ in range(EAGER_BURST)]
    torch.cuda.synchronize()
    c0 = hvd.metrics()["counters"]
    t0 = time.perf_counter()
    hs = [hvd.allreduce_async(x, average=False, name=f"{tag}.{i}")
          for i, x in enumerate(xs)]
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ticks = (hvd.metrics()["counters"].get("control.ticks", 0)
             - c0.get("control.ticks", 0))
    outs = [hvd.synchronize(h) for h in hs]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    added = (hvd.metrics()["counters"].get("control.cache_hits", 0)
             - c0.get("control.cache_hits", 0))
    return xs, outs, ms, added, enqueue_ms, ticks


def _eager_small_bursts(hvd, device, rank: int, n: int) -> dict:
    """The reference's cache burst (tests/test_multiprocess.py
    CACHE_BYTES_WORKER) on the card: 16 allreduces of 8 floats enqueued
    together, then synchronized, 31 times.  Returns the cache hits they
    added, the first burst's and the best later burst's control bytes, and
    the ticks the coordinator served from the cache."""
    def counters():
        return hvd.metrics()["counters"]

    def served():
        return hvd.metrics()["histograms"].get(
            "control.tick_seconds#cached=1", {}).get("count", 0)

    c0, s0 = counters(), served()
    per_burst = []
    for _ in range(31):
        b0 = counters().get("control.negotiation_bytes", 0)
        hs = [hvd.allreduce_async(torch.full((8,), float(rank + 1),
                                             device=device),
                                  average=False, name=f"nc.cache.{j:02d}")
              for j in range(16)]
        for h in hs:
            _check(hvd.synchronize(h).tolist() == [n * (n + 1) / 2] * 8,
                   "eager nccl: a cache burst's sum is wrong")
        per_burst.append(counters().get("control.negotiation_bytes", 0)
                         - b0)
    return {"hits": counters().get("control.cache_hits", 0)
            - c0.get("control.cache_hits", 0),
            "first_bytes": per_burst[0], "best_bytes": min(per_burst[6:]),
            "served_ticks": served() - s0}


def _library_allreduce_ms(buf) -> float:
    """Median host time of one dist.all_reduce of ``buf`` until it is
    done on the device (the library yardstick of the burst)."""
    import torch.distributed as dist
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def phase_eager():
    """The negotiated eager plane at size 1 on the card: allreduce (sum
    and average), allgather and broadcast of CUDA f32, bf16 and int64
    tensors, async with poll and synchronize, results on the card and
    equal to what one rank gives (the input; integers floor-divided);
    then the latency of one 4 KiB allreduce, and the 64 x 1 MiB burst
    three times, fused (hvd.metrics()'s ops and fill ratio) and served
    from the response cache from the second burst on, timed beside one
    dist.all_reduce of the same 64 MiB on a one-rank NCCL group."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    ok = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = (torch.arange(24, device=dev) - 7).reshape(4, 6).to(dtype)
        hs = [hvd.allreduce_async(x, average=False, name=f"e.sum.{dtype}"),
              hvd.allreduce_async(x, average=True, name=f"e.avg.{dtype}"),
              hvd.allgather_async(x, name=f"e.ag.{dtype}"),
              hvd.broadcast_async(x, 0, name=f"e.bc.{dtype}")]
        while not all(hvd.poll(h) for h in hs):
            time.sleep(1e-4)
        outs = [hvd.synchronize(h) for h in hs]
        ok[str(dtype)] = all(o.is_cuda and o.dtype == dtype
                             and _bits_equal(o, x) for o in outs)
    print(f"eager (size 1): allreduce sum/average, allgather, broadcast "
          f"on the card, async, equal to the input: {ok}")
    _check(all(ok.values()), f"eager at size 1: {ok}")
    lat = _eager_latency_ms(hvd, dev)
    c0 = hvd.metrics()
    bursts = [_eager_burst(hvd, dev, "burst") for _ in range(3)]
    c1 = hvd.metrics()
    ops = (c1["counters"]["controller.ops#type=allreduce"]
           - c0["counters"].get("controller.ops#type=allreduce", 0))
    fill = c1["histograms"]["controller.fusion_fill_ratio"]
    for xs, outs, *_ in bursts:
        _check(all(_bits_equal(o, x) for o, x in zip(outs, xs)),
               "eager burst: a result differs from its input")
    hits = [b[3] for b in bursts]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        buf = torch.cat(bursts[-1][0])
        lib_ms = _library_allreduce_ms(buf)
    finally:
        dist.destroy_process_group()
    times = [b[2] for b in bursts]
    print(f"eager (size 1): 4 KiB allreduce {lat:.3f} ms (median of "
          f"{EAGER_REPS}, host clock to the result on the card); burst "
          f"{EAGER_BURST} x 1 MiB f32: {[round(t, 3) for t in times]} ms "
          f"in 3 bursts, {ops} allreduce responses, fill ratio histogram "
          f"count {fill['count']} sum {fill['sum']:.3f}; cache hits per "
          f"burst {hits}; one dist.all_reduce of the 64 MiB on a one-rank "
          f"NCCL group {lib_ms:.3f} ms")
    _check(sum(hits[1:]) > 0, f"eager burst: no cache hit: {hits}")
    _check(ops <= 3 * EAGER_BURST, f"eager burst: {ops} responses")
    return {"latency_ms": lat, "burst_ms": times, "library_ms": lib_ms,
            "cache_hits": hits, "responses": ops}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _eager_nccl_worker(rank: int, port: int, results) -> None:
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{port + 1}"})
        os.environ.pop("HOROVOD_TPU_LOCAL_RANK", None)
        import torch.distributed as dist
        import horovod_tpu_torch as hvd
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        dev = torch.device("cuda", torch.cuda.current_device())
        out = {"local_rank": hvd.local_rank(), "device": dev.index}
        ctrl = hvd.controller()
        gen = torch.Generator(device=dev).manual_seed(SEED + 20 + rank)
        # Allreduce, fused: each fused response against dist.all_reduce of
        # the same concatenated buffer, bit for bit.
        xs = {f"nc.{i}": torch.randn(1000 + 37 * i, generator=gen,
                                     device=dev) for i in range(6)}
        xs["nc.bf16"] = torch.randn(333, generator=gen,
                                    device=dev).bfloat16()
        xs["nc.int64"] = torch.randint(-1000, 1000, (77,), generator=gen,
                                       device=dev)
        hs = {n: hvd.allreduce_async(x, average=False, name=n)
              for n, x in xs.items()}
        got = {n: hvd.synchronize(h) for n, h in hs.items()}
        same = True
        for names in ctrl._executor.recent_fusions:
            buf = torch.cat([xs[n].reshape(-1) for n in names])
            dist.all_reduce(buf)
            off = 0
            for n in names:
                k = xs[n].numel()
                same &= _bits_equal(got[n], buf[off:off + k])
                off += k
        out["fusions"] = [len(f) for f in ctrl._executor.recent_fusions]
        out["allreduce_same"] = same
        avg = hvd.allreduce(torch.full((5,), rank + 1, device=dev,
                                       dtype=torch.int64), name="nc.avg")
        out["int_avg"] = avg.tolist()
        # Ragged allgather and broadcast.
        g = hvd.allgather(torch.full((rank + 1, 3), float(rank), device=dev),
                          name="nc.gather")
        out["gather"] = g[:, 0].tolist()
        b = hvd.broadcast(torch.full((4,), float(rank), device=dev), 2,
                          name="nc.bcast")
        out["bcast"] = b.tolist()
        # The coordinated mismatch error, on every rank.
        bad = torch.zeros(2, device=dev,
                          dtype=torch.int32 if rank == 0 else torch.float32)
        try:
            hvd.allreduce(bad, name="nc.bad")
            out["mismatch"] = None
        except hvd.CollectiveError as e:
            out["mismatch"] = str(e)
        out["latency_ms"] = _eager_latency_ms(hvd, dev)
        out["small"] = _eager_small_bursts(hvd, dev, rank, 4)
        bursts = [_eager_burst(hvd, dev, "nc.burst") for _ in range(3)]
        out["burst_ms"] = [b[2] for b in bursts]
        out["cache_hits"] = [b[3] for b in bursts]
        out["enqueue_ms"] = [b[4] for b in bursts]
        out["enqueue_ticks"] = [b[5] for b in bursts]
        xs_b, outs_b = bursts[-1][0], bursts[-1][1]
        buf = torch.cat(xs_b)
        ref = buf.clone()
        dist.all_reduce(ref)
        out["burst_same"] = _bits_equal(torch.cat(outs_b), ref)
        out["library_ms"] = _library_allreduce_ms(buf)
        torch.cuda.synchronize()
        hvd.shutdown()
        results.put((rank, out))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_eager_nccl():
    """The eager plane on four cards, one process each, launched without
    HOROVOD_TPU_LOCAL_RANK: host discovery must give four distinct GPUs.
    Each fused allreduce (f32, bf16, int64) equals dist.all_reduce of the
    same fused buffer bit for bit; the integer average floor-divides; a
    ragged allgather and a broadcast from rank 2 are exact; a dtype
    mismatch raises the coordinator's error on every rank; then the 4 KiB
    latency; the reference's cache burst (16 x 8 floats, 31 times) must
    get cache hits; then the 64 x 1 MiB burst beside one dist.all_reduce
    of the same 64 MiB, with the native cache's hits a burst, the host
    time of its 64 enqueues and the ticks they spanned (hits printed, not
    required: a name is given a cache slot only in a tick that carries
    every rank's request for it, and enqueues that span ticks from
    start times that differ across processes split the burst
    differently; the coordinator then negotiates in full, as the
    reference's does)."""
    if torch.cuda.device_count() < 4:
        print("eager nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    got = _spawn(_eager_nccl_worker, 4)
    _check(all(isinstance(got.get(r), dict) for r in range(4)),
           f"eager nccl failed: {got}")
    for r in range(4):
        o = got[r]
        print(f"eager nccl rank {r}: local_rank {o['local_rank']} on "
              f"cuda:{o['device']}, fusions {o['fusions']}, allreduce vs "
              f"dist.all_reduce bit-identical {o['allreduce_same']}, burst "
              f"{o['burst_same']}; 4 KiB allreduce {o['latency_ms']:.3f} ms;"
              f" burst {[round(t, 3) for t in o['burst_ms']]} ms, cache hits "
              f"{o['cache_hits']}, its enqueues "
              f"{[round(t, 3) for t in o['enqueue_ms']]} ms over "
              f"{o['enqueue_ticks']} ticks; dist.all_reduce of 64 MiB "
              f"{o['library_ms']:.3f} ms; reference cache burst: "
              f"{o['small']}")
        _check(o["small"]["hits"] > 0,
               f"rank {r}: the cache burst got no cache hit: {o['small']}")
        _check(o["allreduce_same"] and o["burst_same"],
               f"rank {r}: eager allreduce differs from dist.all_reduce")
        _check(o["int_avg"] == [(1 + 2 + 3 + 4) // 4] * 5,
               f"rank {r}: integer average {o['int_avg']}")
        _check(o["gather"] == [float(q) for q in range(4)
                               for _ in range(q + 1)],
               f"rank {r}: allgather {o['gather']}")
        _check(o["bcast"] == [2.0] * 4, f"rank {r}: broadcast {o['bcast']}")
        _check(o["mismatch"] == got[0]["mismatch"] and o["mismatch"]
               and o["mismatch"].startswith("Mismatched data types"),
               f"rank {r}: mismatch error {o['mismatch']!r}")
    devices = sorted(got[r]["device"] for r in range(4))
    _check(devices == [0, 1, 2, 3] and all(
        got[r]["local_rank"] == got[r]["device"] for r in range(4)),
        f"eager nccl: ranks share GPUs: {devices}")
    return got


def _spawn(target, n: int) -> dict:
    """Run ``target(rank, port, results)`` in ``n`` spawned processes;
    {rank: result}, or an "exit"/"timeout" entry when a worker fails or
    300 s pass without every result."""
    import queue
    import torch.multiprocessing as mp
    port = _free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, results))
             for r in range(n)]
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
    return got


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


def _profile_step(step, batch, category=None):
    """One more step under torch.profiler: device time by kernel and
    category (``_category`` unless given), and the device's busy share of
    the (profiled) step.  Returns (wall ms, kernel ms), None when the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    category = category or _category
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        print("profile: the profiler recorded no device time")
        return None
    print(f"profile: one step {wall_ms:.1f} ms wall under the profiler, "
          f"{busy:.1f} ms of kernels, device busy "
          f"{busy / wall_ms:.3f}")
    cats: dict = {}
    for name, ms, _ in kernels:
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {ms:.2f} ms ({ms / busy:.3f} of kernel time)")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  top: {ms:8.2f} ms x{n:<4d} {name[:90]}")
    return wall_ms, busy


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
    "wide": "horovod_tpu_torch/csrc/flash_wide.cu",
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
    wide = phase_wide()
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
    gc.collect()
    torch.cuda.empty_cache()
    phase_resnet_steps_per_call()
    phase_resnet_cpu()
    phase_resnet()
    phase_hierarchical_nccl()
    phase_eager()
    phase_eager_nccl()
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
        rows.append(dict(_kernel_row(
            name, rep, SOURCES["general"], f32_launches[name], err, gt[name],
            gt[plain_key], flops, nbytes, lib, call, usage[name],
            peak_flops=PEAK_TF32_FLOPS / 3),   # three TF32 products a term
            bound_ffma_ms=general["bounds"][name]["ffma"]))
    # The wide route: the same TPU kernels at head sizes above 256, timed
    # in f32 at WIDE_CASE, launched by the f32 model at D 384.
    wt, we = wide["times"], wide["errs"]
    for name, rep, plain_key, err, lib, call in (
            ("flash_fwd_wide", "horovod_tpu/ops/flash_attention.py:255",
             "fwd_plain", we["o_abs"], wt["sdpa_fwd"],
             "scaled_dot_product_attention forward, f32"),
            ("flash_bwd_dkdv_wide", "horovod_tpu/ops/flash_attention.py:675",
             "dkdv_plain", we["grad_abs"], wt["sdpa_bwd"],
             SDPA_BWD + ", f32"),
            ("flash_bwd_dq_wide", "horovod_tpu/ops/flash_attention.py:730",
             "dq_plain", we["grad_abs"], wt["sdpa_bwd"],
             SDPA_BWD + ", f32")):
        flops, nbytes = wide["work"][name]
        # f32 attention's least time is on the tensor cores at three TF32
        # products a term, as for G1-G3; the FFMA time W1-W3 take beside it.
        rows.append(dict(_kernel_row(
            name, rep, SOURCES["wide"], f32_launches[name], err, wt[name],
            wt[plain_key], flops, nbytes, lib, call, usage[name],
            peak_flops=PEAK_TF32_FLOPS / 3),
            bound_ffma_ms=flops / PEAK_F32_FLOPS * 1e3))
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
