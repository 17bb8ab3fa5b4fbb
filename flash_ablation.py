"""What bounds the Hopper flash kernels P1, P2, P3 and P6, the general
family's G1, G2 and G3 and the wide route's W1, W2 and W3, on the card:
each one timed against variants of itself, and the rate of the
tensor-core instruction G1-G3 and W1-W3 issue.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 flash_ablation.py [--parent DIR]

The variants are text edits of the committed sources
(``horovod_tpu_torch/csrc/flash_fwd.cu``, ``flash_bwd_dkdv.cu``,
``flash_bwd_dq.cu``, ``flash_bwd_fused.cu``, ``flash_general.cu`` and
``flash_wide.cu``, with the headers they include: an edit may fall in
``flash_mma.cuh``), built with the port's ``nvcc`` flags into
``build/flash_ablation/`` and timed at the training shape of
``chip_smoke.py`` (B 8, H 16, T 2048, D 128, causal; bf16 for P1-P6, f32
for G1-G3); W1-W3 at ``chip_smoke.WIDE_FULL_CASE`` and ``WIDE_CASE``
(f32, D 384).  Their outputs are wrong by design; only their times
count.  ``--parent DIR``: a directory holding an earlier commit's
``flash_general.cu``, ``flash_wide.cu`` and the headers they include
(for example ``git archive <commit> horovod_tpu_torch/csrc | tar -x -C
DIR --strip-components 2``); its G1-G3 and W1-W3 are built and timed in
turns with the committed ones ("parent"), through the committed entry
points where the parent's take the same arguments, else (a W3 of the
first design) as the parent's source declares them
(``_parent_calls``).

- ``no reload``: once the ring is full the producer stops loading the
  streamed tiles (k and v for P1 and P3, q and dO for P2 and P6) and only
  signals the ring, so the kernel runs without its data movement.
- ``no softmax`` (P1 only): s goes to p.v as it is, without the mask, the
  running max, exp and the rescale: the products and the pipeline alone.
- ``no dq sum`` (P6 only): the dq product runs but its adds to the f32
  workspace do not.
- ``no dq`` (P6 only): neither the dq product nor its adds run; the ds
  tile is still staged and the consumers still meet at their barriers.
- ``heads first``: the grid issues the heaviest tile of every head before
  the next tile of any head (tile index in grid z), so that a head's
  streamed tiles leave L2 between its blocks.
- ``one product`` (G1-G3): f32 takes only hi.hi, as fp16 does: the
  cost of the split's two other products.
- ``sum sets 1`` (G1-G3): the sums over D run in one accumulator a
  product instead of two.
- ``always clamp`` (G1-G3): the tile index of every B fragment of p.v
  (dk, dv; ds.k) is clamped to the head's last 8-column tile, instead of
  the last group reading past it into the slack.
- ``no B split`` (G1-G3): the B fragments (k and v for G1 and G3; q and
  dO for G2) go to the tensor cores unsplit, as both halves: the cost of
  every warp splitting the tiles it shares with the block's other warps.
- ``cvt.rna split`` (G1-G3): hi rounded by ``cvt.rna.tf32.f32`` instead
  of the integer add and mask.
- ``no reload`` (G1-G3): the streamed tiles (k and v for G1 and G3, q
  and dO for G2) are loaded once and never refilled.

W1-W3 (``flash_wide.cu``), at both cases:

- ``no reload``: the steps over D and the column tiles of the first key
  (W2: query) tile only are loaded; later tiles reuse them.
- ``no products over D``: neither s (W1) nor s^T and dp^T (W2) nor dp
  and s (W3) are formed; the partial tiles are still exchanged.
- ``no row products``: neither p.v (W1) nor dk and dv (W2) nor dq += ds.k
  (W3) run.
- ``one product``: f32 takes only hi.hi.
- ``one group stages``: the first warp group issues every copy, the
  second none (both share them in the kernel).

and plan variants of the committed kernels (``ops/_cuda.py:wide_plan``'s
constants changed for the call): ``q streamed`` (W1 streams its q rows
with k, W3 its q and dO rows, instead of holding them whole; f32 at D
384 streams them anyway), ``dcols 32/16/16`` and ``dcols 96/32/24``
(W1 takes steps of 2 x 32 or 2 x 96 columns, W2 2 x 16 or 2 x 32 and W3
2 x 16 or 2 x 24, where the kernels take 64, 32 and 24; a wider W2 or
W3 step does not fit shared memory in f32), ``ocols 128/64/128``
(column chunks of o, of dk and dv, and of dq of at most 128, 64 and 128
columns) and ``no fill`` (the fewest column chunks even where the grid
does not fill the card).

``mma rate``: a kernel that issues only ``mma.sync.m16n8k8`` TF32
products (8 independent accumulators a warp, 4 warps a block, 8 blocks
an SM, 2000 rounds) and one that issues ``m16n8k16`` fp16 ones: the
rate G1-G3 can reach at most with this instruction.

Times are CUDA events around 10 launches, median of 20 such batches
(``chip_smoke._median_ms``; a W3 of the first design at the full case:
2 launches, median of 3), every variant timed twice, in turns.  It exits
non-zero without a CUDA device or when a source edit no longer applies
(each must find its text exactly once in the source and its headers).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_ablation"

# The streamed tiles of P1, P3, P6 and P2 after the ring is full: signal,
# no load.
_P1_LOADS = """\
        mbar_arrive_expect_tx(&k_full[s], kKvBytes);
        tma_load_tile<DP>(sK + s * kKvBytes, &p.tk, &k_full[s], kFwdKv, h,
                          j * kFwdKv, b);
        mbar_arrive_expect_tx(&v_full[s], kKvBytes);
        tma_load_tile<DP>(sV + s * kKvBytes, &p.tv, &v_full[s], kFwdKv, h,
                          j * kFwdKv, b);
"""
_P3_LOADS = """\
        mbar_arrive_expect_tx(&full[s], 2 * kKvBytes);
        tma_load_tile<DP>(sK + s * kKvBytes, &p.tk, &full[s], kDqKv, h,
                          j * kDqKv, b);
        tma_load_tile<DP>(sV + s * kKvBytes, &p.tv, &full[s], kDqKv, h,
                          j * kDqKv, b);
"""
_P6_LOADS = """\
          mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
          tma_load_tile<DP>(sQ + s * kQBytes, &p.tq, &full[s], kFusedQ, h,
                            q0, b);
          tma_load_tile<DP>(sO + s * kQBytes, &p.tdo, &full[s], kFusedQ, h,
                            q0, b);
"""
_P2_LOADS = """\
          mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
          tma_load_tile<DP>(sQ + s * kQBytes, &p.tq, &full[s], kDkdvQ, h, q0,
                            b);
          tma_load_tile<DP>(sO + s * kQBytes, &p.tdo, &full[s], kDkdvQ, h,
                            q0, b);
"""
EDITS = {
    ("flash_fwd", "no reload"): [
        (_P1_LOADS, "if (j < p.stages) {\n" + _P1_LOADS + "} else {\n"
         "mbar_arrive(&k_full[s]);\nmbar_arrive(&v_full[s]);\n}\n")],
    ("flash_fwd", "no softmax"): [
        ("      // The mask, only on tiles that the diagonal or seq_len cross.",
         "#if 0\n"),
        ("      uint32_t pa[kFwdKv / 16][4];", "#endif\n"
         "      uint32_t pa[kFwdKv / 16][4];")],
    ("flash_fwd", "heads first"): [
        ("  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal "
         "tiles first\n  const int h = blockIdx.y;\n"
         "  const int b = blockIdx.z;",
         "  const int qt = gridDim.z - 1 - blockIdx.z;\n"
         "  const int h = blockIdx.x;\n  const int b = blockIdx.y;"),
        ("const dim3 grid((p.T + kFwdRows - 1) / kFwdRows, p.H, B);",
         "const dim3 grid(p.H, B, (p.T + kFwdRows - 1) / kFwdRows);")],
    ("flash_bwd_dkdv", "no reload"): [
        (_P2_LOADS, "if (it < p.stages) {\n" + _P2_LOADS + "} else {\n"
         "mbar_arrive(&full[s]);\n}\n")],
    ("flash_bwd_dkdv", "heads first"): [
        ("  const int kt = blockIdx.x;  // low kv tiles have the most causal "
         "work\n  const int h = blockIdx.y;\n  const int b = blockIdx.z;",
         "  const int kt = blockIdx.z;\n  const int h = blockIdx.x;\n"
         "  const int b = blockIdx.y;"),
        ("const dim3 grid((p.T + kDkdvKeys - 1) / kDkdvKeys, p.H, B);",
         "const dim3 grid(p.H, B, (p.T + kDkdvKeys - 1) / kDkdvKeys);")],
    ("flash_bwd_dq", "no reload"): [
        (_P3_LOADS, "if (j < p.stages) {\n" + _P3_LOADS + "} else {\n"
         "mbar_arrive(&full[s]);\n}\n")],
    ("flash_bwd_fused", "no reload"): [
        (_P6_LOADS, "if (it < p.stages) {\n" + _P6_LOADS + "} else {\n"
         "mbar_arrive(&full[s]);\n}\n")],
    ("flash_bwd_fused", "no dq sum"): [
        ("              tma_add(&p.tdq, buf + cb * kDqTile, 64 * cb, h, q0, "
         "b);\n", "")],
    ("flash_bwd_fused", "no dq"): [
        ("        if (dq_work) {", "        if (false) {")],
    ("flash_general", "one product"): [
        ("  if constexpr (std::is_same<E, float>::value) {\n"
         "    mma_tf32(c, ah, bl);",
         "  if constexpr (false) {\n    mma_tf32(c, ah, bl);")],
    ("flash_general", "always clamp"): [
        ("tile + 8 * ks * ld + 8 * (n0 + i), ld, g, t);",
         "tile + 8 * ks * ld + 8 * min(n0 + i, n_tiles - 1), ld, g, t);")],
    ("flash_general", "sum sets 1"): [
        ("constexpr int kSumSets = 2;", "constexpr int kSumSets = 1;")],
    ("flash_general", "no B split"): [
        ("      split<E>(__uint_as_float(x[i]), hi[i >> 1][i & 1], "
         "lo[i >> 1][i & 1]);",
         "      hi[i >> 1][i & 1] = lo[i >> 1][i & 1] = x[i];"),
        ("  split<E>(to_f32(s[2 * t * ld + g]), hi[0], lo[0]);\n"
         "  split<E>(to_f32(s[(2 * t + 1) * ld + g]), hi[1], lo[1]);",
         "  hi[0] = lo[0] = __float_as_uint(to_f32(s[2 * t * ld + g]));\n"
         "  hi[1] = lo[1] = "
         "__float_as_uint(to_f32(s[(2 * t + 1) * ld + g]));")],
    ("flash_general", "cvt.rna split"): [
        ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "  unsigned r;\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
         "  return r;")],
    ("flash_general", "no reload"): [
        ("    if (j + 1 < n_kv)\n      stage_tile(sK,",
         "    if (false)\n      stage_tile(sK,"),
        ("    if (j + 1 < n_kv)\n      stage_tile(sV,",
         "    if (false)\n      stage_tile(sV,"),
        ("    if (it + 1 < i_end) stage_q(it + 1);",
         "    if (false) stage_q(it + 1);"),
        ("    if (it + 1 < i_end)\n      stage_tile(sO,",
         "    if (false)\n      stage_tile(sO,"),
        ("    if (more)\n      stage_tile(sV,",
         "    if (false)\n      stage_tile(sV,"),
        ("    if (more)\n      stage_tile(sK,",
         "    if (false)\n      stage_tile(sK,")],
    ("flash_wide", "no reload"): [
        ("      if (i + 1 < n_steps) stage_step(i + 1);\n"
         "      cp_async_commit();\n"
         "      const int nk = wide_half_steps(d8 - d * 2 * w.dc, gr * w.dc, "
         "w.dc);\n      if (busy && nk > 0) {\n        const E* a",
         "      if (i + 1 < n_dc) stage_step(i + 1);\n"
         "      cp_async_commit();\n"
         "      const int nk = wide_half_steps(d8 - d * 2 * w.dc, gr * w.dc, "
         "w.dc);\n      if (busy && nk > 0) {\n        const E* a"),
        ("      if (d == 0)\n        stage_halves(sV,",
         "      if (j == 0 && d == 0)\n        stage_halves(sV,"),
        ("      if (i + 1 < n_steps) stage_step(i + 1);\n"
         "      cp_async_commit();\n"
         "      const int nk = wide_half_steps(d8 - d * 2 * w.dc, gr * w.dc, "
         "w.dc);\n      if (busy && nk > 0) {\n        const E* c",
         "      if (i + 1 < n_dc) stage_step(i + 1);\n"
         "      cp_async_commit();\n"
         "      const int nk = wide_half_steps(d8 - d * 2 * w.dc, gr * w.dc, "
         "w.dc);\n      if (busy && nk > 0) {\n        const E* c"),
        ("      if (d == 0) {\n        stage_halves(sQo",
         "      if (it == i_begin && d == 0) {\n"
         "        stage_halves(sQo"),
        ("      if (i + 1 < n_steps) stage_step(i + 1);\n"
         "      cp_async_commit();\n"
         "      const int nk = min(",
         "      if (i + 1 < n_dc) stage_step(i + 1);\n"
         "      cp_async_commit();\n"
         "      const int nk = min("),
        ("      if (d == 0)\n        stage_halves(sKo,",
         "      if (j == 0 && d == 0)\n        stage_halves(sKo,")],
    ("flash_wide", "one group stages"): [
        ("  const int gr = threadIdx.x / kGenThreads, half = n / 2;\n"
         "  stage_tile(s + gr * half * ld, ld, g, st, row0 + gr * half, half, "
         "T_, D,\n             d8, vec, static_cast<int>(threadIdx.x % "
         "kGenThreads));",
         "  if (threadIdx.x < kGenThreads)\n"
         "    stage_tile(s, ld, g, st, row0, n, T_, D, d8, vec,\n"
         "               static_cast<int>(threadIdx.x));")],
    ("flash_wide", "no products over D"): [
        ("      if (busy && nk > 0) {\n        const E* a = w.q_res",
         "      if (false) {\n        const E* a = w.q_res"),
        ("      if (busy && nk > 0) {\n        const E* c = sC",
         "      if (false) {\n        const E* c = sC"),
        ("      if (busy) {\n        const E* aq",
         "      if (false) {\n        const E* aq")],
    ("flash_wide", "no row products"): [
        ("      product_rows<E, NT, kTcKeys>(o, s, sV + gr * w.oc",
         "      if (false) product_rows<E, NT, kTcKeys>(o, s, sV + gr * w.oc"),
        ("      product_rows<E, NT, BQ>(dk, dp, sQo",
         "      if (false) product_rows<E, NT, BQ>(dk, dp, sQo"),
        ("      product_rows<E, NT, BQ>(dv, st, sOo",
         "      if (false) product_rows<E, NT, BQ>(dv, st, sOo"),
        ("    if (busy)\n      product_rows<E, NT, kTcKeys>(dq, dp,",
         "    if (false)\n      product_rows<E, NT, kTcKeys>(dq, dp,"),
        ("    if (busy1) {\n      get_part(",
         "    if (false) {\n      get_part(")],
}
EDITS[("flash_wide", "one product")] = EDITS[("flash_general", "one product")]

# Plan variants of W1-W3: ops/_cuda.py constants for the call.
WIDE_PLANS = {
    "q streamed": {"WIDE_Q_RESIDENT_SMEM": 0},
    "dcols 32/16/16": {"WIDE_DCOLS": {"flash_fwd_wide": 32,
                                      "flash_bwd_dkdv_wide": 16,
                                      "flash_bwd_dq_wide": 16}},
    "dcols 96/32/24": {"WIDE_DCOLS": {"flash_fwd_wide": 96,
                                      "flash_bwd_dkdv_wide": 32,
                                      "flash_bwd_dq_wide": 24}},
    "ocols 128/64/128": {"WIDE_OCOLS": {"flash_fwd_wide": 128,
                                        "flash_bwd_dkdv_wide": 64,
                                        "flash_bwd_dq_wide": 128}},
    "no fill": {"WIDE_SMS": 0},
}

# Only mma.sync products, 8 independent accumulators a warp: the rate of
# the instruction itself.
MMA_RATE = r"""
#include <cuda_runtime.h>
template <int KIND>
__global__ void rate(float* out, int rounds) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u ^ (threadIdx.x * 7 + i);
  b[0] = 0x3f000000u ^ threadIdx.x;
  b[1] = 0x3e000000u ^ threadIdx.x;
  float c[8][4] = {};
  for (int i = 0; i < rounds; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(int kind, int blocks, int rounds, float* out) {
  if (kind == 0) rate<0><<<blocks, 128>>>(out, rounds);
  else rate<1><<<blocks, 128>>>(out, rounds);
  return cudaGetLastError();
}
"""


def _fail(msg: str) -> None:
    print(f"flash_ablation: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _sources(csrc: Path, stem: str, edits) -> dict:
    """The text of ``csrc/<stem>.cu`` and of every header beside it, with
    ``edits`` applied; each must find its text exactly once in them."""
    texts = {f.name: f.read_text()
             for f in [csrc / f"{stem}.cu", *sorted(csrc.glob("*.cuh"))]}
    for old, new in edits:
        hits = [name for name, text in texts.items() if old in text]
        if len(hits) != 1 or texts[hits[0]].count(old) != 1:
            _fail(f"the edit of {stem} no longer applies: {old[:60]!r}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    return texts


def _build_all(variants: dict, csrc: Path, parent) -> dict:
    """The library of ``csrc/<stem>.cu`` with each variant's edits (the
    parent's source for "parent"), by (stem, variant); each variant's
    sources in a directory of their own, one ``nvcc`` per library, all
    started together."""
    from horovod_tpu_torch.ops import _cuda
    procs = {}
    for stem, names in variants.items():
        for variant in names:
            if variant == "parent":
                texts = _sources(parent, stem, [])
            else:
                texts = _sources(csrc, stem, EDITS.get((stem, variant), []))
            d = OUT / f"{stem}_{variant.replace(' ', '_')}"
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            for name, text in texts.items():
                (d / name).write_text(text)
            src, lib = d / f"{stem}.cu", d / f"lib{stem}.so"
            procs[(stem, variant)] = (src, lib, subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (src, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            _fail(f"nvcc failed for {key}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for symbol, argtypes in _cuda._ARGTYPES.items():
            if hasattr(handle, symbol):
                fn = getattr(handle, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[key] = handle
    return libs


def _parent_calls(src, lib, c, lse, delta) -> dict:
    """Calls of the parent's W3 on case ``c`` where it is of the first
    design (``src``: the parent's ``flash_wide.cu``): one query row a
    block, whose entry point takes only its shared memory, 12 D bytes.
    Empty where the parent's W1-W3 take the committed arguments."""
    from horovod_tpu_torch.ops import _cuda
    if "wide_dq_smem_bytes" not in src:
        return {}
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    B, T, C, D = c["B"], c["T"], q.shape[-1], c["D"]
    tail = (B, H, T, D, T, 1, c["scale"])
    views = [a for x in (q, k, v, do) for a in (x.data_ptr(), *x.stride()[:2])]
    stream = torch.cuda.current_stream().cuda_stream
    dq = torch.empty((B, T, C), device="cuda")
    fn = lib.htt_flash_bwd_dq_wide
    fn.argtypes = (_cuda._I,) + _cuda._VIEW * 4 + (_cuda._P, _cuda._P) \
        + _cuda._VIEW + (_cuda._I,) * 6 + (_cuda._F, _cuda._I, _cuda._P)

    def w3():
        _cuda._check(fn(0, *views, lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), *dq.stride()[:2], *tail, 12 * D,
                        stream), "parent W3")
    return {"flash_bwd_dq_wide": w3}


def _mma_rate() -> list:
    """TFLOP/s of mma.sync alone: TF32 m16n8k8 and fp16 m16n8k16, each
    timed twice with CUDA events after a warm-up launch."""
    from horovod_tpu_torch.ops import _cuda
    src, lib = OUT / "mma_rate.cu", OUT / "libmma_rate.so"
    src.write_text(MMA_RATE)
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        _fail(f"nvcc failed for mma_rate.cu:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(lib)).mma_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, rounds = 8 * sms, 2000
    out = torch.empty(blocks * 128, device="cuda")
    rows = []
    for kind, name, flop in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                             (1, "mma.sync m16n8k16 f16", 2 * 16 * 8 * 16)):
        fn(kind, blocks, 10, out.data_ptr())
        ms = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(kind, blocks, rounds, out.data_ptr())
            end.record()
            end.synchronize()
            if err:
                _fail(f"mma_rate launch failed with CUDA error {err}")
            ms.append(start.elapsed_time(end))
        total = blocks * 4 * rounds * 8 * flop
        tflops = [total / t / 1e9 for t in ms]
        print(f"{name}: " + " ".join(f"{t:.1f}" for t in tflops)
              + " TFLOP/s")
        rows.append({"instruction": name, "tflops": tflops})
    return rows


def _wide_times(cs, libs, parent_lib, parent_src, label, case) -> dict:
    """W1-W3 on ``case`` (f32): the committed kernels, their text variants
    and plan variants, and the parent's (``parent_src``: its
    ``flash_wide.cu``), in turns."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    c = cs._case(case["B"], case["H"], case["T"], case["D"], True, None,
                 gen, torch.float32)
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=True, seq_len=None)
    o, lse = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    del o
    calls = {"flash_fwd_wide": lambda: _cuda.flash_fwd(q, k, v, H, **kw),
             "flash_bwd_dkdv_wide": lambda: _cuda.flash_bwd_dkdv(
                 q, k, v, do, lse, delta, H, **kw),
             "flash_bwd_dq_wide": lambda: _cuda.flash_bwd_dq(
                 q, k, v, do, lse, delta, H, **kw)}
    texts = [n for (stem, n) in libs if stem == "flash_wide"]
    names = texts + list(WIDE_PLANS) + (["parent"] if parent_lib else [])
    committed = libs[("flash_wide", "kernel")]
    saved = {n: getattr(_cuda, n) for p in WIDE_PLANS.values() for n in p}
    times: dict = {}
    for name in names + names[::-1]:
        _cuda._LIBS["flash_wide"] = (parent_lib if name == "parent" else
                                     libs.get(("flash_wide", name), committed))
        for n, value in WIDE_PLANS.get(name, {}).items():
            setattr(_cuda, n, value)
        timed = calls
        slow = name == "parent" and "wide_dq_smem_bytes" in parent_src
        if name == "parent":
            timed = dict(calls, **_parent_calls(parent_src, parent_lib, c,
                                                lse, delta))
        for kernel, call in timed.items():
            times.setdefault((kernel, label, name), []).append(
                cs._median_ms(call, runs=3, warmup=1, reps=2)
                if slow and kernel == "flash_bwd_dq_wide" and label == "full"
                else cs._median_ms(call))
        for n, value in saved.items():
            setattr(_cuda, n, value)
    plans = {}
    for name in ["kernel"] + list(WIDE_PLANS):
        for n, value in WIDE_PLANS.get(name, {}).items():
            setattr(_cuda, n, value)
        for kernel in calls:
            p = _cuda.wide_plan(kernel, c["B"], H, c["T"], c["D"])
            plans[(kernel, label, name)] = {
                "ocols": p.ocols, "dcols": p.dcols, "q_resident":
                p.q_resident, "smem_bytes": p.smem_bytes,
                "blocks": p.grid[0] * H * c["B"], "products": p.products}
        for n, value in saved.items():
            setattr(_cuda, n, value)
    return times, plans


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an earlier commit's csrc directory")
    parser.add_argument("--wide-only", action="store_true",
                        help="W1-W3 alone, and the mma rate")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    gpu = cs._gpu_line()
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "horovod_tpu_torch" / "csrc"
    variants = {"flash_fwd": ["kernel", "no reload", "no softmax",
                              "heads first"],
                "flash_bwd_dkdv": ["kernel", "no reload", "heads first"],
                "flash_bwd_dq": ["kernel", "no reload"],
                "flash_bwd_fused": ["kernel", "no reload", "no dq sum",
                                    "no dq"],
                "flash_general": ["kernel", "one product", "no B split",
                                  "cvt.rna split", "always clamp",
                                  "sum sets 1", "no reload"],
                "flash_wide": ["kernel", "no reload", "no products over D",
                               "no row products", "one product",
                               "one group stages"]}
    if args.parent:
        variants["flash_general"].insert(1, "parent")
        variants["flash_wide"].append("parent")
    if args.wide_only:
        variants = {"flash_wide": variants["flash_wide"]}
    libs = _build_all(variants, csrc, args.parent)
    parent_wide = libs.pop(("flash_wide", "parent"), None)
    parent_src = ((args.parent / "flash_wide.cu").read_text()
                  if args.parent else "")

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    c = cs._case(cs.BATCH, cs.HEADS, cs.SEQ, cs.DIM // cs.HEADS, True, None,
                 gen)
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=True, seq_len=None)
    o, lse = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    g = cs._case(cs.BATCH, cs.HEADS, cs.SEQ, cs.DIM // cs.HEADS, True,
                 None, gen, torch.float32)
    gq, gk, gv, gdo = g["q"], g["k"], g["v"], g["do"]
    go, glse = fa._flash_fwd_plain(gq, gk, gv, H, **kw)
    gdelta = fa._delta(gdo, go, H)
    del go
    general = {
        "flash_fwd_general": lambda: _cuda.flash_fwd(gq, gk, gv, H, **kw),
        "flash_bwd_dkdv_general": lambda: _cuda.flash_bwd_dkdv(
            gq, gk, gv, gdo, glse, gdelta, H, **kw),
        "flash_bwd_dq_general": lambda: _cuda.flash_bwd_dq(
            gq, gk, gv, gdo, glse, gdelta, H, **kw)}
    calls = {
        "flash_fwd": lambda: _cuda.flash_fwd(q, k, v, H, **kw),
        "flash_bwd_dkdv": lambda: _cuda.flash_bwd_dkdv(
            q, k, v, do, lse, delta, H, **kw),
        "flash_bwd_dq": lambda: _cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, H, **kw),
        "flash_bwd_fused": lambda: _cuda.flash_bwd_fused(
            q, k, v, do, lse, delta, H, **kw),
    }
    times: dict = {}
    for stem, names in variants.items():
        if stem == "flash_wide":
            continue
        timed = general if stem == "flash_general" else {stem: calls[stem]}
        for v_name in names + names[::-1]:
            _cuda._LIBS[stem] = libs[(stem, v_name)]
            for kernel, call in timed.items():
                times.setdefault((kernel, v_name), []).append(
                    cs._median_ms(call))
    del q, k, v, do, o, lse, delta, gq, gk, gv, gdo, glse, gdelta
    torch.cuda.empty_cache()
    plans = {}
    for label, case in (("full", cs.WIDE_FULL_CASE), ("small", cs.WIDE_CASE)):
        t, p = _wide_times(cs, libs, parent_wide, parent_src, label, case)
        times.update(t)
        plans.update(p)
    _cuda._LIBS.clear()
    rows = []
    for key, ts in times.items():
        kernel, v_name = key[0], key[-1]
        base = min(times[key[:-1] + ("kernel",)])
        rows.append({"kernel": kernel, "variant": v_name, "ms": ts,
                     "vs_kernel": min(ts) / base,
                     **({"case": key[1]} if len(key) == 3 else {}),
                     **plans.get(key, {})})
        print(f"{kernel:22s} {' '.join(key[1:]):24s} "
              + " ".join(f"{t:.4f}" for t in ts)
              + f" ms, {min(ts) / base:.3f} of the kernel's time"
              + (f" ({plans[key]})" if key in plans else ""))
    rates = _mma_rate()
    print(gpu)
    print(json.dumps({"ablation": rows, "mma_rate": rates}))


if __name__ == "__main__":
    main()
