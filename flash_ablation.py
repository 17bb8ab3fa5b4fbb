"""What bounds the Hopper flash kernels P1, P2, P3 and P6, and the general
family's G1, G2 and G3, on the card: each one timed against variants of
itself, and the rate of the tensor-core instruction G1-G3 issue.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 flash_ablation.py

The variants are text edits of the committed sources
(``horovod_tpu_torch/csrc/flash_fwd.cu``, ``flash_bwd_dkdv.cu``,
``flash_bwd_dq.cu``, ``flash_bwd_fused.cu`` and ``flash_general.cu``),
built with the port's ``nvcc`` flags into ``build/flash_ablation/`` and
timed at the training shape of ``chip_smoke.py`` (B 8, H 16, T 2048, D
128, causal; bf16 for P1-P6, f32 for G1-G3).  Their outputs are
wrong by design; only their times count.

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

``mma rate``: a kernel that issues only ``mma.sync.m16n8k8`` TF32
products (8 independent accumulators a warp, 4 warps a block, 8 blocks
an SM, 2000 rounds) and one that issues ``m16n8k16`` fp16 ones: the
rate G1-G3 can reach at most with this instruction.

Times are CUDA events around 10 launches, median of 20 such batches
(``chip_smoke._median_ms``), every variant timed twice, in turns.  It
exits non-zero without a CUDA device or when a source edit no longer
applies.
"""

from __future__ import annotations

import ctypes
import json
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


def _build_all(variants: dict, csrc: Path) -> dict:
    """The library of ``csrc/<stem>.cu`` with each variant's edits, by
    (stem, variant); one ``nvcc`` per library, all started together."""
    from horovod_tpu_torch.ops import _cuda
    procs = {}
    for stem, names in variants.items():
        for variant in names:
            text = (csrc / f"{stem}.cu").read_text()
            for old, new in EDITS.get((stem, variant), []):
                if text.count(old) != 1:
                    _fail(f"{variant}: the edit of {stem}.cu no longer "
                          f"applies: {old[:60]!r}")
                text = text.replace(old, new)
            tag = variant.replace(" ", "_")
            src = OUT / f"{stem}_{tag}.cu"
            lib = OUT / f"lib{stem}_{tag}.so"
            src.write_text(text)
            procs[(stem, variant)] = (src, lib, subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(csrc), "-o",
                 str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (src, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            _fail(f"nvcc failed for {src.name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for symbol, argtypes in _cuda._ARGTYPES.items():
            if hasattr(handle, symbol):
                fn = getattr(handle, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[key] = handle
    return libs


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


def main() -> None:
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
                                  "sum sets 1", "no reload"]}
    libs = _build_all(variants, csrc)

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
        timed = general if stem == "flash_general" else {stem: calls[stem]}
        for v_name in names + names[::-1]:
            _cuda._LIBS[stem] = libs[(stem, v_name)]
            for kernel, call in timed.items():
                times.setdefault((kernel, v_name), []).append(
                    cs._median_ms(call))
    _cuda._LIBS.clear()
    rows = []
    for (kernel, v_name), ts in times.items():
        base = min(times[(kernel, "kernel")])
        rows.append({"kernel": kernel, "variant": v_name, "ms": ts,
                     "vs_kernel": min(ts) / base})
        print(f"{kernel:22s} {v_name:12s} "
              + " ".join(f"{t:.4f}" for t in ts)
              + f" ms, {min(ts) / base:.3f} of the kernel's time")
    rates = _mma_rate()
    print(gpu)
    print(json.dumps({"ablation": rows, "mma_rate": rates}))


if __name__ == "__main__":
    main()
