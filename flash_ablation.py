"""What bounds the Hopper flash kernels P1, P2, P3 and P6 on the card: each
one timed against variants of itself.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 flash_ablation.py

The variants are text edits of the committed sources
(``horovod_tpu_torch/csrc/flash_fwd.cu``, ``flash_bwd_dkdv.cu``,
``flash_bwd_dq.cu`` and ``flash_bwd_fused.cu``), built
with the port's ``nvcc`` flags into ``build/flash_ablation/`` and timed at
the training shape of ``chip_smoke.py`` (B 8, H 16, T 2048, D 128, bf16,
causal).  Their outputs are wrong by design; only their times count.

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
}


def _fail(msg: str) -> None:
    print(f"flash_ablation: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _build(stem: str, variant: str, csrc: Path) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu`` with ``variant``'s edits."""
    from horovod_tpu_torch.ops import _cuda
    text = (csrc / f"{stem}.cu").read_text()
    for old, new in EDITS.get((stem, variant), []):
        if text.count(old) != 1:
            _fail(f"{variant}: the edit of {stem}.cu no longer applies: "
                  f"{old[:60]!r}")
        text = text.replace(old, new)
    tag = variant.replace(" ", "_")
    src = OUT / f"{stem}_{tag}.cu"
    lib = OUT / f"lib{stem}_{tag}.so"
    src.write_text(text)
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(csrc),
                        "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        _fail(f"nvcc failed for {src.name}:\n{r.stdout}{r.stderr}")
    handle = ctypes.CDLL(str(lib))
    fn = getattr(handle, f"htt_{stem}")
    fn.argtypes = _cuda._ARGTYPES[f"htt_{stem}"]
    fn.restype = ctypes.c_int
    return handle


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
                                    "no dq"]}
    libs = {(stem, v): _build(stem, v, csrc)
            for stem, names in variants.items() for v in names}

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    c = cs._case(cs.BATCH, cs.HEADS, cs.SEQ, cs.DIM // cs.HEADS, True, None,
                 gen)
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=True, seq_len=None)
    o, lse = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
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
        for v_name in names + names[::-1]:
            _cuda._LIBS[stem] = libs[(stem, v_name)]
            times.setdefault((stem, v_name), []).append(
                cs._median_ms(calls[stem]))
    _cuda._LIBS.clear()
    rows = []
    for (stem, v_name), ts in times.items():
        base = min(times[(stem, "kernel")])
        rows.append({"kernel": stem, "variant": v_name, "ms": ts,
                     "vs_kernel": min(ts) / base})
        print(f"{stem:15s} {v_name:12s} " + " ".join(f"{t:.4f}" for t in ts)
              + f" ms, {min(ts) / base:.3f} of the kernel's time")
    print(gpu)
    print(json.dumps({"ablation": rows}))


if __name__ == "__main__":
    main()
