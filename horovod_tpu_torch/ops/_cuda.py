"""Build, load and launch the port's hand-written CUDA kernels.

No JAX counterpart: the JAX package's kernels are Pallas programs that XLA
compiles.  Here every ``csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/horovod_tpu_torch/`` beside the package (one ``nvcc`` per
source, all started together), and loaded with ``ctypes``.  Each library is
named by a hash of its sources and flags, so an edit rebuilds it and an
unchanged tree reuses it.

Each launch wrapper checks its tensors, allocates what it returns with
``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, raises when the C entry point reports a CUDA error, and adds
one to its entry of :data:`LAUNCHES`.  Nothing here falls back to anything:
a call either launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the last reset_launches(), per kernel.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
    "flash_bwd_fused": 0, "int8_quantize": 0, "int8_dequantize": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_VIEW = (_P, _I64, _I64)          # pointer, batch stride, row stride
_TAIL = (_I,) * 6 + (_F, _P)       # B, H, T, D, seq_len, causal, scale, stream
_PLAN_TAIL = _TAIL[:-1] + (_I, _I, _P)   # ... scale, stages, smem bytes, stream
_ARGTYPES = {
    "htt_flash_fwd": _VIEW * 4 + (_P,) + _PLAN_TAIL,
    "htt_flash_bwd_dkdv": _VIEW * 4 + (_P, _P) + _VIEW * 2 + _PLAN_TAIL,
    "htt_flash_bwd_dq": _VIEW * 4 + (_P, _P) + _VIEW + _TAIL,
    "htt_flash_bwd_fused": _VIEW * 4 + (_P, _P) + _VIEW * 3 + (_P,) + _TAIL,
    "htt_int8_quantize": (_P, _P, _P, _I64, _P),
    "htt_int8_dequantize": (_P, _P, _P, _I64, _P),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


def _target(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [source] + sorted(CSRC.glob("*.cuh")):
        digest.update(dep.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build() -> Tuple[Dict[str, Path], float, str]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` process per source, all at once.  Returns ``({stem: library},
    seconds, compiler log)``; raises ``RuntimeError`` with the compiler's
    output when a source does not build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for stem, tmp, out, proc in procs:
        text, _ = proc.communicate()
        log.append(f"--- {stem}.cu\n{text}")
        if proc.returncode != 0:
            failed.append(stem)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError(
            f"nvcc failed for {', '.join(f + '.cu' for f in failed)}:\n"
            + "\n".join(log))
    return ({stem: out for stem, (_, out) in targets.items()},
            time.perf_counter() - t0, "\n".join(log))


def _lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built at first use."""
    if stem not in _LIBS:
        libs, _, _ = build()
        for name, path in libs.items():
            if name in _LIBS:
                continue
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in _ARGTYPES.items():
                if hasattr(lib, symbol):
                    fn = getattr(lib, symbol)
                    fn.argtypes = argtypes
                    fn.restype = _I
            _LIBS[name] = lib
    return _LIBS[stem]


def _view(x: torch.Tensor, name: str, shape, device) -> tuple:
    """(pointer, batch stride, row stride) of a (B, T, C) bf16 view that
    the kernels can read: unit column stride, strides that keep every row
    16-byte aligned."""
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not kernel_strides_ok(x.stride(), x.data_ptr()):
        raise ValueError(
            f"{name}: the kernels need unit column stride, batch and row "
            f"strides that are multiples of 8 and a 16-byte aligned start; "
            f"got strides {x.stride()}")
    sb, st, _ = x.stride()
    return x.data_ptr(), sb, st


def kernel_strides_ok(strides, data_ptr: int) -> bool:
    """Whether the flash kernels read a (B, T, C) bf16 view with these
    element strides and start address: unit column stride, batch and row
    strides that are multiples of 8, a 16-byte aligned start (what TMA
    and the 16-byte loads need)."""
    sb, st, sc = strides
    return sc == 1 and sb % 8 == 0 and st % 8 == 0 and data_ptr % 16 == 0


def _rows(x: torch.Tensor, name: str, shape, device) -> int:
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of "
                         f"shape {tuple(shape)}")
    return x.data_ptr()


def _geometry(q: torch.Tensor, num_heads: int, seq_len: Optional[int]):
    if q.dim() != 3:
        raise ValueError(f"q must be (B, T, H*D), got shape "
                         f"{tuple(q.shape)}")
    B, T, C = q.shape
    H = int(num_heads)
    if H < 1 or C % H:
        raise ValueError(f"width {C} is not a multiple of num_heads={H}")
    D = C // H
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"the flash kernels take a head size that is a "
                         f"multiple of 16 up to 128, got D={D}")
    lim = T if seq_len is None else int(seq_len)
    if not 0 < lim <= T:
        raise ValueError(f"seq_len {seq_len} out of range for T={T}")
    return B, T, C, H, D, lim


# The launch plan of the warp-specialised kernels P1 (csrc/flash_fwd.cu)
# and P2 (csrc/flash_bwd_dkdv.cu); their C entry points check it.
SMEM_LIMIT = 232_448     # dynamic shared memory a block may use on an H100
_BLOCK_COLS = 64         # bf16 columns of one 128-byte swizzled TMA box
_STAGES = 2              # buffers in the ring of streamed tiles


class FlashPlan(NamedTuple):
    d_pad: int           # head size padded in shared memory: 64 or 128
    rows: int            # rows of the block's own tile (q for P1, k/v P2)
    stream_rows: int     # rows of each streamed tile (k/v for P1, q/dO P2)
    grid: Tuple[int, int, int]   # (tiles, H, B): x tile, y head, z batch
    stages: int
    smem_bytes: int
    boxes: Dict[str, Tuple[int, int, int, int]]  # TMA box per operand,
    #                      (columns, heads, rows, batches), innermost first


def flash_plan(kernel: str, B: int, H: int, T: int, D: int) -> FlashPlan:
    """Launch geometry of P1 (``"flash_fwd"``) or P2
    (``"flash_bwd_dkdv"``) for a (B, T, H*D) problem.  P1: one block per
    128-row q tile (x = 0 is the last tile, the heaviest under causality),
    k and v streamed in 128-row tiles.  P2: one block per 128-key kv tile
    (x = 0 first, the heaviest), q and dO streamed in 64-row tiles with
    their lse and delta.  The tiles of one head are neighbours in the
    grid, so that the tiles they all stream stay in L2.  Shared memory
    holds 1024 bytes of alignment slack, the tiles at ``d_pad`` columns
    and 8-byte mbarriers."""
    d_pad = 64 if D <= 64 else 128

    def tile(rows):
        return rows * d_pad * 2

    def box(rows):
        return (_BLOCK_COLS, 1, rows, 1)

    if kernel == "flash_fwd":
        rows, stream = 128, 128
        smem = 1024 + tile(rows) + 2 * _STAGES * tile(stream) \
            + 8 * (1 + 3 * _STAGES)
        boxes = {"q": box(rows), "k": box(stream), "v": box(stream)}
    elif kernel == "flash_bwd_dkdv":
        rows, stream = 128, 64
        smem = 1024 + 2 * tile(rows) \
            + _STAGES * (2 * tile(stream) + 2 * stream * 4) \
            + 8 * (1 + 2 * _STAGES)
        boxes = {"k": box(rows), "v": box(rows), "q": box(stream),
                 "do": box(stream)}
    else:
        raise ValueError(f"no launch plan for kernel {kernel!r}")
    return FlashPlan(d_pad, rows, stream, (-(-T // rows), H, B), _STAGES,
                     smem, boxes)


def tma_strides(D: int, st: int, sb: int) -> Tuple[int, int, int]:
    """Byte strides of the (D, H, T, B) tensor map over a (B, T, H*D) bf16
    view with row stride ``st`` and batch stride ``sb`` (elements): head,
    row, batch.  TMA needs each a multiple of 16."""
    return 2 * D, 2 * st, 2 * sb


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def flash_fwd(q, k, v, num_heads: int, *, scale: float, causal: bool,
              seq_len: Optional[int] = None):
    """Port kernel P1.  q, k, v: (B, T, H*D) bf16 views (they may be column
    regions of one tensor).  Returns o (B, T, H*D) bf16 and lse (B, H, T)
    f32."""
    B, T, C, H, D, lim = _geometry(q, num_heads, seq_len)
    dev = q.device
    args = [a for x, n in ((q, "q"), (k, "k"), (v, "v"))
            for a in _view(x, n, (B, T, C), dev)]
    plan = flash_plan("flash_fwd", B, H, T, D)
    fn = _lib("flash_fwd").htt_flash_fwd
    o = torch.empty((B, T, C), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, *_view(o, "o", (B, T, C), dev), lse.data_ptr(),
                 B, H, T, D, lim, int(bool(causal)), float(scale),
                 plan.stages, plan.smem_bytes, stream)
    _check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta, num_heads, seq_len):
    B, T, C, H, D, lim = _geometry(q, num_heads, seq_len)
    dev = q.device
    args = [a for x, n in ((q, "q"), (k, "k"), (v, "v"), (do, "do"))
            for a in _view(x, n, (B, T, C), dev)]
    args += [_rows(lse, "lse", (B, H, T), dev),
             _rows(delta, "delta", (B, H, T), dev)]
    return (B, T, C, H, D, lim, dev), args


def flash_bwd_dkdv(q, k, v, do, lse, delta, num_heads: int, *,
                   scale: float, causal: bool,
                   seq_len: Optional[int] = None, dk=None, dv=None):
    """Port kernel P2.  Inputs as :func:`flash_fwd` plus dO (B, T, H*D)
    bf16 and lse, delta (B, H, T) f32.  Writes dk and dv into the given
    (B, T, H*D) bf16 views, or into new tensors; returns (dk, dv)."""
    (B, T, C, H, D, lim, dev), args = _bwd_inputs(
        q, k, v, do, lse, delta, num_heads, seq_len)
    plan = flash_plan("flash_bwd_dkdv", B, H, T, D)
    fn = _lib("flash_bwd_dkdv").htt_flash_bwd_dkdv
    dk = torch.empty((B, T, C), dtype=k.dtype, device=dev) if dk is None \
        else dk
    dv = torch.empty((B, T, C), dtype=v.dtype, device=dev) if dv is None \
        else dv
    outs = [*_view(dk, "dk", (B, T, C), dev), *_view(dv, "dv", (B, T, C),
                                                     dev)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, *outs, B, H, T, D, lim, int(bool(causal)),
                 float(scale), plan.stages, plan.smem_bytes, stream)
    _check(err, "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, num_heads: int, *, scale: float,
                 causal: bool, seq_len: Optional[int] = None, dq=None):
    """Port kernel P3.  Inputs as :func:`flash_bwd_dkdv`; writes dq into the
    given (B, T, H*D) bf16 view, or into a new tensor, and returns it."""
    (B, T, C, H, D, lim, dev), args = _bwd_inputs(
        q, k, v, do, lse, delta, num_heads, seq_len)
    fn = _lib("flash_bwd").htt_flash_bwd_dq
    dq = torch.empty((B, T, C), dtype=q.dtype, device=dev) if dq is None \
        else dq
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, *_view(dq, "dq", (B, T, C), dev), B, H, T, D, lim,
                 int(bool(causal)), float(scale), stream)
    _check(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_fused(q, k, v, do, lse, delta, num_heads: int, *,
                    scale: float, causal: bool,
                    seq_len: Optional[int] = None, dq=None, dk=None,
                    dv=None):
    """Port kernel P6, the one-pass backward.  Inputs as
    :func:`flash_bwd_dkdv`; writes dq, dk and dv into the given
    (B, T, H*D) bf16 views, or into new tensors, and returns (dq, dk, dv).
    dq is summed in an f32 workspace of (B, T, H*D) with atomics, so its
    last bits vary from run to run."""
    (B, T, C, H, D, lim, dev), args = _bwd_inputs(
        q, k, v, do, lse, delta, num_heads, seq_len)
    fn = _lib("flash_bwd_fused").htt_flash_bwd_fused
    dq = torch.empty((B, T, C), dtype=q.dtype, device=dev) if dq is None \
        else dq
    dk = torch.empty((B, T, C), dtype=k.dtype, device=dev) if dk is None \
        else dk
    dv = torch.empty((B, T, C), dtype=v.dtype, device=dev) if dv is None \
        else dv
    outs = [a for x, n in ((dq, "dq"), (dk, "dk"), (dv, "dv"))
            for a in _view(x, n, (B, T, C), dev)]
    work = torch.empty((B, T, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, *outs, work.data_ptr(), B, H, T, D, lim,
                 int(bool(causal)), float(scale), stream)
    _check(err, "flash_bwd_fused")
    LAUNCHES["flash_bwd_fused"] += 1
    return dq, dk, dv


_CODEC_BLOCK = 1024
_MAX_GRID = 2 ** 31 - 1


def _codec_tensor(x, name: str, dtype, shape, align: int,
                  device=None) -> int:
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must start {align}-byte aligned")
    return x.data_ptr()


def _codec_blocks(x, name: str) -> int:
    if not isinstance(x, torch.Tensor) or x.dim() != 2 \
            or x.shape[1] != _CODEC_BLOCK:
        raise ValueError(f"{name} must be (blocks, {_CODEC_BLOCK}), got "
                         f"{getattr(x, 'shape', None)}")
    blocks = int(x.shape[0])
    if blocks > _MAX_GRID:
        raise ValueError(f"{blocks} blocks exceed one launch")
    return blocks


def int8_quantize(grid):
    """Port kernel P4.  grid: (blocks, 1024) contiguous f32.  Returns
    (q int8 (blocks, 1024), scales f32 (blocks, 1))."""
    blocks = _codec_blocks(grid, "grid")
    x = _codec_tensor(grid, "grid", torch.float32, grid.shape, 16)
    dev = grid.device
    q = torch.empty((blocks, _CODEC_BLOCK), dtype=torch.int8, device=dev)
    scales = torch.empty((blocks, 1), dtype=torch.float32, device=dev)
    if blocks == 0:
        return q, scales
    fn = _lib("int8_codec").htt_int8_quantize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x, q.data_ptr(), scales.data_ptr(), blocks, stream)
    _check(err, "int8_quantize")
    LAUNCHES["int8_quantize"] += 1
    return q, scales


def int8_dequantize(q, scales):
    """Port kernel P5.  q: (blocks, 1024) contiguous int8, scales: (blocks,
    1) contiguous f32 on the same device.  Returns ``float(q) * scale`` as
    (blocks, 1024) f32."""
    blocks = _codec_blocks(q, "q")
    qp = _codec_tensor(q, "q", torch.int8, q.shape, 4)
    dev = q.device
    sp = _codec_tensor(scales, "scales", torch.float32, (blocks, 1), 4,
                       dev)
    out = torch.empty((blocks, _CODEC_BLOCK), dtype=torch.float32,
                      device=dev)
    if blocks == 0:
        return out
    fn = _lib("int8_codec").htt_int8_dequantize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qp, sp, out.data_ptr(), blocks, stream)
    _check(err, "int8_dequantize")
    LAUNCHES["int8_dequantize"] += 1
    return out
