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
    "flash_bwd_fused": 0, "flash_fwd_general": 0,
    "flash_bwd_dkdv_general": 0, "flash_bwd_dq_general": 0,
    "flash_fwd_wide": 0, "flash_bwd_dkdv_wide": 0, "flash_bwd_dq_wide": 0,
    "int8_quantize": 0, "int8_dequantize": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_VIEW = (_P, _I64, _I64)          # pointer, batch stride, row stride
# B, H, T, D, seq_len, causal, scale, stages, smem bytes, stream
_PLAN_TAIL = (_I,) * 6 + (_F, _I, _I, _P)
# B, H, T, D, seq_len, causal, scale, copy bytes, smem bytes, stream
_GEN_TAIL = (_I,) * 6 + (_F, _I, _I, _P)
# B, H, T, D, seq_len, causal, scale, copy bytes, column chunk, D chunk,
# q resident, smem bytes, stream
_WIDE_TC_TAIL = (_I,) * 6 + (_F,) + (_I,) * 5 + (_P,)
_ARGTYPES = {
    "htt_flash_fwd": _VIEW * 4 + (_P,) + _PLAN_TAIL,
    "htt_flash_bwd_dkdv": _VIEW * 4 + (_P, _P) + _VIEW * 2 + _PLAN_TAIL,
    "htt_flash_bwd_dq": _VIEW * 4 + (_P, _P) + _VIEW + _PLAN_TAIL,
    "htt_flash_bwd_fused": _VIEW * 4 + (_P, _P) + _VIEW * 3 + (_P,)
    + _PLAN_TAIL,
    "htt_flash_fwd_general": (_I,) + _VIEW * 4 + (_P,) + _GEN_TAIL,
    "htt_flash_bwd_dkdv_general": (_I,) + _VIEW * 4 + (_P, _P) + _VIEW * 2
    + _GEN_TAIL,
    "htt_flash_bwd_dq_general": (_I,) + _VIEW * 4 + (_P, _P) + _VIEW
    + _GEN_TAIL,
    "htt_flash_fwd_wide": (_I,) + _VIEW * 4 + (_P,) + _WIDE_TC_TAIL,
    "htt_flash_bwd_dkdv_wide": (_I,) + _VIEW * 4 + (_P, _P) + _VIEW * 2
    + _WIDE_TC_TAIL,
    "htt_flash_bwd_dq_wide": (_I,) + _VIEW * 4 + (_P, _P) + _VIEW
    + _WIDE_TC_TAIL,
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
    seconds, compiler log)``, the log of a library built earlier read from
    beside it; raises ``RuntimeError`` with the compiler's output when a
    source does not build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    log = []
    for stem, (src, out) in targets.items():
        if out.exists():
            saved = out.with_suffix(".log")
            if saved.exists():
                log.append(saved.read_text())
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, tmp, out, proc in procs:
        text, _ = proc.communicate()
        log.append(f"--- {stem}.cu\n{text}")
        if proc.returncode != 0:
            failed.append(stem)
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log[-1])
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


def kernel_strides_ok(strides, data_ptr: int) -> bool:
    """Whether the Hopper flash kernels read a (B, T, C) bf16 view with
    these element strides and start address: unit column stride, batch and
    row strides that are multiples of 8, a 16-byte aligned start (what TMA
    and the 16-byte loads need)."""
    sb, st, sc = strides
    return sc == 1 and sb % 8 == 0 and st % 8 == 0 and data_ptr % 16 == 0


# Element types of the general family, by the dtype code of its entry
# points.
_GEN_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
GENERAL_MAX_D = 256
# Shared memory a block may have on an H100, static and dynamic together.
SMEM_LIMIT = 232_448
# The largest head size of the wide route (csrc/flash_wide.cu): the
# inputs it accepts, fixed when its first dq kernel held rows of D floats
# in shared memory.  No kernel of the route now needs shared memory that
# grows with D (W1 and W3 keep their own rows whole only where wide_plan
# finds that they fit, and stream them in steps otherwise), so nothing
# but this limit bounds D; chip_smoke.py launches W1-W3 at it.
WIDE_MAX_D = 14_512


def flash_family(dtype, D: int, strides, data_ptr: int) -> str:
    """Which family of flash kernels takes a (B, T, H*D) operand of this
    dtype, head size, element strides and start address.

    ``"hopper"`` (P1, P2, P3, P6: wgmma and TMA): bfloat16 at a head size
    that is a multiple of 16 in [16, 128], with :func:`kernel_strides_ok`
    strides.  ``"general"`` (G1-G3, ``csrc/flash_general.cu``: TF32
    ``mma.sync``, three products a term for f32): float32 and float16 at
    any head size up to 256, and bfloat16 at the other head sizes up to
    256, with a unit column stride.  ``"wide"`` (W1-W3,
    ``csrc/flash_wide.cu``: TF32 ``mma.sync`` with D in steps and the
    output's columns in chunks, :func:`wide_plan`): every dtype at a head
    size from 257 to :data:`WIDE_MAX_D`, with a unit column stride.
    A rule on the input, fixed in advance: anything else raises
    ``ValueError`` naming the limit, and nothing falls back from one
    family to another."""
    if dtype not in _GEN_DTYPES:
        raise ValueError(f"the flash kernels take float32, float16 or "
                         f"bfloat16, got {dtype}")
    if not 1 <= D <= WIDE_MAX_D:
        raise ValueError(f"the flash kernels take a head size from 1 to "
                         f"{WIDE_MAX_D}, got D={D}")
    if strides[-1] != 1:
        raise ValueError(f"the flash kernels need a unit column stride; "
                         f"got strides {tuple(strides)}")
    if D > GENERAL_MAX_D:
        return "wide"
    if dtype == torch.bfloat16 and D % 16 == 0 and 16 <= D <= 128:
        if not kernel_strides_ok(strides, data_ptr):
            raise ValueError(
                f"the Hopper flash kernels (bfloat16, D={D}) need batch "
                f"and row strides that are multiples of 8 and a 16-byte "
                f"aligned start; got strides {tuple(strides)}")
        return "hopper"
    return "general"


def _view(x: torch.Tensor, name: str, shape, device, dtype,
          D: int) -> tuple:
    """(pointer, batch stride, row stride) of a (B, T, C) view of
    ``dtype`` that the flash kernels can read (:func:`flash_family`)."""
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    flash_family(dtype, D, x.stride(), x.data_ptr())
    sb, st, _ = x.stride()
    return x.data_ptr(), sb, st


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
    if not 1 <= D <= WIDE_MAX_D:
        raise ValueError(f"the flash kernels take a head size from 1 to "
                         f"{WIDE_MAX_D}, got D={D}")
    lim = T if seq_len is None else int(seq_len)
    if not 0 < lim <= T:
        raise ValueError(f"seq_len {seq_len} out of range for T={T}")
    return B, T, C, H, D, lim


# The launch plan of the Hopper kernels P1 (csrc/flash_fwd.cu), P2
# (csrc/flash_bwd_dkdv.cu), P3 (csrc/flash_bwd_dq.cu) and P6
# (csrc/flash_bwd_fused.cu); their C entry points check it.
_BLOCK_COLS = 64         # bf16 columns of one 128-byte swizzled TMA box
_STAGES = 2              # buffers in the ring of streamed tiles


class FlashPlan(NamedTuple):
    d_pad: int           # head size padded in shared memory: 64 or 128
    rows: int            # rows of the block's own tile (q: P1, P3; k/v:
    #                      P2, P6)
    stream_rows: int     # rows of each streamed tile (k/v: P1, P3; q/dO:
    #                      P2, P6)
    grid: Tuple[int, int, int]   # (tiles, H, B): x tile, y head, z batch
    stages: int
    smem_bytes: int
    boxes: Dict[str, Tuple[int, int, int, int]]  # TMA box per operand,
    #                      (columns, heads, rows, batches), innermost first


def flash_plan(kernel: str, B: int, H: int, T: int, D: int) -> FlashPlan:
    """Launch geometry of a Hopper flash kernel for a (B, T, H*D) problem.
    P1 (``"flash_fwd"``): one block per 128-row q tile (x = 0 is the last
    tile, the heaviest under causality), k and v streamed in 128-row
    tiles.  P3 (``"flash_bwd_dq"``): the same q tiles with q and dO
    resident, k and v streamed in 64-row tiles.  P2 (``"flash_bwd_dkdv"``)
    and P6 (``"flash_bwd_fused"``): one block per 128-key kv tile (x = 0
    first, the heaviest), q and dO streamed in 64-row tiles with their lse
    and delta; P6 also holds two 128 x 64 bf16 tiles of staged ds^T and
    four 64 x 64 f32 tiles of staged dq (two per consumer).  The
    tiles of one head are neighbours in the grid, so that the tiles they
    all stream stay in L2.  Shared memory holds 1024 bytes of alignment
    slack, the tiles at ``d_pad`` columns and 8-byte mbarriers."""
    d_pad = 64 if D <= 64 else 128
    stages = _STAGES

    def tile(rows):
        return rows * d_pad * 2

    def box(rows):
        return (_BLOCK_COLS, 1, rows, 1)

    if kernel == "flash_fwd":
        rows, stream = 128, 128
        smem = 1024 + tile(rows) + 2 * stages * tile(stream) \
            + 8 * (1 + 3 * stages)
        boxes = {"q": box(rows), "k": box(stream), "v": box(stream)}
    elif kernel == "flash_bwd_dq":
        rows, stream = 128, 64
        smem = 1024 + 2 * tile(rows) + 2 * stages * tile(stream) \
            + 8 * (1 + 2 * stages)
        boxes = {"q": box(rows), "do": box(rows), "k": box(stream),
                 "v": box(stream)}
    elif kernel in ("flash_bwd_dkdv", "flash_bwd_fused"):
        rows, stream = 128, 64
        smem = 1024 + 2 * tile(rows) \
            + stages * (2 * tile(stream) + 2 * stream * 4) \
            + 8 * (1 + 2 * stages)
        if kernel == "flash_bwd_fused":   # ds^T tiles, dq tiles
            smem += 2 * rows * _BLOCK_COLS * 2 + 4 * stream * 64 * 4
        boxes = {"k": box(rows), "v": box(rows), "q": box(stream),
                 "do": box(stream)}
    else:
        raise ValueError(f"no launch plan for kernel {kernel!r}")
    return FlashPlan(d_pad, rows, stream, (-(-T // rows), H, B), stages,
                     smem, boxes)


# The launch plan of the general family G1-G3 (csrc/flash_general.cu).
_GEN_THREADS = 128
_GEN_KERNELS = ("flash_fwd_general", "flash_bwd_dkdv_general",
                "flash_bwd_dq_general")
_TC_ROWS = 64            # rows a block owns, 16 per warp
_TC_KEYS = 32            # G1, G3: k and v rows of a streamed tile
_TC_QUERIES = 32         # G2: q and dO rows of a streamed tile
_TC_SLACK = 1024         # bytes past the tiles, which the last group of
#                          p.v (dk, dv; ds.k) tiles may read


class GeneralPlan(NamedTuple):
    rows: int            # rows a block owns (q: G1, G3; keys: G2)
    tile: int            # rows of the other side per step (k/v: G1, G3;
    #                      q/dO: G2)
    d8: int              # D rounded up to 8, the columns staged (zero
    #                      past D)
    ld: int              # row stride of a staged tile, in elements of the
    #                      input: 16 bytes x odd, see general_row_stride
    halves: int          # G2: column halves of dk/dv, one block each
    half_cols: int       # G2: columns of the first half (d8 for one half)
    copy_bytes: int      # width of each staging copy (16, 4 or the
    #                      element size)
    grid: Tuple[int, int, int]   # (row blocks x halves, H, B)
    threads: int
    smem_bytes: int


def general_row_stride(D: int, itemsize: int) -> int:
    """Row stride, in elements, of a G1-G3 shared tile: at least D rounded
    up to 8, and 16 bytes times an odd number, so that the 32 lanes of
    each fragment load reach distinct banks and rows stay 16-byte aligned
    for ``cp.async``."""
    d8 = -(-D // 8) * 8
    return d8 if d8 * itemsize % 32 == 16 else d8 + 16 // itemsize


def general_copy_bytes(itemsize: int, D: int, views) -> int:
    """Width of G1-G3's staging copies for operands ``views`` (element
    strides (sb, st, 1) and start address of each): 16 bytes where every
    row start of every head is 16-byte aligned, else 4 where it is 4-byte
    aligned, else one element.  A rule on the input, fixed in advance."""
    for width in (16, 4):
        if all(ptr % width == 0 and sb * itemsize % width == 0
               and st * itemsize % width == 0 and D * itemsize % width == 0
               for (sb, st, *_), ptr in views):
            return width
    return itemsize


def general_plan(kernel: str, B: int, H: int, T: int, D: int,
                 dtype=torch.float32, views=None) -> GeneralPlan:
    """Launch geometry of G1 (``"flash_fwd_general"``), G2
    (``"flash_bwd_dkdv_general"``) or G3 (``"flash_bwd_dq_general"``) for
    a (B, T, H*D) problem of ``dtype`` whose operands have ``views``
    ((strides, data_ptr) each; None: contiguous tensors at aligned
    addresses).

    G1: one block of 4 warps per 64 query rows of one head, k and v
    streamed 32 rows at a time, one buffer each (the next k loads during
    p.v, the next v during q.k^T and the softmax); shared memory holds the
    64 q rows, a k and a v tile.  G2: one block per 64 key rows (and per
    column half of dk/dv beyond D8 = 128), q and dO streamed 32 rows at a
    time, one buffer each (the next q loads during dv += p^T dO, the next
    dO during s^T = k.q^T), with the q tile's lse and delta; shared memory
    holds the 64 k and v rows, a q and a dO tile.  G3: G1's grid, with k
    and v streamed as in G1 (the next v loads during q.k^T, ds and ds.k,
    the next k during dO.v^T); shared memory holds the 64 q and dO rows, a
    k and a v tile.  Each adds 1 KiB of slack past the tiles."""
    if kernel not in _GEN_KERNELS:
        raise ValueError(f"no general launch plan for kernel {kernel!r}")
    es = dtype.itemsize
    if views is None:
        views = [((T * H * D, H * D, 1), 0)]
    d8 = -(-D // 8) * 8
    ld = general_row_stride(D, es)
    copy = general_copy_bytes(es, D, views)
    blocks = -(-T // _TC_ROWS)
    if kernel == "flash_bwd_dkdv_general":
        tile = _TC_QUERIES
        halves = 2 if d8 > 128 else 1
        half_cols = -(-(d8 // 2) // 8) * 8 if halves == 2 else d8
        smem = (2 * _TC_ROWS + 2 * tile) * ld * es + 2 * tile * 4 \
            + _TC_SLACK
    else:   # G1 stages its q rows, G3 its q and dO rows
        tile, halves, half_cols = _TC_KEYS, 1, d8
        own = _TC_ROWS if kernel == "flash_fwd_general" else 2 * _TC_ROWS
        smem = (own + 2 * tile) * ld * es + _TC_SLACK
    return GeneralPlan(_TC_ROWS, tile, d8, ld, halves, half_cols, copy,
                       (blocks * halves, H, B), _GEN_THREADS, smem)


_WIDE_KERNELS = ("flash_fwd_wide", "flash_bwd_dkdv_wide",
                 "flash_bwd_dq_wide")
_WIDE_THREADS = 256      # W1-W3: two groups of 4 warps
_WIDE_PART = 16 * 32 * 4  # bytes of one warp's partial s (dp) tile
_W3_KEYS = 64            # W3: k and v rows of a streamed tile
# W1-W3 (csrc/flash_wide.cu): the columns a warp group takes of each step
# of the products over D (a step stages twice as many); the most columns
# of o (W1), of dk and dv (W2) or of dq (W3) a warp holds (the
# instantiations take up to 256, 128 and 192); the most shared memory W1
# (W3) takes to keep its 64 q rows (and 64 dO rows) whole instead of
# streaming them.
WIDE_DCOLS = {"flash_fwd_wide": 64, "flash_bwd_dkdv_wide": 32,
              "flash_bwd_dq_wide": 24}
WIDE_OCOLS = {"flash_fwd_wide": 256, "flash_bwd_dkdv_wide": 128,
              "flash_bwd_dq_wide": 192}
WIDE_Q_RESIDENT_SMEM = SMEM_LIMIT
# A grid that would not fill the card (the H100's 132 SMs, one block of
# W1-W3 each) takes more column chunks, of at least 64 columns.
WIDE_SMS = 132
WIDE_MIN_OCOLS = 64
# Products per visible pair, in units of D: those over D a block forms
# for its two chunks (W1: s; W2: s^T and dp^T; W3: dp and s), the row
# products over all chunks (p.v; dk and dv; dq), and the least.
_WIDE_PRODUCTS = {"flash_fwd_wide": (2, 2, 4),
                  "flash_bwd_dkdv_wide": (4, 4, 8),
                  "flash_bwd_dq_wide": (4, 2, 6)}


class WidePlan(NamedTuple):
    rows: int            # rows a block owns (query rows: W1, W3; keys:
    #                      W2)
    tile: int            # rows of each streamed tile of the other side
    d8: int              # D rounded up to 8
    dcols: int           # half the columns of a step over D (W1, W2: a
    #                      warp group's half)
    n_steps: int         # steps over D8, 2 dcols columns each
    ocols: int           # columns of o (dk and dv; dq) a warp group
    #                      computes
    n_ochunks: int       # column chunks over D8, two a block
    q_resident: bool     # W1 stages its q rows whole, once; W3 its q and
    #                      dO rows
    copy_bytes: int      # width of each staging copy (16, 4 or the
    #                      element size)
    grid: Tuple[int, int, int]   # (row blocks x blocks of two column
    #                              chunks, H, B)
    threads: int
    smem_bytes: int
    products: float      # products done over the least (4 D a visible
    #                      pair for W1, 8 D for W2, 6 D for W3)

    @property
    def args(self) -> Tuple[int, int, int, int, int]:
        """The plan's arguments of the W1-W3 entry points."""
        return (self.copy_bytes, self.ocols, self.dcols,
                int(self.q_resident), self.smem_bytes)


def wide_tc_smem_bytes(kernel: str, D: int, itemsize: int, ocols: int,
                       dcols: int, q_resident: bool) -> int:
    """Dynamic shared memory of W1 (``"flash_fwd_wide"``), W2
    (``"flash_bwd_dkdv_wide"``) or W3 (``"flash_bwd_dq_wide"``), rows as
    G1-G3's (:func:`general_row_stride`); a step's tiles are ``2 dcols``
    columns wide, the tiles of a block's column chunks ``2 ocols``.  W1:
    its 64 q rows whole, or two buffers of a step's; two buffers of a
    step's 32 k rows; the 8 warps' partial s tiles; the v tile's 32 rows.
    W2: two buffers of a step's 64 k and 64 v rows and 32 q and 32 dO
    rows; the q tile's lse and delta; the 8 warps' partial s and dp tiles;
    the q and dO tiles' 32 rows.  W3: its 64 q and 64 dO rows whole, or
    two buffers of a step's; two buffers of a step's 64 k and 64 v rows;
    the 8 warps' ds tiles; the k tile's 64 rows.  Each then 1 KiB of
    slack."""
    step = general_row_stride(2 * dcols, itemsize) * itemsize
    cols = general_row_stride(2 * ocols, itemsize) * itemsize
    whole = _TC_ROWS * general_row_stride(D, itemsize) * itemsize
    if kernel == "flash_fwd_wide":
        q = whole if q_resident else 2 * _TC_ROWS * step
        return (q + 2 * _TC_KEYS * step + 8 * _WIDE_PART + _TC_KEYS * cols
                + _TC_SLACK)
    if kernel == "flash_bwd_dq_wide":
        q = 2 * whole if q_resident else 4 * _TC_ROWS * step
        return (q + 4 * _W3_KEYS * step + 8 * _WIDE_PART + _W3_KEYS * cols
                + _TC_SLACK)
    return (2 * (2 * _TC_ROWS + 2 * _TC_QUERIES) * step
            + 2 * _TC_QUERIES * 4 + 16 * _WIDE_PART
            + 2 * _TC_QUERIES * cols + _TC_SLACK)


def wide_plan(kernel: str, B: int, H: int, T: int, D: int,
              dtype=torch.float32, views=None) -> WidePlan:
    """Launch geometry of W1 (``"flash_fwd_wide"``), W2
    (``"flash_bwd_dkdv_wide"``) or W3 (``"flash_bwd_dq_wide"``) for a
    (B, T, H*D) problem of ``dtype`` whose operands have ``views``
    ((strides, data_ptr) each; None: contiguous tensors at aligned
    addresses).

    A block of two groups of 4 warps owns 64 rows of one head (W1 and W3:
    query rows, k and v streamed 32 rows a tile, W3 64; W2: key rows, q
    and dO streamed 32 rows a tile); warps w and w + 4 own the same 16
    rows (in W3 they take 32 keys of each tile each).  D8 is cut into the
    fewest column chunks of o (dk and dv; dq) of at most
    ``WIDE_OCOLS[kernel]`` columns, all of one width (a multiple of 8) but
    the last; a block takes two, one a group.  Where those blocks would
    not fill ``WIDE_SMS`` SMs, D8 is cut into as many more chunks (of at
    least ``WIDE_MIN_OCOLS`` columns) as fill them: each block recomputes
    s (s and dp) for fewer columns, all in one wave.  The products over D
    run in steps of ``2 WIDE_DCOLS[kernel]`` columns, double-buffered; in
    W1 and W2 each group takes one half of a step and the two halves' sums
    meet in shared memory.  W1 keeps its q rows (W3 its q and dO rows)
    whole where that takes at most ``WIDE_Q_RESIDENT_SMEM`` bytes of
    shared memory.  Copy width: :func:`general_copy_bytes`.  A rule on the
    input, fixed in advance."""
    if kernel not in _WIDE_KERNELS:
        raise ValueError(f"no wide launch plan for kernel {kernel!r}")
    es = dtype.itemsize
    if views is None:
        views = [((T * H * D, H * D, 1), 0)]
    d8 = -(-D // 8) * 8
    row_blocks = -(-T // _TC_ROWS)
    fill = 2 * (WIDE_SMS // (row_blocks * H * B))
    chunks = max(-(-d8 // WIDE_OCOLS[kernel]),
                 min(fill, d8 // WIDE_MIN_OCOLS))
    ocols = -(-d8 // chunks // 8) * 8
    n_ochunks = -(-d8 // ocols)
    dcols = WIDE_DCOLS[kernel]
    q_resident = kernel != "flash_bwd_dkdv_wide" and wide_tc_smem_bytes(
        kernel, D, es, ocols, dcols, True) <= WIDE_Q_RESIDENT_SMEM
    smem = wide_tc_smem_bytes(kernel, D, es, ocols, dcols, q_resident)
    blocks = -(-n_ochunks // 2)
    over_d, row_products, least = _WIDE_PRODUCTS[kernel]
    products = (over_d * blocks + row_products) * d8 / (least * D)
    tile = {"flash_fwd_wide": _TC_KEYS, "flash_bwd_dkdv_wide": _TC_QUERIES,
            "flash_bwd_dq_wide": _W3_KEYS}[kernel]
    return WidePlan(_TC_ROWS, tile, d8, dcols, -(-d8 // (2 * dcols)),
                    ocols, n_ochunks, q_resident,
                    general_copy_bytes(es, D, views),
                    (row_blocks * blocks, H, B), _WIDE_THREADS,
                    smem, products)


def tma_strides(D: int, st: int, sb: int) -> Tuple[int, int, int]:
    """Byte strides of the (D, H, T, B) tensor map over a (B, T, H*D) bf16
    view with row stride ``st`` and batch stride ``sb`` (elements): head,
    row, batch.  TMA needs each a multiple of 16."""
    return 2 * D, 2 * st, 2 * sb


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def _launch(name: str, stem: str, dev, *args) -> None:
    """Launch kernel ``name`` (entry point ``htt_<name>`` of
    ``csrc/<stem>.cu``) on the current stream of ``dev``, which the entry
    point takes last; raise on a CUDA error, count the launch."""
    fn = getattr(_lib(stem), f"htt_{name}")
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _check(err, name)
    LAUNCHES[name] += 1


def _new(like: torch.Tensor, out, shape):
    return torch.empty(shape, dtype=like.dtype, device=like.device) \
        if out is None else out


def _inputs(named, num_heads, seq_len):
    """Geometry, family and the (pointer, strides) arguments of the
    (B, T, H*D) operands ``named`` (name, tensor; q first)."""
    q = named[0][1]
    B, T, C, H, D, lim = _geometry(q, num_heads, seq_len)
    family = flash_family(q.dtype, D, q.stride(), q.data_ptr())
    args = [a for n, x in named
            for a in _view(x, n, (B, T, C), q.device, q.dtype, D)]
    return (B, T, C, H, D, lim, q.device, family), args


def flash_fwd(q, k, v, num_heads: int, *, scale: float, causal: bool,
              seq_len: Optional[int] = None):
    """Port kernel P1, or G1 for the general family
    (:func:`flash_family`).  q, k, v: (B, T, H*D) views (they may be
    column regions of one tensor).  Returns o (B, T, H*D) in q's dtype and
    lse (B, H, T) f32."""
    (B, T, C, H, D, lim, dev, family), args = _inputs(
        (("q", q), ("k", k), ("v", v)), num_heads, seq_len)
    o = torch.empty((B, T, C), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    out = [*_view(o, "o", (B, T, C), dev, q.dtype, D), lse.data_ptr()]
    tail = (B, H, T, D, lim, int(bool(causal)), float(scale))
    if family == "hopper":
        plan = flash_plan("flash_fwd", B, H, T, D)
        _launch("flash_fwd", "flash_fwd", dev, *args, *out, *tail,
                plan.stages, plan.smem_bytes)
    elif family == "wide":
        plan = wide_plan("flash_fwd_wide", B, H, T, D, q.dtype,
                         _strides_and_ptrs(q, k, v))
        _launch("flash_fwd_wide", "flash_wide", dev, _GEN_DTYPES[q.dtype],
                *args, *out, *tail, *plan.args)
    else:
        plan = general_plan("flash_fwd_general", B, H, T, D, q.dtype,
                            _strides_and_ptrs(q, k, v))
        _launch("flash_fwd_general", "flash_general", dev,
                _GEN_DTYPES[q.dtype], *args, *out, *tail, plan.copy_bytes,
                plan.smem_bytes)
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta, num_heads, seq_len):
    geo, args = _inputs((("q", q), ("k", k), ("v", v), ("do", do)),
                        num_heads, seq_len)
    B, T, _, H, _, _, dev, _ = geo
    args += [_rows(lse, "lse", (B, H, T), dev),
             _rows(delta, "delta", (B, H, T), dev)]
    return geo, args


def _strides_and_ptrs(*xs):
    return [(x.stride(), x.data_ptr()) for x in xs]


def _general_bwd(name, geo, args, outs, causal, scale, ins) -> None:
    """Launch G2 (``"flash_bwd_dkdv_general"``) or G3
    (``"flash_bwd_dq_general"``), or W2/W3 for the wide route; ``ins``: q,
    k, v, dO."""
    B, T, C, H, D, lim, dev, family = geo
    if family == "wide":
        name = name.replace("_general", "_wide")
        plan = wide_plan(name, B, H, T, D, ins[0].dtype,
                         _strides_and_ptrs(*ins)).args
        _launch(name, "flash_wide", dev, _GEN_DTYPES[ins[0].dtype], *args,
                *outs, B, H, T, D, lim, int(bool(causal)), float(scale),
                *plan)
        return
    plan = general_plan(name, B, H, T, D, ins[0].dtype,
                        _strides_and_ptrs(*ins))
    _launch(name, "flash_general", dev, _GEN_DTYPES[ins[0].dtype], *args,
            *outs, B, H, T, D, lim, int(bool(causal)), float(scale),
            plan.copy_bytes, plan.smem_bytes)


def flash_bwd_dkdv(q, k, v, do, lse, delta, num_heads: int, *,
                   scale: float, causal: bool,
                   seq_len: Optional[int] = None, dk=None, dv=None):
    """Port kernel P2, or G2 for the general family.  Inputs as
    :func:`flash_fwd` plus dO (B, T, H*D) and lse, delta (B, H, T) f32.
    Writes dk and dv into the given (B, T, H*D) views, or into new
    tensors; returns (dk, dv)."""
    geo, args = _bwd_inputs(q, k, v, do, lse, delta, num_heads, seq_len)
    B, T, C, H, D, lim, dev, family = geo
    dk, dv = _new(q, dk, (B, T, C)), _new(q, dv, (B, T, C))
    outs = [*_view(dk, "dk", (B, T, C), dev, q.dtype, D),
            *_view(dv, "dv", (B, T, C), dev, q.dtype, D)]
    if family != "hopper":
        _general_bwd("flash_bwd_dkdv_general", geo, args, outs, causal,
                     scale, (q, k, v, do))
        return dk, dv
    plan = flash_plan("flash_bwd_dkdv", B, H, T, D)
    _launch("flash_bwd_dkdv", "flash_bwd_dkdv", dev, *args, *outs, B, H, T,
            D, lim, int(bool(causal)), float(scale), plan.stages,
            plan.smem_bytes)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, num_heads: int, *, scale: float,
                 causal: bool, seq_len: Optional[int] = None, dq=None):
    """Port kernel P3, or G3 for the general family.  Inputs as
    :func:`flash_bwd_dkdv`; writes dq into the given (B, T, H*D) view, or
    into a new tensor, and returns it."""
    geo, args = _bwd_inputs(q, k, v, do, lse, delta, num_heads, seq_len)
    B, T, C, H, D, lim, dev, family = geo
    dq = _new(q, dq, (B, T, C))
    outs = list(_view(dq, "dq", (B, T, C), dev, q.dtype, D))
    if family != "hopper":
        _general_bwd("flash_bwd_dq_general", geo, args, outs, causal, scale,
                     (q, k, v, do))
        return dq
    plan = flash_plan("flash_bwd_dq", B, H, T, D)
    _launch("flash_bwd_dq", "flash_bwd_dq", dev, *args, *outs, B, H, T, D,
            lim, int(bool(causal)), float(scale), plan.stages,
            plan.smem_bytes)
    return dq


def flash_bwd_fused(q, k, v, do, lse, delta, num_heads: int, *,
                    scale: float, causal: bool,
                    seq_len: Optional[int] = None, dq=None, dk=None,
                    dv=None):
    """Port kernel P6, the one-pass backward; inputs as
    :func:`flash_bwd_dkdv`.  Writes dq, dk and dv into the given
    (B, T, H*D) views, or into new tensors, and returns (dq, dk, dv).  dq
    is summed in an f32 workspace of (B, T, H*D) with atomics, so its last
    bits vary from run to run.  For the general family, G2 and G3 compute
    the same function, deterministically."""
    geo, args = _bwd_inputs(q, k, v, do, lse, delta, num_heads, seq_len)
    B, T, C, H, D, lim, dev, family = geo
    dq, dk, dv = (_new(q, x, (B, T, C)) for x in (dq, dk, dv))
    outs = {n: list(_view(x, n, (B, T, C), dev, q.dtype, D))
            for n, x in (("dq", dq), ("dk", dk), ("dv", dv))}
    if family != "hopper":
        _general_bwd("flash_bwd_dkdv_general", geo, args,
                     outs["dk"] + outs["dv"], causal, scale, (q, k, v, do))
        _general_bwd("flash_bwd_dq_general", geo, args, outs["dq"], causal,
                     scale, (q, k, v, do))
        return dq, dk, dv
    plan = flash_plan("flash_bwd_fused", B, H, T, D)
    work = torch.empty((B, T, C), dtype=torch.float32, device=dev)
    _launch("flash_bwd_fused", "flash_bwd_fused", dev, *args, *outs["dq"],
            *outs["dk"], *outs["dv"], work.data_ptr(), B, H, T, D, lim,
            int(bool(causal)), float(scale), plan.stages, plan.smem_bytes)
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
