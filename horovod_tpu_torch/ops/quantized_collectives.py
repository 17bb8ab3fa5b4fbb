"""Quantized collectives: the int8 block codec and the int8 ring allreduce.

Port of ``horovod_tpu/ops/quantized_collectives.py``: the constants
(:52-73), the policy (:79-144), the codec (:150-262), the ring
(:276-327), the bytes-on-wire estimate and its counters (:333-401) and the
host wire image (:406-447).

The codec is bit-exact with the JAX package's and with
``cpp/htpu/quantize.cc``: one f32 scale per :data:`BLOCK_ELEMS`-element
block, ``scale = max(absmax * f32(1/127), FLT_MIN)`` (1.0 for an all-zero
block), ``q = round_half_even(clip(x * (1/scale), -127, 127))``.  Two
hand-written kernels carry it on the card (``csrc/int8_codec.cu``): P4
``int8_quantize`` and P5 ``int8_dequantize``.  Beside them are their plain
PyTorch versions, :func:`_quantize_plain` and :func:`_dequantize_plain`,
with the same cast points.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

The ring (:func:`quantized_ring_allreduce`) is written once, per rank, as
:func:`_ring_allreduce` over two exchange callables: ``torch.distributed``
point-to-point sends and an allgather for a real group, and a lockstep
exchange that drives n ranks in one process (:func:`lockstep_ring_allreduce`)
for the tests and ``chip_smoke.py``.  Each hop dequantizes the received
chunk, then adds it to the f32 accumulator in a separate step, as the JAX
ring does.

Policy: only bulk gradients quantize.  1-D leaves and leaves under the size
floor (``HOROVOD_TPU_INJIT_INT8_FLOOR`` f32 bytes, default 64 KiB) stay raw.
``HOROVOD_TPU_INJIT_WIRE_DTYPE`` fills in the wire where the caller left
the default.  ``compression="auto"`` (the precision autopilot,
:mod:`horovod_tpu_torch.precision`) is no static compressor: it passes
through unchanged, and each caller resolves it per leaf.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops import injit as _injit

# Block geometry of cpp/htpu/quantize.h: one f32 absmax scale per 1024
# elements; host wire images framed in 64K-element sub-chunks.
BLOCK_ELEMS = 1024
SUB_CHUNK_ELEMS = 64 * 1024

# FLT_MIN: a block whose absmax is subnormal still gets a finite 1/scale.
MIN_SCALE = 1.17549435e-38

# f32(1/127), multiplied (not divided) as the C++ BlockScale does.
INV_127 = float(np.float32(1.0) / np.float32(127.0))

_ENV_WIRE = "HOROVOD_TPU_INJIT_WIRE_DTYPE"
_ENV_FLOOR = "HOROVOD_TPU_INJIT_INT8_FLOOR"

DEFAULT_INT8_FLOOR_BYTES = 64 << 10


# --------------------------------------------------------------- policy


def is_auto(compression) -> bool:
    """True for the ``compression="auto"`` marker of the precision
    autopilot."""
    return (isinstance(compression, str)
            and compression.strip().lower() == "auto")


def resolve_injit_compression(compression):
    """Apply the ``HOROVOD_TPU_INJIT_WIRE_DTYPE`` override: the knob fills
    in the wire only where the call site left the default
    ``NoneCompressor``; an explicit ``compression=`` (a class or a wire
    name, ``"none"`` included) wins.  The ``"auto"`` marker of the
    precision autopilot passes through unchanged: callers resolve it per
    bucket through :mod:`horovod_tpu_torch.precision`."""
    from horovod_tpu_torch.compression import (
        NoneCompressor, canonical_wire_dtype, compressor_for_wire)
    if is_auto(compression):
        return compression
    if isinstance(compression, str):
        return compressor_for_wire(canonical_wire_dtype(
            compression.strip().lower(), source="compression"))
    if not (compression is NoneCompressor
            or isinstance(compression, NoneCompressor)):
        return compression
    name = os.environ.get(_ENV_WIRE, "").strip().lower()
    wire = canonical_wire_dtype(name, source=_ENV_WIRE)
    if wire == "":
        return compression
    return compressor_for_wire(wire)


def is_int8(compression) -> bool:
    from horovod_tpu_torch.compression import Int8Compressor
    return (isinstance(compression, Int8Compressor)
            or (isinstance(compression, type)
                and issubclass(compression, Int8Compressor)))


def int8_floor_bytes() -> int:
    return int(os.environ.get(_ENV_FLOOR, str(DEFAULT_INT8_FLOOR_BYTES)))


def int8_eligible(shape, dtype, *, floor_bytes: int | None = None) -> bool:
    """Whether a gradient leaf goes over the int8 wire: floating, at least
    2-D, and at least ``floor_bytes`` as f32."""
    if floor_bytes is None:
        floor_bytes = int8_floor_bytes()
    if not dtype.is_floating_point:
        return False
    if len(shape) < 2:
        return False
    return math.prod(shape) * 4 >= floor_bytes


# ---------------------------------------------------------------- codec


def _quantize_plain(grid: torch.Tensor):
    """Plain version of P4: (blocks, 1024) f32 -> (q int8 (blocks, 1024),
    scales f32 (blocks, 1))."""
    absmax = grid.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(absmax * INV_127, MIN_SCALE)
    scale = torch.where(absmax > 0, scale, torch.ones_like(scale))
    inv = torch.reciprocal(scale)
    q = torch.round(torch.clamp(grid * inv, -127.0, 127.0))
    return q.to(torch.int8), scale


def _dequantize_plain(q: torch.Tensor, scales: torch.Tensor):
    """Plain version of P5: ``float(q) * scale``, (blocks, 1024) f32."""
    return q.to(torch.float32) * scales


def quantize_blocks(flat: torch.Tensor):
    """Quantize a flat f32 vector (size a multiple of BLOCK_ELEMS) to
    ``(q int8 [blocks, 1024], scales f32 [blocks, 1])``."""
    size = flat.shape[0]
    if flat.dim() != 1 or size % BLOCK_ELEMS:
        raise ValueError(f"quantize_blocks takes a flat tensor whose size "
                         f"is a multiple of {BLOCK_ELEMS}, got shape "
                         f"{tuple(flat.shape)}")
    grid = flat.to(torch.float32).reshape(size // BLOCK_ELEMS, BLOCK_ELEMS)
    if grid.device.type == "cuda":
        return _cuda.int8_quantize(grid)
    if grid.device.type == "cpu":
        return _quantize_plain(grid)
    raise ValueError(f"quantize_blocks: no kernel for device {grid.device}")


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor):
    """Inverse of :func:`quantize_blocks`: flat f32 of size
    ``blocks * BLOCK_ELEMS``."""
    if q.device.type == "cuda":
        return _cuda.int8_dequantize(q, scales).reshape(-1)
    if q.device.type == "cpu":
        return _dequantize_plain(q, scales).reshape(-1)
    raise ValueError(f"dequantize_blocks: no kernel for device {q.device}")


def snap_to_grid(x: torch.Tensor) -> torch.Tensor:
    """Quantize and dequantize ``x`` onto its int8 block grid (f32 out,
    same shape): the operator ``Q`` of ``Int8Compressor`` and of the
    error-feedback residual ``g - Q(g)``."""
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    padded = -(-n // BLOCK_ELEMS) * BLOCK_ELEMS
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    q, scales = quantize_blocks(flat)
    return dequantize_blocks(q, scales)[:n].reshape(x.shape)


# ------------------------------------------------------- ring allreduce

# A rank's payload on the wire: (q int8 (blocks, 1024), scales f32
# (blocks, 1)).
Payload = Tuple[torch.Tensor, torch.Tensor]


def _ring_chunk(size: int, n: int) -> int:
    """Elements per rank chunk: ceil(size / n) rounded up to whole
    blocks."""
    return -(-(-(-size // n)) // BLOCK_ELEMS) * BLOCK_ELEMS


def _ring_allreduce(xs: Dict[int, torch.Tensor], n: int,
                    shift: Callable[[Dict[int, Payload]], Dict[int, Payload]],
                    gather: Callable[[Dict[int, Payload]], Payload],
                    average: bool) -> Dict[int, torch.Tensor]:
    """The ring's arithmetic for the ranks this caller drives (``xs``:
    rank -> its tensor, all of one shape and dtype).

    ``shift(sent)`` takes each driven rank's payload for rank + 1 and
    returns, per driven rank, the payload that rank - 1 sent it.
    ``gather(own)`` takes each driven rank's owned, quantized chunk and
    returns all n ranks' concatenated in rank order.  Reduce-scatter: at hop ``s`` rank
    ``r`` quantizes its partial sum of chunk ``(r - s) mod n`` and sends it
    on; the receiver dequantizes, then adds it into chunk
    ``(r - s - 1) mod n`` in f32.  After n - 1 hops rank ``r`` owns the
    sum of chunk ``(r + 1) mod n``; the owned chunks are quantized,
    gathered, dequantized and rolled back into order."""
    x0 = next(iter(xs.values()))
    orig_dtype, orig_shape = x0.dtype, x0.shape
    size = x0.numel()
    chunk = _ring_chunk(size, n)
    accs = {}
    for r, x in xs.items():
        acc = torch.zeros(n * chunk, dtype=torch.float32, device=x.device)
        acc[:size] = x.reshape(-1)
        accs[r] = acc.view(n, chunk)
    for s in range(n - 1):
        sent = {r: quantize_blocks(acc[(r - s) % n])
                for r, acc in accs.items()}
        for r, (q, scales) in shift(sent).items():
            deq = dequantize_blocks(q, scales)
            accs[r][(r - s - 1) % n].add_(deq)
    own = {r: quantize_blocks(acc[(r + 1) % n]) for r, acc in accs.items()}
    gq, gs = gather(own)
    deq = dequantize_blocks(gq, gs)
    # Gathered row r holds chunk (r + 1) mod n; rotate back into order.
    full = torch.roll(deq.reshape(n, chunk), 1, dims=0).reshape(-1)[:size]
    if average:
        full = full / n
    full = full.reshape(orig_shape).to(orig_dtype)
    return {r: full for r in xs}


def lockstep_ring_allreduce(xs: Sequence[torch.Tensor], *,
                            average: bool = False) -> List[torch.Tensor]:
    """:func:`quantized_ring_allreduce` of n ranks driven in lockstep in
    this process: ``xs[r]`` is rank r's tensor; returns each rank's
    result.  Same per-rank arithmetic as the distributed ring."""
    n = len(xs)
    if n == 1:
        return [xs[0]]

    def shift(sent):
        return {r: sent[(r - 1) % n] for r in sent}

    def gather(own):
        return (torch.cat([own[r][0] for r in range(n)]),
                torch.cat([own[r][1] for r in range(n)]))

    out = _ring_allreduce(dict(enumerate(xs)), n, shift, gather, average)
    return [out[r] for r in range(n)]


def quantized_ring_allreduce(x: torch.Tensor, *, average: bool = False,
                             group=None) -> torch.Tensor:
    """Allreduce ``x`` over ``group`` (the world group by default) with
    int8 on every hop: the int8 payload and its scales travel by
    ``dist.batch_isend_irecv`` to rank + 1, and the owned chunks by
    :func:`..injit.allgather`.  Without a process group, or in a group of
    one, the ring is the identity and ``x`` comes back as it is."""
    if not dist.is_initialized():
        return x
    n = dist.get_world_size(group)
    if n == 1:
        return x
    rank = dist.get_rank(group)

    def peer(r):
        r %= n
        return r if group is None else dist.get_global_rank(group, r)

    def shift(sent):
        q, scales = sent[rank]
        rq, rs = torch.empty_like(q), torch.empty_like(scales)
        ops = [dist.P2POp(dist.isend, q, peer(rank + 1), group),
               dist.P2POp(dist.isend, scales, peer(rank + 1), group),
               dist.P2POp(dist.irecv, rq, peer(rank - 1), group),
               dist.P2POp(dist.irecv, rs, peer(rank - 1), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {rank: (rq, rs)}

    def gather(own):
        q, scales = own[rank]
        return (_injit.allgather(q, group=group),
                _injit.allgather(scales, group=group))

    return _ring_allreduce({rank: x}, n, shift, gather, average)[rank]


# ----------------------------------------------- bytes-on-wire estimate


def ring_wire_bytes(size: int, n: int) -> int:
    """Estimated per-rank bytes a :func:`quantized_ring_allreduce` of
    ``size`` elements sends over ``n`` ranks: 2(n-1) hops of one int8
    chunk plus its f32 block scales."""
    if n <= 1:
        return 0
    chunk = _ring_chunk(size, n)
    hop = chunk + (chunk // BLOCK_ELEMS) * 4
    return 2 * (n - 1) * hop


_DTYPE_KEYS = {torch.float32: "fp32", torch.bfloat16: "bf16",
               torch.float16: "fp16"}


def _dtype_key(dtype: torch.dtype) -> str:
    return _DTYPE_KEYS.get(dtype, str(dtype).replace("torch.", ""))


def estimate_wire_plan(leaves, n: int, compression,
                       hierarchical: bool = False) -> Dict[str, int]:
    """Per-step, per-rank bytes-on-wire estimate for a list of gradient
    tensors, keyed by wire dtype: the numbers behind the
    ``injit.bytes#wire_dtype=*`` counters, which
    :func:`horovod_tpu_torch.spmd.make_train_step` records through
    :func:`record_wire_plan` at every call of a step over more than one
    rank.  Raw legs are modelled as a bandwidth-optimal ring (``2(n-1)/n *
    payload``), the int8 leg with its exact chunk and scale framing.  On
    the two-tier path (``hierarchical``) no leaf rides the int8 ring:
    floating leaves that are int8-eligible without the floor go as a bf16
    snap, the others at their own dtype.  The ``"auto"`` marker counts
    every leaf at its own dtype, as the JAX package counts its frozen
    autopilot builds.  Estimates, not counts of what NCCL moved."""
    compression = resolve_injit_compression(compression)
    plan: Dict[str, int] = {}
    if n <= 1:
        return plan
    int8 = is_int8(compression)
    for leaf in leaves:
        shape = tuple(leaf.shape)
        dtype = leaf.dtype
        size = math.prod(shape) if shape else 1
        if int8 and not hierarchical and int8_eligible(shape, dtype):
            key, nbytes = "int8", ring_wire_bytes(size, n)
        else:
            if not dtype.is_floating_point:
                wire = dtype
            elif int8:
                wire = (torch.bfloat16 if hierarchical and int8_eligible(
                    shape, dtype, floor_bytes=0) else dtype)
            else:
                wire = getattr(compression, "wire_dtype", None) or dtype
            key = _dtype_key(wire)
            itemsize = torch.empty((), dtype=wire).element_size()
            nbytes = 2 * (n - 1) * size * itemsize // n
        if nbytes:
            plan[key] = plan.get(key, 0) + nbytes
    return plan


def record_wire_plan(plan: Dict[str, int], steps: int = 1) -> None:
    """Fold a wire plan into this process's metrics registry:
    ``injit.bytes#wire_dtype=<key>`` grows by bytes x ``steps`` and
    ``injit.steps`` by ``steps`` (one call per step call)."""
    if not plan:
        return
    from horovod_tpu_torch.metrics import registry
    for key, nbytes in plan.items():
        registry.inc(f"injit.bytes#wire_dtype={key}", nbytes * steps)
    registry.inc("injit.steps", steps)


# -------------------------------------------- host wire image (parity)


def host_wire_encode(values) -> bytes:
    """Encode a host f32 array into the C++ int8 wire image (per 64K-element
    sub-chunk: the f32 block scales, then the int8 payload) with this
    module's codec."""
    arr = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    out = bytearray()
    for lo in range(0, arr.size, SUB_CHUNK_ELEMS):
        seg = arr[lo:lo + SUB_CHUNK_ELEMS]
        blocks = -(-seg.size // BLOCK_ELEMS)
        pad = blocks * BLOCK_ELEMS - seg.size
        flat = np.pad(seg, (0, pad)) if pad else seg
        q, scales = quantize_blocks(torch.from_numpy(np.array(flat)))
        out += scales.numpy().reshape(-1).astype("<f4").tobytes()
        out += q.numpy().reshape(-1)[:seg.size].tobytes()
    return bytes(out)


def host_wire_decode(buf: bytes, n_elems: int):
    """Decode a C++ int8 wire image with this module's codec; inverse of
    :func:`host_wire_encode`."""
    out = np.empty(n_elems, dtype=np.float32)
    pos = 0
    for lo in range(0, n_elems, SUB_CHUNK_ELEMS):
        length = min(SUB_CHUNK_ELEMS, n_elems - lo)
        blocks = -(-length // BLOCK_ELEMS)
        scales = np.frombuffer(buf, dtype="<f4", count=blocks,
                               offset=pos).copy()
        pos += blocks * 4
        q = np.frombuffer(buf, dtype=np.int8, count=length,
                          offset=pos).copy()
        pos += length
        pad = blocks * BLOCK_ELEMS - length
        if pad:
            q = np.pad(q, (0, pad))
        deq = dequantize_blocks(
            torch.from_numpy(q).reshape(blocks, BLOCK_ELEMS),
            torch.from_numpy(scales).reshape(blocks, 1))
        out[lo:lo + length] = deq.numpy()[:length]
    return out
