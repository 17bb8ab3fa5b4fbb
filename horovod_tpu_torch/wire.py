"""Binary wire format for control-plane messages -- Python mirror of
``cpp/htpu/wire.{h,cc}``.

Port of ``horovod_tpu/wire.py``, verbatim: ``serialize_request_list``
(:337), ``serialize_response_list`` (:450), the cache, elastic and
precision extensions and the CRC32C trailer (:193), byte for byte the
reference's frames (held against ``horovod_tpu.wire`` in
``tests/test_torch_eager_wire.py``).  A little-endian length-prefixed
format shared with the C++ core; used for the Python/C++ interchange
through the ctypes API and for the multi-process control plane.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Optional, Tuple

from horovod_tpu_torch.core import Request, RequestType, Response, ResponseType

# Abort marker carried by both list formats: (failed_rank, root_cause) or
# None.  A worker reports a local failure via its RequestList; the
# coordinator broadcasts the job-wide ABORT via the ResponseList.
Abort = Optional[Tuple[int, str]]

# List-frame flags byte.  Historically this byte was the shutdown bool
# (0/1), so legacy frames — abort frames included — decode unchanged.
# Bit 1 announces a trailing response-cache extension; bit 2 announces
# that every message in the list carries a trailing allreduce-algorithm
# string (set only when some message's algo is non-empty, so ring-only
# traffic stays byte-identical to the pre-algo wire); any other bit is an
# unknown future version and the frame is rejected rather than misread.
FLAG_SHUTDOWN = 0x01
FLAG_CACHE_EXT = 0x02
FLAG_ALGO_EXT = 0x04
# Elastic-membership extension (HOROVOD_TPU_ELASTIC=1 only — non-elastic
# frames never set the bit, so abort traffic stays byte-identical).
FLAG_ELASTIC_EXT = 0x08
# Process-set extension: every message in the list carries a trailing
# process_set:i32 (set only when some message targets a non-default set,
# so default-set-only traffic stays byte-identical to the pre-set wire —
# golden-frame guarded in tests/test_process_sets.py).
FLAG_SET_EXT = 0x10
# Integrity extension (HOROVOD_TPU_INTEGRITY=1 only): the frame ends with
# a CRC32C trailer over every preceding byte, verified at parse.  Frames
# with integrity off never set the bit, so legacy control traffic stays
# byte-identical (golden-frame guarded like FLAG_SET_EXT).
FLAG_CRC_EXT = 0x20
# Precision-telemetry extension (HOROVOD_TPU_PRECISION=auto only): the
# RequestList carries per-bucket error-feedback residual-norm reports,
# vec<(name:str, residual:f64)>, serialized after the elastic extension and
# before the CRC trailer.  Autopilot-off frames never set the bit, so
# static-precision traffic stays byte-identical (golden-frame guarded like
# FLAG_CRC_EXT).
FLAG_PRECISION_EXT = 0x40
_KNOWN_FLAGS = (FLAG_SHUTDOWN | FLAG_CACHE_EXT | FLAG_ALGO_EXT
                | FLAG_ELASTIC_EXT | FLAG_SET_EXT | FLAG_CRC_EXT
                | FLAG_PRECISION_EXT)

# Response-cache extension cflags (ResponseList direction only).
CACHE_SERVED = 0x01   # replay the locally stored response set for the bits
CACHE_FLUSH = 0x02    # drop all client cache state; resend compressed names
CACHE_STORE_SET = 0x04  # store this full frame as the set for the sent bits


@dataclasses.dataclass
class RequestCacheExt:
    """Trailing RequestList extension: ``cache_epoch:i32 bits:str``.

    ``bits`` is the hit-slot bitvector (LSB of byte 0 = slot 0), trailing
    zero bytes trimmed — steady-state ticks send O(slots/8) bytes instead
    of serialized request lists."""
    epoch: int = 0
    bits: bytes = b""


@dataclasses.dataclass
class ResponseCacheExt:
    """Trailing ResponseList extension:
    ``cache_epoch:i32 cflags:i8 assignments:vec<slot:i32 name:str>
    evictions:vec<i32>``."""
    epoch: int = 0
    served_from_cache: bool = False
    flush: bool = False
    store_set: bool = False
    assignments: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)
    evictions: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RequestElasticExt:
    """Trailing RequestList elastic extension: ``generation:i32`` — the
    sender's membership generation, so the coordinator can reject frames
    from a worker that missed a RECONFIGURE."""
    generation: int = 0


@dataclasses.dataclass
class RequestPrecisionExt:
    """Trailing RequestList precision extension:
    ``vec<(name:str, residual:f64)>`` — this worker's latest per-bucket
    relative residual-norm measurements (||error-feedback residual|| /
    ||gradient||).  The coordinator's precision controller EWMAs them and
    picks the wire dtype per bucket; the worker just forwards raw
    measurements.  The f64 is the IEEE-754 bit pattern little-endian, so
    the value survives the py↔cpp boundary exactly."""
    reports: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class ResponseElasticExt:
    """Trailing ResponseList elastic extension:
    ``generation:i32 reconfigure:i8 (lost_rank:i32 lost_reason:str
    members:vec<old_pidx:i32 new_pidx:i32 first_rank:i32>)
    digest:i8 (coord_epoch:i32 cache_epoch:i32
    members:vec<first_rank:i32 addr:str> standbys:vec<i32>)``.

    ``members`` is the survivor/standby re-ranking table of a RECONFIGURE
    frame; a receiver absent from it has been evicted.  The trailing
    coordinator-state digest (``has_digest``) replicates everything a
    survivor needs to take over as coordinator: the coordinator-incarnation
    epoch, the response-cache epoch, the member table (first rank +
    pre-announced failover address per process index) and the
    parked-standby roster — see docs/elasticity.md#coordinator-failover."""
    generation: int = 0
    reconfigure: bool = False
    lost_rank: int = -1
    lost_reason: str = ""
    members: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    has_digest: bool = False
    coord_epoch: int = 0
    digest_cache_epoch: int = 0
    digest_members: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)
    digest_standbys: List[int] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------ integrity
# CRC32C (Castagnoli, reflected poly 0x82F63B78) — the checksum the
# native integrity layer (cpp/htpu/integrity.cc) stamps on control
# frames.  NOT zlib/binascii crc32 (that is the IEEE polynomial); this
# table mirrors the native software path bit for bit and is parity-tested
# against both native paths in tests.

_CRC32C_POLY = 0x82F63B78
_crc32c_table: Optional[List[int]] = None


def _crc32c_tbl() -> List[int]:
    global _crc32c_table
    if _crc32c_table is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (_CRC32C_POLY ^ (c >> 1)) if c & 1 else (c >> 1)
            tbl.append(c)
        _crc32c_table = tbl
    return _crc32c_table


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """Pure-Python CRC32C (incremental: pass the previous digest as
    ``crc``).  ``crc32c_py(b) == native Crc32c(b)`` by construction."""
    tbl = _crc32c_tbl()
    c = (crc & 0xFFFFFFFF) ^ 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data) -> int:
    """CRC32C via the native dispatched path when the core is loaded
    (SSE4.2 at memory bandwidth), the Python table otherwise.  A numpy
    array (a checkpoint shard's ``np.memmap``) is read in place, with no
    copy."""
    import numpy as np
    from horovod_tpu_torch import cpp_core   # lazy: cpp_core imports this module
    if not isinstance(data, np.ndarray):
        data = bytes(data)
    native = cpp_core.crc32c_native(data)
    if native is not None:
        return native
    return crc32c_py(data.tobytes() if isinstance(data, np.ndarray)
                     else data)


def integrity_enabled() -> bool:
    """HOROVOD_TPU_INTEGRITY — mirrors the native EnvFlag rule (first
    char '0'/'f'/'F'/'n'/'N' = off, default off) so both serializers pick
    the same wire format."""
    v = os.environ.get("HOROVOD_TPU_INTEGRITY", "")
    if not v:
        return False
    return v[0] not in "0fFnN"


def _put_crc_trailer(out: bytearray) -> None:
    out += struct.pack("<I", crc32c(bytes(out)))


def _check_crc_trailer(rd: "_Reader", what: str) -> None:
    body_end = rd.pos
    wire_crc = rd.i32() & 0xFFFFFFFF
    if crc32c(rd.data[:body_end]) != wire_crc:
        raise ValueError(
            f"checksum mismatch in {what}: CRC32C trailer does not match "
            "the frame body (corrupt frame)")


def _put_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += struct.pack("<i", len(b))
    out += b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def i8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from("<q", self.data, self.pos)
        self.pos += 8
        return v

    def str_(self) -> str:
        n = self.i32()
        v = self.data[self.pos:self.pos + n].decode("utf-8")
        self.pos += n
        return v


def serialize_request(r: Request, with_algo: bool = False,
                      with_set: bool = False) -> bytes:
    out = bytearray()
    out += struct.pack("<i", r.request_rank)
    out += struct.pack("<i", int(r.request_type))
    _put_str(out, r.tensor_name)
    _put_str(out, r.tensor_type)
    out += struct.pack("<i", r.root_rank)
    out += struct.pack("<i", r.device)
    out += struct.pack("<i", len(r.tensor_shape))
    for d in r.tensor_shape:
        out += struct.pack("<q", d)
    _put_str(out, r.wire_dtype)
    if with_algo:
        _put_str(out, getattr(r, "algo", ""))
    if with_set:
        out += struct.pack("<i", getattr(r, "process_set", 0))
    return bytes(out)


def parse_request(rd: _Reader, with_algo: bool = False,
                  with_set: bool = False) -> Request:
    rank = rd.i32()
    rtype = RequestType(rd.i32())
    name = rd.str_()
    dtype = rd.str_()
    root = rd.i32()
    device = rd.i32()
    ndims = rd.i32()
    shape = tuple(rd.i64() for _ in range(ndims))
    wire_dtype = rd.str_()
    algo = rd.str_() if with_algo else ""
    process_set = rd.i32() if with_set else 0
    return Request(request_rank=rank, request_type=rtype, tensor_name=name,
                   tensor_type=dtype, tensor_shape=shape, root_rank=root,
                   device=device, wire_dtype=wire_dtype, algo=algo,
                   process_set=process_set)


def serialize_response(r: Response, with_algo: bool = False,
                       with_set: bool = False) -> bytes:
    out = bytearray()
    out += struct.pack("<i", int(r.response_type))
    out += struct.pack("<i", len(r.tensor_names))
    for n in r.tensor_names:
        _put_str(out, n)
    _put_str(out, r.error_message)
    out += struct.pack("<i", len(r.devices))
    for d in r.devices:
        out += struct.pack("<i", d)
    out += struct.pack("<i", len(r.tensor_sizes))
    for s in r.tensor_sizes:
        out += struct.pack("<q", s)
    _put_str(out, r.wire_dtype)
    if with_algo:
        _put_str(out, getattr(r, "algo", ""))
    if with_set:
        out += struct.pack("<i", getattr(r, "process_set", 0))
    return bytes(out)


def parse_response(rd: _Reader, with_algo: bool = False,
                   with_set: bool = False) -> Response:
    rtype = ResponseType(rd.i32())
    names = [rd.str_() for _ in range(rd.i32())]
    error = rd.str_()
    devices = [rd.i32() for _ in range(rd.i32())]
    sizes = [rd.i64() for _ in range(rd.i32())]
    wire_dtype = rd.str_()
    algo = rd.str_() if with_algo else ""
    process_set = rd.i32() if with_set else 0
    return Response(response_type=rtype, tensor_names=names,
                    error_message=error, devices=devices, tensor_sizes=sizes,
                    wire_dtype=wire_dtype, algo=algo,
                    process_set=process_set)


def _any_algo(msgs) -> bool:
    # The algo extension bit is set only when some message carries a
    # non-empty algo, so ring-only traffic stays byte-identical to the
    # pre-algo wire format.
    return any(getattr(m, "algo", "") for m in msgs)


def _any_set(msgs) -> bool:
    # The set extension bit is set only when some message targets a
    # non-default process set, so single-tenant traffic stays
    # byte-identical to the pre-set wire format.
    return any(getattr(m, "process_set", 0) for m in msgs)


def _check_flags(flags: int, what: str) -> None:
    if flags & ~_KNOWN_FLAGS:
        raise ValueError(
            f"unknown flag bits 0x{flags & ~_KNOWN_FLAGS:02x} in {what} "
            "(frame from a newer wire version)")


def serialize_request_list(requests: List[Request],
                           shutdown: bool = False,
                           abort_rank: int = -1,
                           abort_reason: str = "",
                           cache_ext: Optional[RequestCacheExt] = None,
                           elastic_ext: Optional[RequestElasticExt] = None,
                           precision_ext: Optional[RequestPrecisionExt] = None,
                           ) -> bytes:
    # Without a cache extension the output is byte-identical to the legacy
    # (pre-cache) format, so HOROVOD_TPU_CACHE_CAPACITY=0 stays on the old
    # wire exactly.
    flags = (FLAG_SHUTDOWN if shutdown else 0)
    if cache_ext is not None:
        flags |= FLAG_CACHE_EXT
    with_algo = _any_algo(requests)
    if with_algo:
        flags |= FLAG_ALGO_EXT
    if elastic_ext is not None:
        flags |= FLAG_ELASTIC_EXT
    with_set = _any_set(requests)
    if with_set:
        flags |= FLAG_SET_EXT
    with_crc = integrity_enabled()
    if with_crc:
        flags |= FLAG_CRC_EXT
    if precision_ext is not None:
        flags |= FLAG_PRECISION_EXT
    out = bytearray()
    out += struct.pack("<B", flags)
    out += struct.pack("<i", abort_rank)
    _put_str(out, abort_reason)
    out += struct.pack("<i", len(requests))
    for r in requests:
        out += serialize_request(r, with_algo, with_set)
    if cache_ext is not None:
        out += struct.pack("<i", cache_ext.epoch)
        out += struct.pack("<i", len(cache_ext.bits))
        out += cache_ext.bits
    if elastic_ext is not None:
        out += struct.pack("<i", elastic_ext.generation)
    if precision_ext is not None:
        out += struct.pack("<i", len(precision_ext.reports))
        for name, residual in precision_ext.reports:
            _put_str(out, name)
            out += struct.pack("<d", residual)
    if with_crc:
        _put_crc_trailer(out)
    return bytes(out)


def parse_request_list_precision(data: bytes) -> Tuple[
        List[Request], bool, Abort, Optional[RequestCacheExt],
        Optional[RequestElasticExt], Optional[RequestPrecisionExt]]:
    rd = _Reader(data)
    flags = rd.i8()
    _check_flags(flags, "request list")
    shutdown = bool(flags & FLAG_SHUTDOWN)
    with_algo = bool(flags & FLAG_ALGO_EXT)
    with_set = bool(flags & FLAG_SET_EXT)
    abort_rank = rd.i32()
    abort_reason = rd.str_()
    reqs = [parse_request(rd, with_algo, with_set) for _ in range(rd.i32())]
    ext = None
    if flags & FLAG_CACHE_EXT:
        epoch = rd.i32()
        nbits = rd.i32()
        bits = bytes(rd.data[rd.pos:rd.pos + nbits])
        rd.pos += nbits
        ext = RequestCacheExt(epoch=epoch, bits=bits)
    elastic = None
    if flags & FLAG_ELASTIC_EXT:
        elastic = RequestElasticExt(generation=rd.i32())
    precision = None
    if flags & FLAG_PRECISION_EXT:
        reports = []
        for _ in range(rd.i32()):
            name = rd.str_()
            (residual,) = struct.unpack_from("<d", rd.data, rd.pos)
            rd.pos += 8
            reports.append((name, residual))
        precision = RequestPrecisionExt(reports=reports)
    if flags & FLAG_CRC_EXT:
        _check_crc_trailer(rd, "request list")
    if rd.pos != len(data):
        raise ValueError(
            f"trailing bytes in request list: parsed {rd.pos} of "
            f"{len(data)} bytes (corrupt or truncated frame)")
    abort = (abort_rank, abort_reason) if abort_rank >= 0 else None
    return reqs, shutdown, abort, ext, elastic, precision


def parse_request_list_elastic(data: bytes) -> Tuple[
        List[Request], bool, Abort, Optional[RequestCacheExt],
        Optional[RequestElasticExt]]:
    """Precision-agnostic view: tolerates (and discards) the v4 extension."""
    reqs, shutdown, abort, ext, elastic, _ = (
        parse_request_list_precision(data))
    return reqs, shutdown, abort, ext, elastic


def parse_request_list_ex(data: bytes) -> Tuple[
        List[Request], bool, Abort, Optional[RequestCacheExt]]:
    """Elastic-agnostic view: tolerates (and discards) the v3 extension."""
    reqs, shutdown, abort, ext, _ = parse_request_list_elastic(data)
    return reqs, shutdown, abort, ext


def parse_request_list(data: bytes) -> Tuple[List[Request], bool, Abort]:
    """Cache-agnostic view: tolerates (and discards) the v2 extension."""
    reqs, shutdown, abort, _ = parse_request_list_ex(data)
    return reqs, shutdown, abort


def serialize_response_list(responses: List[Response],
                            shutdown: bool = False,
                            abort_rank: int = -1,
                            abort_reason: str = "",
                            cache_ext: Optional[ResponseCacheExt] = None,
                            elastic_ext: Optional[ResponseElasticExt] = None,
                            ) -> bytes:
    flags = (FLAG_SHUTDOWN if shutdown else 0)
    if cache_ext is not None:
        flags |= FLAG_CACHE_EXT
    with_algo = _any_algo(responses)
    if with_algo:
        flags |= FLAG_ALGO_EXT
    if elastic_ext is not None:
        flags |= FLAG_ELASTIC_EXT
    with_set = _any_set(responses)
    if with_set:
        flags |= FLAG_SET_EXT
    with_crc = integrity_enabled()
    if with_crc:
        flags |= FLAG_CRC_EXT
    out = bytearray()
    out += struct.pack("<B", flags)
    out += struct.pack("<i", abort_rank)
    _put_str(out, abort_reason)
    out += struct.pack("<i", len(responses))
    for r in responses:
        out += serialize_response(r, with_algo, with_set)
    if cache_ext is not None:
        out += struct.pack("<i", cache_ext.epoch)
        cflags = ((CACHE_SERVED if cache_ext.served_from_cache else 0)
                  | (CACHE_FLUSH if cache_ext.flush else 0)
                  | (CACHE_STORE_SET if cache_ext.store_set else 0))
        out += struct.pack("<B", cflags)
        out += struct.pack("<i", len(cache_ext.assignments))
        for slot, name in cache_ext.assignments:
            out += struct.pack("<i", slot)
            _put_str(out, name)
        out += struct.pack("<i", len(cache_ext.evictions))
        for slot in cache_ext.evictions:
            out += struct.pack("<i", slot)
    if elastic_ext is not None:
        out += struct.pack("<i", elastic_ext.generation)
        out += struct.pack("<B", 1 if elastic_ext.reconfigure else 0)
        if elastic_ext.reconfigure:
            out += struct.pack("<i", elastic_ext.lost_rank)
            _put_str(out, elastic_ext.lost_reason)
            out += struct.pack("<i", len(elastic_ext.members))
            for old_pidx, new_pidx, first_rank in elastic_ext.members:
                out += struct.pack("<iii", old_pidx, new_pidx, first_rank)
        out += struct.pack("<B", 1 if elastic_ext.has_digest else 0)
        if elastic_ext.has_digest:
            out += struct.pack("<i", elastic_ext.coord_epoch)
            out += struct.pack("<i", elastic_ext.digest_cache_epoch)
            out += struct.pack("<i", len(elastic_ext.digest_members))
            for first_rank, addr in elastic_ext.digest_members:
                out += struct.pack("<i", first_rank)
                _put_str(out, addr)
            out += struct.pack("<i", len(elastic_ext.digest_standbys))
            for sid in elastic_ext.digest_standbys:
                out += struct.pack("<i", sid)
    if with_crc:
        _put_crc_trailer(out)
    return bytes(out)


def parse_response_list_elastic(data: bytes) -> Tuple[
        List[Response], bool, Abort, Optional[ResponseCacheExt],
        Optional[ResponseElasticExt]]:
    rd = _Reader(data)
    flags = rd.i8()
    _check_flags(flags, "response list")
    shutdown = bool(flags & FLAG_SHUTDOWN)
    with_algo = bool(flags & FLAG_ALGO_EXT)
    with_set = bool(flags & FLAG_SET_EXT)
    abort_rank = rd.i32()
    abort_reason = rd.str_()
    resps = [parse_response(rd, with_algo, with_set)
             for _ in range(rd.i32())]
    ext = None
    if flags & FLAG_CACHE_EXT:
        epoch = rd.i32()
        cflags = rd.i8()
        assignments = [(rd.i32(), rd.str_()) for _ in range(rd.i32())]
        evictions = [rd.i32() for _ in range(rd.i32())]
        ext = ResponseCacheExt(
            epoch=epoch,
            served_from_cache=bool(cflags & CACHE_SERVED),
            flush=bool(cflags & CACHE_FLUSH),
            store_set=bool(cflags & CACHE_STORE_SET),
            assignments=assignments, evictions=evictions)
    elastic = None
    if flags & FLAG_ELASTIC_EXT:
        generation = rd.i32()
        reconfigure = bool(rd.i8())
        lost_rank, lost_reason, members = -1, "", []
        if reconfigure:
            lost_rank = rd.i32()
            lost_reason = rd.str_()
            members = [(rd.i32(), rd.i32(), rd.i32())
                       for _ in range(rd.i32())]
        has_digest = bool(rd.i8())
        coord_epoch, digest_cache_epoch = 0, 0
        digest_members, digest_standbys = [], []
        if has_digest:
            coord_epoch = rd.i32()
            digest_cache_epoch = rd.i32()
            digest_members = [(rd.i32(), rd.str_())
                              for _ in range(rd.i32())]
            digest_standbys = [rd.i32() for _ in range(rd.i32())]
        elastic = ResponseElasticExt(
            generation=generation, reconfigure=reconfigure,
            lost_rank=lost_rank, lost_reason=lost_reason, members=members,
            has_digest=has_digest, coord_epoch=coord_epoch,
            digest_cache_epoch=digest_cache_epoch,
            digest_members=digest_members, digest_standbys=digest_standbys)
    if flags & FLAG_CRC_EXT:
        _check_crc_trailer(rd, "response list")
    if rd.pos != len(data):
        raise ValueError(
            f"trailing bytes in response list: parsed {rd.pos} of "
            f"{len(data)} bytes (corrupt or truncated frame)")
    abort = (abort_rank, abort_reason) if abort_rank >= 0 else None
    return resps, shutdown, abort, ext, elastic


def parse_response_list_ex(data: bytes) -> Tuple[
        List[Response], bool, Abort, Optional[ResponseCacheExt]]:
    """Elastic-agnostic view: tolerates (and discards) the v3 extension."""
    resps, shutdown, abort, ext, _ = parse_response_list_elastic(data)
    return resps, shutdown, abort, ext


def parse_response_list(data: bytes) -> Tuple[List[Response], bool, Abort]:
    """Cache-agnostic view: tolerates (and discards) the v2 extension."""
    resps, shutdown, abort, _ = parse_response_list_ex(data)
    return resps, shutdown, abort


def parse_single_response(data: bytes) -> Response:
    # Single-message frames (the C API's table endpoints) always carry the
    # trailing algo string — both sides of that ctypes boundary agree, so
    # no flag byte is needed.
    rd = _Reader(data)
    resp = parse_response(rd, with_algo=True)
    assert rd.pos == len(data), "trailing bytes in response"
    return resp
