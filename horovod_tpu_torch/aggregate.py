"""Control-plane aggregation containers -- Python mirror of
``cpp/htpu/aggregate.{h,cc}``.

Port of ``horovod_tpu/aggregate.py`` (numpy-free, torch-free): the same
container, merge and parse, byte for byte.  Under the hierarchical
control topology (``HOROVOD_TPU_CONTROL_TOPO=hier``) each host's
sub-coordinator folds its members' RequestList frames into ONE container
and forwards it to the root, so root fan-in is O(hosts) instead of
O(processes).  The native control plane builds and folds the containers
itself; this mirror (held against the native code through
``cpp_core.agg_merge`` / ``cpp_core.agg_roundtrip`` and against the JAX
package's in ``tests/test_torch_aggregate.py``) lets tools and tests
build, inspect and fold them without the native core.

The merge is a pure function over canonical member sets -- associative,
commutative, and idempotent -- which is what lets the tree fold frames at
any depth without coordinator state.

Wire format (little-endian, str = i32 length + bytes)::

    AggFrame := magic:u32("HAGG") version:u8 flags:u8
                [template:str]                        (flags bit 0)
                rosters:vec<first_pidx:i32 count:i32>
                members:vec<pidx:i32 status:u8 [frame:str if status==Ok]>

The template/roster pair is the steady-state compression: on a
response-cache-served tick every member submits the identical bits-only
frame, so the container carries it once plus [first, first+count) pidx
ranges -- O(1) bytes per host however many processes the host runs.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

# "HAGG" read as a little-endian u32.  Deliberately NOT a RequestList
# flag bit: the container is a distinct frame format that only travels
# leader->root, so member frames (and the flat topology) stay
# byte-identical to the pre-aggregation protocol.
AGG_MAGIC = 0x47474148
AGG_VERSION = 1
AGG_HAS_TEMPLATE = 0x01

# Member status: OK carries the frame; DEAD is a member that missed its
# sub-coordinator's gather deadline (the root synthesizes the same
# attributed heartbeat failure the flat gather would have); STALE is
# reserved for aggregators that pre-screen membership generations.
AGG_OK = 0
AGG_DEAD = 1
AGG_STALE = 2


@dataclasses.dataclass
class AggMember:
    pidx: int = -1
    status: int = AGG_OK
    # Opaque RequestList bytes exactly as the member sent them (minus the
    # outermost clock trailer).  Empty when status != AGG_OK.
    frame: bytes = b""


def _winner(a: AggMember, b: AggMember) -> AggMember:
    """Collision rule: max status wins, equal statuses keep the smaller
    frame — a selection under a total order, hence associative,
    commutative, and idempotent."""
    if a.status != b.status:
        return a if a.status > b.status else b
    return a if a.frame <= b.frame else b


def aggregate_requests(members_in: List[AggMember],
                       acc: List[AggMember]) -> List[AggMember]:
    """Fold ``members_in`` into ``acc``: map union keyed by pidx under
    ``_winner``, returned as a fresh canonical (pidx-ascending,
    duplicate-free) list.  Mirror of ``htpu::AggregateRequests``."""
    merged = {}
    for m in list(acc) + list(members_in):
        cur = merged.get(m.pidx)
        merged[m.pidx] = m if cur is None else _winner(cur, m)
    return [merged[p] for p in sorted(merged)]


def merge_cache_bits(a: bytes, b: bytes) -> bytes:
    """OR-merge two response-cache hit-slot bitvectors (LSB of byte 0 =
    slot 0), trimming trailing zero bytes back to the canonical client
    form.  Mirror of ``htpu::MergeCacheBits``."""
    out = bytearray(max(len(a), len(b)))
    for i in range(len(out)):
        v = 0
        if i < len(a):
            v |= a[i]
        if i < len(b):
            v |= b[i]
        out[i] = v
    while out and out[-1] == 0:
        out.pop()
    return bytes(out)


def serialize_agg_frame(members: List[AggMember]) -> bytes:
    """Canonical container bytes for ``members`` (need not be
    pre-sorted).  Mirror of ``htpu::SerializeAggFrame``: members are
    canonicalized, the template is the frame shared by the most OK
    members (ties to the lexicographically smallest, only when at least
    two share it), rosters are maximal consecutive-pidx runs matching
    the template."""
    canon = aggregate_requests(members, [])

    freq = {}
    for m in canon:
        if m.status == AGG_OK:
            freq[m.frame] = freq.get(m.frame, 0) + 1
    template = b""
    best = 1
    for frame in sorted(freq):
        if freq[frame] > best:
            best = freq[frame]
            template = frame
    has_template = best > 1

    out = bytearray()
    out += struct.pack("<IBB", AGG_MAGIC, AGG_VERSION,
                       AGG_HAS_TEMPLATE if has_template else 0)
    if has_template:
        out += struct.pack("<i", len(template)) + template

    rosters: List[Tuple[int, int]] = []
    rest: List[AggMember] = []
    for m in canon:
        if has_template and m.status == AGG_OK and m.frame == template:
            if rosters and rosters[-1][0] + rosters[-1][1] == m.pidx:
                rosters[-1] = (rosters[-1][0], rosters[-1][1] + 1)
            else:
                rosters.append((m.pidx, 1))
        else:
            rest.append(m)
    out += struct.pack("<i", len(rosters))
    for first, count in rosters:
        out += struct.pack("<ii", first, count)
    out += struct.pack("<i", len(rest))
    for m in rest:
        out += struct.pack("<iB", m.pidx, m.status)
        if m.status == AGG_OK:
            out += struct.pack("<i", len(m.frame)) + m.frame
    return bytes(out)


class _Reader:
    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def u8(self) -> int:
        (v,) = struct.unpack_from("<B", self._buf, self._pos)
        self._pos += 1
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self._buf, self._pos)
        self._pos += 4
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self._buf, self._pos)
        self._pos += 4
        return v

    def bytes_(self) -> bytes:
        n = self.i32()
        if n < 0 or self._pos + n > len(self._buf):
            raise ValueError("corrupt aggregation container")
        v = self._buf[self._pos:self._pos + n]
        self._pos += n
        return v

    def done(self) -> bool:
        return self._pos == len(self._buf)


def parse_agg_frame(buf: bytes) -> List[AggMember]:
    """Parse + validate one container; raises ``ValueError`` on a
    short/corrupt/unknown-version container.  The returned member list
    is canonical (re-merged), mirroring ``htpu::ParseAggFrame``."""
    try:
        rd = _Reader(buf)
        if rd.u32() != AGG_MAGIC:
            raise ValueError("bad aggregation container magic")
        if rd.u8() != AGG_VERSION:
            raise ValueError("unknown aggregation container version")
        flags = rd.u8()
        if flags & ~AGG_HAS_TEMPLATE:
            raise ValueError("unknown aggregation container flags")
        template = rd.bytes_() if flags & AGG_HAS_TEMPLATE else b""
        members: List[AggMember] = []
        nrosters = rd.i32()
        if nrosters < 0:
            raise ValueError("corrupt aggregation container")
        for _ in range(nrosters):
            first = rd.i32()
            count = rd.i32()
            if count <= 0 or first < 0 or not flags & AGG_HAS_TEMPLATE:
                raise ValueError("corrupt aggregation container")
            if count > len(buf):
                # Could never have been produced by the serializer; bound
                # it so a corrupt frame cannot balloon memory.
                raise ValueError("corrupt aggregation container")
            for k in range(count):
                members.append(AggMember(first + k, AGG_OK, template))
        nrest = rd.i32()
        if nrest < 0 or nrest > len(buf):
            raise ValueError("corrupt aggregation container")
        for _ in range(nrest):
            pidx = rd.i32()
            status = rd.u8()
            if status > AGG_STALE:
                raise ValueError("corrupt aggregation container")
            frame = rd.bytes_() if status == AGG_OK else b""
            members.append(AggMember(pidx, status, frame))
        if not rd.done():
            raise ValueError("trailing bytes in aggregation container")
    except struct.error as exc:
        raise ValueError("corrupt aggregation container") from exc
    return aggregate_requests(members, [])


def split_responses(response_frame: bytes,
                    members: List[AggMember]) -> List[Tuple[int, bytes]]:
    """Fan a response frame down the tree: one (pidx, frame) pair per OK
    member.  Mirror of ``htpu::SplitResponses``."""
    return [(m.pidx, response_frame) for m in members
            if m.status == AGG_OK]
