"""The port's aggregation containers (``horovod_tpu_torch/aggregate.py``)
and the rest of its ``cpp_core`` bindings against the JAX package's.

The same member sets, made from a seed, go through the port's mirror,
``horovod_tpu.aggregate`` and the native merge (the port's
``cpp_core.agg_merge`` / ``agg_roundtrip``): the bytes must be equal, and
the merge algebra, the wire format and the corrupt-container cases of
``tests/test_aggregate.py:61-210`` hold on the port with the reference's
error texts.  Each binding the port gained (wire codec, ``sum_into``,
metrics reset, flight recorder, observatory trailer, CRC32C) gives the
reference's bytes, values or dict on the same input.
"""

import json
import random
import struct

import numpy as np
import pytest

from horovod_tpu import aggregate as ref_agg
from horovod_tpu import cpp_core as ref_core
from horovod_tpu_torch import aggregate as agg
from horovod_tpu_torch import cpp_core


def member(pidx, status=agg.AGG_OK, frame=b""):
    return agg.AggMember(pidx, status, frame)


def rand_members(rng, npidx=8):
    """A random member multiset: duplicate pidxs, shared frames (the
    template election), dead and stale entries."""
    frames = [bytes(rng.getrandbits(8) for _ in range(rng.randrange(12)))
              for _ in range(3)]
    out = []
    for _ in range(rng.randrange(1, 10)):
        status = rng.choice([agg.AGG_OK, agg.AGG_OK, agg.AGG_OK,
                             agg.AGG_DEAD, agg.AGG_STALE])
        out.append(member(rng.randrange(npidx), status,
                          rng.choice(frames) if status == agg.AGG_OK
                          else b""))
    return out


def as_ref(members):
    return [ref_agg.AggMember(m.pidx, m.status, m.frame) for m in members]


def fold(*sets):
    acc = []
    for s in sets:
        acc = agg.aggregate_requests(s, acc)
    return acc


def test_constants_match_the_reference():
    for name in ("AGG_MAGIC", "AGG_VERSION", "AGG_HAS_TEMPLATE", "AGG_OK",
                 "AGG_DEAD", "AGG_STALE"):
        assert getattr(agg, name) == getattr(ref_agg, name), name


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_frames_equal_the_reference_bit_for_bit(seed):
    rng = random.Random(seed)
    for _ in range(100):
        a, b = rand_members(rng), rand_members(rng)
        buf = agg.serialize_agg_frame(a)
        assert buf == ref_agg.serialize_agg_frame(as_ref(a))
        merged = agg.serialize_agg_frame(fold(a, b))
        assert merged == ref_agg.serialize_agg_frame(
            ref_agg.aggregate_requests(as_ref(b), as_ref(a)))
        assert as_ref(agg.parse_agg_frame(buf)) == \
            ref_agg.parse_agg_frame(buf)
        resp = bytes(rng.getrandbits(8) for _ in range(5))
        assert agg.split_responses(resp, fold(a)) == \
            ref_agg.split_responses(resp, ref_agg.parse_agg_frame(buf))
        x, y = (bytes(rng.getrandbits(8) for _ in range(rng.randrange(6)))
                for _ in range(2))
        assert agg.merge_cache_bits(x, y) == ref_agg.merge_cache_bits(x, y)


class TestMergeAlgebra:
    def test_associative_and_commutative(self):
        rng = random.Random(7)
        for _ in range(200):
            a, b, c = (rand_members(rng) for _ in range(3))
            left = agg.serialize_agg_frame(fold(fold(a, b), c))
            right = agg.serialize_agg_frame(fold(a, fold(b, c)))
            swapped = agg.serialize_agg_frame(fold(c, b, a))
            assert left == right == swapped

    def test_idempotent(self):
        rng = random.Random(8)
        for _ in range(100):
            a = rand_members(rng)
            assert (agg.serialize_agg_frame(fold(a))
                    == agg.serialize_agg_frame(fold(a, a)))

    def test_death_report_beats_frame(self):
        alive = [member(3, agg.AGG_OK, b"req")]
        dead = [member(3, agg.AGG_DEAD)]
        for order in ((alive, dead), (dead, alive)):
            (m,) = fold(*order)
            assert m.status == agg.AGG_DEAD and m.frame == b""

    def test_equal_status_keeps_smaller_frame(self):
        a = [member(1, agg.AGG_OK, b"bbb")]
        b = [member(1, agg.AGG_OK, b"aaa")]
        for order in ((a, b), (b, a)):
            (m,) = fold(*order)
            assert m.frame == b"aaa"

    def test_cache_bits_or_merge_algebra(self):
        rng = random.Random(9)
        for _ in range(200):
            a, b, c = (bytes(rng.getrandbits(8)
                             for _ in range(rng.randrange(6)))
                       for _ in range(3))
            left = agg.merge_cache_bits(agg.merge_cache_bits(a, b), c)
            right = agg.merge_cache_bits(a, agg.merge_cache_bits(b, c))
            assert left == right
            assert agg.merge_cache_bits(a, b) == agg.merge_cache_bits(b, a)
            once = agg.merge_cache_bits(a, b)
            assert agg.merge_cache_bits(once, once) == once

    def test_cache_bits_trim_trailing_zeros(self):
        assert agg.merge_cache_bits(b"\x01\x00\x00", b"\x00") == b"\x01"
        assert agg.merge_cache_bits(b"", b"") == b""
        assert agg.merge_cache_bits(b"\x80", b"\x01") == b"\x81"


class TestWireFormat:
    def test_roundtrip_random(self):
        rng = random.Random(10)
        for _ in range(200):
            members = rand_members(rng)
            buf = agg.serialize_agg_frame(members)
            assert agg.parse_agg_frame(buf) == fold(members)
            assert agg.serialize_agg_frame(agg.parse_agg_frame(buf)) == buf

    def test_template_roster_compresses_uniform_tick(self):
        frame = b"\x02" + b"\x07" * 30
        small = agg.serialize_agg_frame(
            [member(p, agg.AGG_OK, frame) for p in range(4)])
        big = agg.serialize_agg_frame(
            [member(p, agg.AGG_OK, frame) for p in range(64)])
        assert len(big) == len(small)
        assert big.count(frame) == 1

    def test_ragged_pidx_runs_split_rosters(self):
        buf = agg.serialize_agg_frame(
            [member(p, agg.AGG_OK, b"same") for p in (0, 1, 3, 4, 5)])
        parsed = agg.parse_agg_frame(buf)
        assert [m.pidx for m in parsed] == [0, 1, 3, 4, 5]
        assert all(m.frame == b"same" for m in parsed)

    def test_no_singleton_template(self):
        buf = agg.serialize_agg_frame([member(2, agg.AGG_OK, b"only")])
        assert buf[5] == 0
        assert agg.parse_agg_frame(buf) == [member(2, agg.AGG_OK, b"only")]

    @pytest.mark.parametrize("mutate", [
        lambda b: b"XXXX" + b[4:],                      # bad magic
        lambda b: b[:4] + b"\x63" + b[5:],              # unknown version
        lambda b: b[:5] + b"\x82" + b[6:],              # unknown flags
        lambda b: b[:-1],                               # truncated
        lambda b: b + b"\x00",                          # trailing bytes
        lambda b: b"",                                  # empty
    ], ids=["magic", "version", "flags", "truncated", "trailing", "empty"])
    def test_corrupt_containers_rejected_with_the_reference_text(self,
                                                                 mutate):
        buf = mutate(agg.serialize_agg_frame(
            [member(0, agg.AGG_OK, b"f"), member(1, agg.AGG_DEAD)]))
        with pytest.raises(ValueError) as got:
            agg.parse_agg_frame(buf)
        with pytest.raises(ValueError) as want:
            ref_agg.parse_agg_frame(buf)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="corrupt aggregation"):
            cpp_core.agg_roundtrip(buf)

    def test_negative_roster_count_rejected(self):
        head = struct.pack("<IBB", agg.AGG_MAGIC, agg.AGG_VERSION, 0)
        buf = head + struct.pack("<i", -1) + struct.pack("<i", 0)
        with pytest.raises(ValueError, match="corrupt aggregation"):
            agg.parse_agg_frame(buf)
        with pytest.raises(ValueError, match="corrupt aggregation"):
            cpp_core.agg_roundtrip(buf)

    def test_split_responses_targets_ok_members_only(self):
        members = [member(0, agg.AGG_OK, b"a"), member(1, agg.AGG_DEAD),
                   member(2, agg.AGG_OK, b"b")]
        assert agg.split_responses(b"resp", members) == [(0, b"resp"),
                                                         (2, b"resp")]


class TestNativeParity:
    """The port's mirror against the native merge through the port's
    bindings, and the port's bindings against the reference's."""

    def test_merge_parity_random(self):
        rng = random.Random(11)
        for _ in range(100):
            a = agg.serialize_agg_frame(rand_members(rng))
            b = agg.serialize_agg_frame(rand_members(rng))
            py = agg.serialize_agg_frame(
                fold(agg.parse_agg_frame(a), agg.parse_agg_frame(b)))
            nat = cpp_core.agg_merge(b, a)   # folds a INTO b
            assert nat == py == ref_core.agg_merge(b, a)

    def test_roundtrip_parity_random(self):
        rng = random.Random(12)
        for _ in range(100):
            buf = agg.serialize_agg_frame(rand_members(rng))
            assert cpp_core.agg_roundtrip(buf) == buf
            assert ref_core.agg_roundtrip(buf) == buf

    def test_native_rejects_corrupt(self):
        with pytest.raises(ValueError, match="corrupt aggregation"):
            cpp_core.agg_roundtrip(b"XXXXgarbage")
        good = agg.serialize_agg_frame([member(0, agg.AGG_OK, b"f")])
        with pytest.raises(ValueError, match="corrupt aggregation"):
            cpp_core.agg_merge(good, good[:-1])


# ------------------------------------------------ the rest of cpp_core

def _values(seed, n=3 * 65536 + 37):
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32)
    x[:1024] *= 1e-3       # a block with a small absmax
    x[1024] = 0.0
    return x


@pytest.mark.parametrize("wire", ["bf16", "fp16", "int8"])
def test_wire_codec_hooks_match_the_reference(wire):
    x = _values(1)
    got, nbytes = cpp_core.wire_roundtrip(wire, x)
    want, want_bytes = ref_core.wire_roundtrip(wire, x)
    assert nbytes == want_bytes and got.tobytes() == want.tobytes()
    enc = cpp_core.wire_encode(wire, x)
    assert enc == ref_core.wire_encode(wire, x) and len(enc) == nbytes
    assert (cpp_core.wire_decode(wire, enc, x.size).tobytes()
            == ref_core.wire_decode(wire, enc, x.size).tobytes())


def test_wire_codec_hooks_reject_an_unknown_dtype():
    x = _values(2, 2048)
    for fn in (lambda m: m.wire_roundtrip("int4", x),
               lambda m: m.wire_encode("int4", x)):
        with pytest.raises(ValueError) as got:
            fn(cpp_core)
        with pytest.raises(ValueError) as want:
            fn(ref_core)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype,np_dtype", [
    ("float32", np.float32), ("float64", np.float64), ("int32", np.int32),
    ("int64", np.int64), ("float16", np.float16), ("bfloat16", np.uint16)])
def test_sum_into_matches_the_reference(dtype, np_dtype):
    rng = np.random.RandomState(3)
    if np.issubdtype(np_dtype, np.integer) and np_dtype != np.uint16:
        a = rng.randint(-1000, 1000, 4099).astype(np_dtype)
        b = rng.randint(-1000, 1000, 4099).astype(np_dtype)
    elif np_dtype == np.uint16:      # bf16 bit patterns of small floats
        a = (rng.randn(4099).astype(np.float32).view(np.uint32)
             >> 16).astype(np.uint16)
        b = (rng.randn(4099).astype(np.float32).view(np.uint32)
             >> 16).astype(np.uint16)
    else:
        a = rng.randn(4099).astype(np_dtype)
        b = rng.randn(4099).astype(np_dtype)
    got, want = a.copy(), a.copy()
    cpp_core.sum_into(dtype, got, b)
    ref_core.sum_into(dtype, want, b)
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="size mismatch"):
        cpp_core.sum_into(dtype, got, b[:-1])


def test_crc32c_paths_match_the_reference():
    rng = np.random.RandomState(4)
    for n in (0, 1, 7, 8, 63, 4096, 100003):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        sw = cpp_core.crc32c_native_sw(data)
        assert sw == ref_core.crc32c_native_sw(data)
        assert sw == cpp_core.crc32c_native(data)
    assert cpp_core.crc32c_hardware() == ref_core.crc32c_hardware()


def _events(snapshot: str):
    return [(e["kind"], e["detail"], e["bytes"], e["a"], e["b"])
            for e in json.loads(snapshot)["events"]]


def test_flight_recorder_hooks_match_the_reference():
    """Both packages load their own build of the same core, so the same
    calls give the same ring."""
    snaps = []
    for core in (cpp_core, ref_core):
        core.flight_set_capacity(64)
        core.flight_set_rank(5)
        for i in range(70):          # wraps the ring
            core.flight_record("policy.evict", f"drill {i}", i, 1, 2)
        snaps.append(json.loads(core.flight_snapshot("parity")))
    got, want = snaps
    assert got["rank"] == want["rank"] == 5
    assert got["capacity"] == want["capacity"] == 64
    assert got["recorded"] == want["recorded"]
    assert _events(json.dumps(got)) == _events(json.dumps(want))
    assert len(got["events"]) == 64
    assert got["events"][-1]["detail"] == "drill 69"
    cpp_core.flight_set_capacity(1024)
    ref_core.flight_set_capacity(1024)


def test_metrics_reset_and_observatory_hooks_match_the_reference():
    outs = []
    for core in (cpp_core, ref_core):
        core.metrics_reset()
        core.observe_reset()
        core.observe_set_enabled(True)
        core.observe_note_step(0.25, 0.2, 0.03, 0.02, 0.0)
        core.observe_record_xfer(1, 1 << 20, 1 << 19, 0.001)
        trailer = core.observe_trailer_encode()
        probe = core.observe_trailer_probe(b"frame" + trailer)
        plain = core.observe_trailer_probe(b"frame")
        snap = core.observe_snapshot()
        core.observe_set_enabled(False)
        off = core.observe_trailer_encode()
        core.observe_reset()
        core.metrics_reset()
        counters = core.metrics_snapshot().get("counters", {})
        outs.append((len(trailer) > 0, probe, plain, snap, off,
                     {k: v for k, v in counters.items() if v}))
    got, want = outs
    for g, w in zip(got[:3], want[:3]):
        assert g == w
    assert got[1]["stripped"] and got[1]["payload_len"] == 5
    assert got[3].keys() == want[3].keys()
    assert got[4] == want[4] == b""
    assert got[5] == want[5] == {}
