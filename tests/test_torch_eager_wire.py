"""The port's wire frames are the JAX package's, byte for byte.

The same requests and responses, with the patterns of
``tests/test_cpp_core.py`` and ``tests/test_response_cache.py`` (abort
fields, shutdown, algorithm and wire-dtype strings, the response-cache,
elastic and precision extensions, the CRC32C trailer), are serialized by
``horovod_tpu_torch.wire`` and ``horovod_tpu.wire``: the bytes must be
equal, each package must parse the other's frames to the same messages,
and the port's build of the native core must reproduce a request list
through its own parser.
"""

import dataclasses

import pytest

from horovod_tpu import core as ref_core
from horovod_tpu import wire as ref_wire
from horovod_tpu_torch import core as port_core
from horovod_tpu_torch import cpp_core as port_cpp
from horovod_tpu_torch import wire as port_wire


def _requests(core, specs):
    return [core.Request(request_rank=rank,
                         request_type=core.RequestType(rtype),
                         tensor_name=name, tensor_type=dtype,
                         tensor_shape=tuple(shape), root_rank=root,
                         device=rank if device is None else device,
                         wire_dtype=wire, algo=algo)
            for rank, rtype, name, dtype, shape, root, device, wire, algo
            in specs]


def _responses(core, specs):
    return [core.Response(response_type=core.ResponseType(rtype),
                          tensor_names=list(names), error_message=err,
                          devices=list(devices), tensor_sizes=list(sizes),
                          wire_dtype=wire, algo=algo)
            for rtype, names, err, devices, sizes, wire, algo in specs]


AR, AG, BC, ERR = 0, 1, 2, 3
R2 = [(0, AR, "t", "float32", (4, 2), -1, None, "", ""),
      (1, AR, "t", "float32", (4, 2), -1, None, "", "")]
REQUEST_CASES = {
    "plain": dict(reqs=R2),
    "empty": dict(reqs=[]),
    "shutdown": dict(reqs=R2[:1], kw=dict(shutdown=True)),
    "abort": dict(reqs=R2[:1], kw=dict(abort_rank=3,
                                      abort_reason="peer reset")),
    "kinds": dict(reqs=[(0, AG, "g", "int64", (5, 3), -1, None, "", ""),
                        (2, BC, "b", "bfloat16", (), 1, -1, "", ""),
                        (1, AR, "ü.name", "float16", (1, 2, 3), -1, None,
                         "int8", "")]),
    "algo": dict(reqs=[(0, AR, "a", "float32", (9,), -1, None, "",
                        "small"),
                       (1, AR, "b", "float32", (9,), -1, None, "", "")]),
    "cache_ext": dict(reqs=R2, ext=dict(cache_ext=("RequestCacheExt",
                                                   dict(epoch=7,
                                                        bits=b"\x05\x80")))),
    "bits_only": dict(reqs=[], ext=dict(cache_ext=(
        "RequestCacheExt", dict(epoch=3, bits=b"\xff")))),
    "elastic_ext": dict(reqs=R2, ext=dict(elastic_ext=(
        "RequestElasticExt", dict(generation=4)))),
    "precision_ext": dict(reqs=R2[:1], ext=dict(precision_ext=(
        "RequestPrecisionExt", dict(reports=[("bucket.0", 0.125),
                                             ("bucket.1", 1e-9)])))),
}
RESPONSE_CASES = {
    "mixed": dict(resps=[(AR, ["a", "b"], "", [0, 1], [], "", ""),
                         (ERR, ["c"], "boom", [0, 1], [], "", ""),
                         (AG, ["d"], "", [0, 1], [5, 6], "", "")]),
    "shutdown": dict(resps=[], kw=dict(shutdown=True)),
    "abort": dict(resps=[(AR, ["x"], "", [0], [], "", "")],
                  kw=dict(abort_rank=1, abort_reason="rank 1 died")),
    "wire_algo": dict(resps=[(AR, ["w"], "", [0, 1], [], "bf16", "hier"),
                             (BC, ["v"], "", [0, 1], [], "", "")]),
    "cache_ext": dict(resps=[(AR, ["a"], "", [0], [], "", "")],
                      ext=dict(cache_ext=("ResponseCacheExt", dict(
                          epoch=2, store_set=True,
                          assignments=[(0, "a"), (5, "b")],
                          evictions=[3, 4])))),
    "served": dict(resps=[], ext=dict(cache_ext=(
        "ResponseCacheExt", dict(epoch=5, served_from_cache=True)))),
    "flush": dict(resps=[], kw=dict(abort_rank=0, abort_reason="x"),
                  ext=dict(cache_ext=("ResponseCacheExt",
                                      dict(epoch=1, flush=True)))),
    "elastic": dict(resps=[], ext=dict(elastic_ext=(
        "ResponseElasticExt", dict(
            generation=6, reconfigure=True, lost_rank=2,
            lost_reason="gone", members=[(0, 0, 0), (1, 1, 2)],
            has_digest=True, coord_epoch=1, digest_cache_epoch=9,
            digest_members=[(0, "h:1"), (2, "h:2")],
            digest_standbys=[7])))),
}


def _ext(wire_mod, ext):
    return {k: getattr(wire_mod, cls)(**kw)
            for k, (cls, kw) in (ext or {}).items()}


@pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
@pytest.mark.parametrize("case", sorted(REQUEST_CASES))
def test_request_list_frames_equal_the_reference(case, crc, monkeypatch):
    if crc:
        monkeypatch.setenv("HOROVOD_TPU_INTEGRITY", "1")
    else:
        monkeypatch.delenv("HOROVOD_TPU_INTEGRITY", raising=False)
    c = REQUEST_CASES[case]
    kw = c.get("kw", {})
    ref = ref_wire.serialize_request_list(
        _requests(ref_core, c["reqs"]), **kw, **_ext(ref_wire, c.get("ext")))
    got = port_wire.serialize_request_list(
        _requests(port_core, c["reqs"]), **kw,
        **_ext(port_wire, c.get("ext")))
    assert got == ref
    # Each package parses the other's frame to the same messages.
    a = port_wire.parse_request_list_precision(ref)
    b = ref_wire.parse_request_list_precision(got)
    assert [dataclasses.asdict(r) for r in a[0]] == \
        [dataclasses.asdict(r) for r in b[0]]
    assert a[1:3] == b[1:3]
    for x, y in zip(a[3:], b[3:]):
        assert (x is None) == (y is None)
        if x is not None:
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
    # The port's native core reads and rewrites the same bytes (it
    # decides on the CRC trailer by its own reading of the knob, once).
    if not crc:
        assert port_cpp.wire_request_list_roundtrip(got) == got


@pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
@pytest.mark.parametrize("case", sorted(RESPONSE_CASES))
def test_response_list_frames_equal_the_reference(case, crc, monkeypatch):
    if crc:
        monkeypatch.setenv("HOROVOD_TPU_INTEGRITY", "1")
    else:
        monkeypatch.delenv("HOROVOD_TPU_INTEGRITY", raising=False)
    c = RESPONSE_CASES[case]
    kw = c.get("kw", {})
    ref = ref_wire.serialize_response_list(
        _responses(ref_core, c["resps"]), **kw,
        **_ext(ref_wire, c.get("ext")))
    got = port_wire.serialize_response_list(
        _responses(port_core, c["resps"]), **kw,
        **_ext(port_wire, c.get("ext")))
    assert got == ref
    a = port_wire.parse_response_list_elastic(ref)
    b = ref_wire.parse_response_list_elastic(got)
    assert [dataclasses.asdict(r) for r in a[0]] == \
        [dataclasses.asdict(r) for r in b[0]]
    assert a[1:3] == b[1:3]
    for x, y in zip(a[3:], b[3:]):
        assert (x is None) == (y is None)
        if x is not None:
            assert dataclasses.asdict(x) == dataclasses.asdict(y)


@pytest.mark.parametrize("with_algo", [False, True])
def test_single_messages_equal_the_reference(with_algo):
    rq = R2[0][:-1] + ("small",)
    assert port_wire.serialize_request(
        _requests(port_core, [rq])[0], with_algo=with_algo) == \
        ref_wire.serialize_request(_requests(ref_core, [rq])[0],
                                   with_algo=with_algo)
    rs = (AG, ["d", "e"], "", [0, 1, 2], [1, 2, 3], "fp16", "small")
    assert port_wire.serialize_response(
        _responses(port_core, [rs])[0], with_algo=with_algo) == \
        ref_wire.serialize_response(_responses(ref_core, [rs])[0],
                                    with_algo=with_algo)


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256))])
def test_crc32c_equals_the_reference(data):
    assert port_wire.crc32c_py(data) == ref_wire.crc32c_py(data)
    assert port_wire.crc32c(data) == ref_wire.crc32c(data)


def test_unknown_flag_bits_are_rejected_like_the_reference():
    blob = bytearray(port_wire.serialize_request_list([]))
    blob[0] |= 0x80
    for mod in (port_wire, ref_wire):
        with pytest.raises(ValueError, match="unknown flag bits 0x80"):
            mod.parse_request_list(bytes(blob))
