"""The port's int8 block codec, compressor, wire names and wire plan,
held against the JAX package on the same numpy inputs.

* Codec: ``quantize_blocks``, ``dequantize_blocks`` and ``snap_to_grid``
  (the plain versions of port kernels P4 and P5 on the CPU) against the
  JAX package's Pallas codec in interpret mode: the q bytes, the scale
  bits and the dequantized bits are identical, on random data and on the
  edge blocks (all zero, a tiny normal absmax, values near 1e38,
  randn * exp(U(-6, 6))).
* Host wire image: byte for byte against the native core's
  ``wire_encode``/``wire_decode`` (skipped when the core is not built),
  edge blocks included.  A block with a subnormal absmax is held against
  the native core only: XLA's CPU backend flushes subnormals to zero, so
  the JAX codec reads such a block as all zero (scale 1), while the C++
  codec, PyTorch on the CPU and the CUDA kernel (no ``-ftz``) keep them
  (scale FLT_MIN).
* ``Int8Compressor``: f32, bf16 and f16, bit-identical to JAX.
* Policy: ``int8_eligible``, the floor knob, the wire names, their error
  messages and the env fill-in; ``estimate_wire_plan`` equal to JAX's.
* Dispatch: a CPU tensor takes the plain version, a CUDA tensor reaches
  the kernel wrapper, and the wrappers refuse what they cannot launch.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import compression as jax_comp
from horovod_tpu import cpp_core
from horovod_tpu.ops import quantized_collectives as jqc
from horovod_tpu_torch import compression as tcomp
from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.ops import quantized_collectives as tqc


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _edge_blocks(subnormal=False):
    """1024-element blocks: all zero; two tiny normal values; values near
    1e38; randn * exp(U(-6, 6)); with ``subnormal``, a block whose absmax
    is subnormal."""
    rng = np.random.RandomState(7)
    zero = np.zeros(1024, np.float32)
    tiny = np.zeros(1024, np.float32)
    tiny[7] = 2e-38
    tiny[100] = -1.5e-38
    big = (rng.uniform(-1, 1, 1024) * 1e38).astype(np.float32)
    big[5] = 3.0e38
    wide = (rng.randn(1024) * np.exp(rng.uniform(-6, 6, 1024))).astype(
        np.float32)
    blocks = [zero, tiny, big, wide]
    if subnormal:
        sub = rng.uniform(-1.1e-38, 1.1e-38, 1024).astype(np.float32)
        sub[3] = 0.0
        blocks.insert(2, sub)
    return np.concatenate(blocks)


def _codec_case(name):
    if name == "edge":
        return _edge_blocks()
    n = int(name)
    rng = np.random.RandomState(n)
    return (rng.randn(n) * np.exp(rng.uniform(-6, 6, n))).astype(np.float32)


@pytest.mark.parametrize("case", ["1024", "4096", "65536", "9216", "edge"])
def test_codec_bit_identical_to_jax(monkeypatch, case):
    monkeypatch.setenv("HOROVOD_TPU_INJIT_PALLAS", "1")   # interpret mode
    x = _codec_case(case)
    jq, js = jqc.quantize_blocks(jnp.asarray(x))
    tq, ts = tqc.quantize_blocks(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(_bits(js), _bits(ts.numpy()))
    jd = jqc.dequantize_blocks(jq, js)
    td = tqc.dequantize_blocks(tq, ts)
    assert np.array_equal(_bits(jd), _bits(td.numpy()))
    assert np.all(np.isfinite(td.numpy()))
    assert np.array_equal(_bits(jqc.snap_to_grid(jnp.asarray(x))),
                          _bits(tqc.snap_to_grid(torch.from_numpy(x))))


@pytest.mark.parametrize("shape", [(1,), (1025,), (33, 31), (3, 341),
                                   (2047,)])
def test_snap_to_grid_tails_bit_identical_to_jax(shape):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    got = tqc.snap_to_grid(torch.from_numpy(x))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    assert np.array_equal(_bits(jqc.snap_to_grid(jnp.asarray(x))),
                          _bits(got.numpy()))


def test_edge_blocks_scales():
    """All-zero block: scale 1 and exact zeros back; the tiny and subnormal
    blocks take the FLT_MIN clamp and stay NaN-free."""
    q, s = tqc.quantize_blocks(torch.from_numpy(_edge_blocks(True)))
    s = s.numpy().reshape(-1)
    assert s[0] == 1.0 and not q[0].any()
    assert s[1] == np.float32(tqc.MIN_SCALE)
    assert s[2] == np.float32(tqc.MIN_SCALE) and q[2].any()
    out = tqc.dequantize_blocks(q, torch.from_numpy(s).reshape(-1, 1))
    assert np.all(np.isfinite(out.numpy()))


def test_quantize_blocks_refuses_ragged_input():
    with pytest.raises(ValueError, match="multiple of 1024"):
        tqc.quantize_blocks(torch.zeros(1000))
    with pytest.raises(ValueError, match="multiple of 1024"):
        tqc.quantize_blocks(torch.zeros(2, 1024))


# ------------------------------------------------------ host wire image


@pytest.mark.parametrize("n", [100, 1024, 1025, 65536, 70001])
def test_host_wire_image_matches_native_core(n):
    if not cpp_core.available():
        pytest.skip("native core not built")
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * np.exp(rng.uniform(-6, 6, n))).astype(np.float32)
    edges = _edge_blocks(subnormal=True)
    x[:min(n, edges.size)] = edges[:n]
    cpp_img = cpp_core.wire_encode("int8", x)
    img = tqc.host_wire_encode(x)
    assert img == cpp_img
    cpp_dec = cpp_core.wire_decode("int8", img, n)
    dec = tqc.host_wire_decode(cpp_img, n)
    assert np.array_equal(_bits(cpp_dec), _bits(dec))


def test_host_wire_image_matches_jax():
    x = _edge_blocks()[:3 * 1024 + 100]
    assert tqc.host_wire_encode(x) == jqc.host_wire_encode(x)
    img = jqc.host_wire_encode(x)
    assert np.array_equal(_bits(tqc.host_wire_decode(img, x.size)),
                          _bits(jqc.host_wire_decode(img, x.size)))


# ------------------------------------------------------- Int8Compressor


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(7,), (33, 31), (5, 7, 13), (2050,)])
def test_int8_compressor_bit_identical_to_jax(shape, dtype):
    x32 = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x32, dtype=dtype)
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    assert np.array_equal(_bits(np.asarray(jx)), _bits(
        tx.view(torch.int16 if tx.element_size() == 2 else torch.int32)
        .numpy()))
    jc, jctx = jax_comp.Compression.int8.compress(jx)
    tc, tctx = tcomp.Compression.int8.compress(tx)
    assert tc.dtype == torch.bfloat16 and tctx == tx.dtype
    assert np.array_equal(_bits(np.asarray(jc)),
                          _bits(tc.view(torch.int16).numpy()))
    jo = jax_comp.Compression.int8.decompress(jc, jctx)
    to = tcomp.Compression.int8.decompress(tc, tctx)
    assert to.dtype == tx.dtype and tuple(to.shape) == shape
    assert np.array_equal(_bits(np.asarray(jo)), _bits(
        to.view(torch.int16 if to.element_size() == 2 else torch.int32)
        .numpy()))


def test_int8_compressor_passes_integers_through():
    ints = torch.arange(12, dtype=torch.int32)
    c, ctx = tcomp.Compression.int8.compress(ints)
    assert ctx is None and c is ints
    assert tcomp.Compression.int8.decompress(c, ctx) is ints


# --------------------------------------------------------------- policy

_ELIGIBILITY = [((256, 64), "float32"), ((256, 63), "float32"),
                ((1 << 20,), "float32"), ((256, 64), "int32"),
                ((2, 2), "float32"), ((128, 128), "bfloat16"),
                ((16, 32, 32), "float16"), ((), "float32")]


@pytest.mark.parametrize("floor", [None, "0", "1024", "1000000"])
def test_int8_eligible_matches_jax(monkeypatch, floor):
    if floor is None:
        monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_INJIT_INT8_FLOOR", floor)
    assert tqc.int8_floor_bytes() == jqc.int8_floor_bytes()
    for shape, dtype in _ELIGIBILITY:
        want = jqc.int8_eligible(shape, jnp.dtype(dtype))
        assert tqc.int8_eligible(shape, getattr(torch, dtype)) == want
        for fb in (0, 64 << 10):
            assert tqc.int8_eligible(shape, getattr(torch, dtype),
                                     floor_bytes=fb) == \
                jqc.int8_eligible(shape, jnp.dtype(dtype), floor_bytes=fb)


def test_constants_match_jax():
    for name in ("BLOCK_ELEMS", "SUB_CHUNK_ELEMS", "MIN_SCALE", "INV_127",
                 "DEFAULT_INT8_FLOOR_BYTES"):
        assert getattr(tqc, name) == getattr(jqc, name), name
    assert tcomp.WIRE_DTYPE_ALIASES == jax_comp.WIRE_DTYPE_ALIASES


_NAMES = ["", "none", "fp32", "FLOAT32", " bf16 ", "bfloat16", "fp16",
          "float16", "int8", "Int8", "int4", "auto", "bogus", None]


@pytest.mark.parametrize("name", _NAMES)
def test_wire_names_and_messages_match_jax(name):
    def outcome(mod):
        try:
            return ("ok", mod.canonical_wire_dtype(name, source="compression"))
        except ValueError as e:
            return ("error", str(e))

    assert outcome(tcomp) == outcome(jax_comp)
    if outcome(jax_comp)[0] == "ok":
        wire = jax_comp.canonical_wire_dtype(name)
        assert tcomp.compressor_for_wire(wire).__name__ == \
            jax_comp.compressor_for_wire(wire).__name__


def test_compressor_for_wire_message_matches_jax():
    with pytest.raises(ValueError) as got:
        tcomp.compressor_for_wire("int4")
    with pytest.raises(ValueError) as want:
        jax_comp.compressor_for_wire("int4")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env", [None, "int8", "bf16", "none", "int4"])
@pytest.mark.parametrize("arg", ["default", "bf16-class", "int8", "none"])
def test_resolve_injit_compression_matches_jax(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("HOROVOD_TPU_INJIT_WIRE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_INJIT_WIRE_DTYPE", env)

    def outcome(qc, comp):
        value = {"default": comp.NoneCompressor,
                 "bf16-class": comp.Compression.bf16}.get(arg, arg)
        try:
            return ("ok", qc.resolve_injit_compression(value).__name__)
        except ValueError as e:
            return ("error", str(e))

    assert outcome(tqc, tcomp) == outcome(jqc, jax_comp)


def test_auto_is_not_ported():
    """The autopilot's ``"auto"`` marker is no static compressor: it
    passes the resolver unchanged, as in the JAX package, and is not
    int8 (so error feedback keeps no residual under it)."""
    assert tqc.resolve_injit_compression("auto") == \
        jqc.resolve_injit_compression("auto") == "auto"
    assert not tqc.is_int8("auto") and not jqc.is_int8("auto")
    assert tqc.is_auto(" AUTO ") and not tqc.is_auto("int8")
    assert tqc.is_int8(tcomp.Compression.int8)
    assert tqc.is_int8(tcomp.Int8Compressor())
    assert not tqc.is_int8(tcomp.Compression.bf16)


_PLAN_SHAPES = [((256, 64), "float32"), ((64,), "float32"),
                ((300, 7), "float32"), ((128, 128), "bfloat16"),
                ((10,), "int32"), ((1000, 1000), "float32"), ((), "float32")]


@pytest.mark.parametrize("compression", ["none", "bf16", "fp16", "int8"])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_estimate_wire_plan_matches_jax(monkeypatch, compression, n):
    monkeypatch.delenv("HOROVOD_TPU_INJIT_WIRE_DTYPE", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    jleaves = [jnp.zeros(s, jnp.dtype(d)) for s, d in _PLAN_SHAPES]
    tleaves = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in
               _PLAN_SHAPES]
    assert tqc.estimate_wire_plan(tleaves, n, compression) == \
        jqc.estimate_wire_plan(jleaves, n, compression)
    for size in (1, 1024, 5000, 1 << 20):
        assert tqc.ring_wire_bytes(size, n) == jqc.ring_wire_bytes(size, n)


# ------------------------------------------------------------- dispatch


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    monkeypatch.setattr(_cuda, "int8_quantize", fail)
    monkeypatch.setattr(_cuda, "int8_dequantize", fail)
    before = dict(_cuda.LAUNCHES)
    tqc.snap_to_grid(torch.randn(3000))
    assert _cuda.LAUNCHES == before


def test_codec_has_no_fallback():
    """No exception handler anywhere on the codec's dispatch path."""
    for fn in (tqc.quantize_blocks, tqc.dequantize_blocks, tqc.snap_to_grid,
               _cuda.int8_quantize, _cuda.int8_dequantize):
        tree = ast.parse(inspect.getsource(fn).strip())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], \
            fn.__name__


def test_codec_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never computes on the CPU: it raises before it
    builds anything."""
    grid = torch.zeros((2, 1024))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.int8_quantize(grid)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.int8_dequantize(torch.zeros((2, 1024), dtype=torch.int8),
                              torch.ones((2, 1)))
    with pytest.raises(ValueError, match=r"\(blocks, 1024\)"):
        _cuda.int8_quantize(torch.zeros((2, 512)))
    assert set(_cuda.LAUNCHES) >= {"int8_quantize", "int8_dequantize"}
    assert "htt_int8_quantize" in _cuda._ARGTYPES
    assert "htt_int8_dequantize" in _cuda._ARGTYPES


def test_kernel_source_keeps_exact_rounding():
    """The CUDA source pins every rounding the bit-exactness needs, and the
    build has no fast-math flag."""
    src = (_cuda.CSRC / "int8_codec.cu").read_text()
    for token in ("__fmul_rn", "__fdiv_rn", "__float2int_rn",
                  "1.0f / 127.0f", "1.17549435e-38f"):
        assert token in src, token
    assert not any("fast" in f for f in _cuda.NVCC_FLAGS)
