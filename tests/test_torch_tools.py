"""The port's kernel tools (``horovod_tpu_torch/tools``) on the CPU, held
against the JAX tools (``tools/devtime.py``, ``tools/tsweep.py``,
``tools/step_profile.py``) in this process.

* ``devtime``: the same spec grammar (the JAX tool's ``main`` run on the
  same specs with its benches stubbed records what it parsed) and the
  same programs: REPS chained forwards, and REPS chained forward +
  backward passes whose dq feeds the next q, at a small shape in f32 (the
  JAX side in Pallas interpret mode, the port's on its plain versions),
  within 2e-5.
* ``tsweep``: the same header and row forms (the JAX tool's own lines,
  its timing stubbed), and the same timed program for flash and for
  ``full_attention``, within 2e-5.
* ``step_profile``: its rows are the device events of a trace that
  ``profiling.capture`` wrote on the CPU, grouped by kernel stem, a step
  each, annotation ranges never counted; its parameter fill is
  ``bench.synth_variables``' rule.
* ``tools.device_ms``, which ``devtime`` and ``tsweep`` time with: the
  kernels' own time a rep on the same trace, the span beside it.
* A tool asked for the card on a machine without one raises.

The JAX programs run with REPS = 2 (patched into the tool's module);
knobs through ``monkeypatch``.
"""

import functools
import gzip
import json
import runpy
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch import profiling
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.ring_attention import full_attention
from horovod_tpu_torch.tools import devtime, require_device, step_profile
from horovod_tpu_torch.tools import tsweep

SMALL = dict(b=1, t=64, h=2, d=16)   # f32, blocks of 16
REPS = 2
TOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """The JAX tool's namespace, its flash in interpret mode and its REPS
    cut to ``REPS``; returns (namespace, module globals)."""
    from horovod_tpu.ops.flash_attention import flash_attention as jflash
    ns = runpy.run_path(f"tools/{name}.py", run_name=f"jax_{name}")
    g = ns["main"].__globals__
    g["REPS"] = REPS
    g["flash_attention"] = functools.partial(jflash, interpret=True)
    return ns, g


def _inputs():
    q, k, v, do = devtime.inputs("cpu", SMALL["b"], SMALL["t"], SMALL["h"],
                                 SMALL["d"], dtype=torch.float32, seed=3)
    return (q, k, v, do), [x.numpy() for x in (q, k, v, do)]


def test_devtime_parses_the_jax_tools_specs(monkeypatch, capsys):
    ns, g = _jax_tool("devtime")
    seen = []
    g["bench_fwd"] = lambda bq, bk, *a: seen.append(("fwd", bq, bk, None)) \
        or 1.0
    g["bench_bwd"] = lambda bq, bk, impl, *a: seen.append(
        ("bwd", bq, bk, impl)) or 1.0
    g["B"], g["T"], g["H"], g["D"] = 1, 8, 1, 8
    specs = ["fwd,128,128", "fwd,64,256", "bwd,128,128,pallas_split",
             "bwd,256,512,pallas_fused", "bwd,128,128,xla"]
    monkeypatch.setattr(sys, "argv", ["x"] + specs)
    ns["main"]()
    jax_lines = capsys.readouterr().out.splitlines()
    assert [devtime.parse_spec(s) for s in specs] == seen
    assert (devtime.B, devtime.T, devtime.H, devtime.D, devtime.REPS) == (
        8, 2048, 16, 128, 16)
    # The port's line keeps the JAX tool's form, launches beside it.
    r = {"kind": "fwd", "bq": 128, "bk": 128, "impl": None, "ms": 1.0,
         "span_ms": 1.1, "launches": {"flash_fwd": 1.0}}
    assert devtime.line(r).startswith(jax_lines[0].split(":")[0] + ":")
    r = dict(r, kind="bwd", impl="pallas_split")
    assert devtime.line(r).startswith(jax_lines[2].split(":")[0] + ":")


def test_devtime_fwd_program_is_the_jax_tools(hvd):
    import jax.numpy as jnp
    ns, g = _jax_tool("devtime")
    g["device_ms"] = lambda make_scan, *args: np.asarray(make_scan(*args))
    (q, k, v, _), arrays = _inputs()
    want = ns["bench_fwd"](16, 16, *(jnp.asarray(a) for a in arrays[:3]))
    got = devtime.fwd_program(q, k, v, 16, 16, reps=REPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["pallas_split", "pallas_fused"])
def test_devtime_bwd_program_is_the_jax_tools(hvd, impl):
    import jax.numpy as jnp
    ns, g = _jax_tool("devtime")
    g["device_ms"] = lambda make_scan, *args: np.asarray(make_scan(*args))
    (q, k, v, do), arrays = _inputs()
    want = ns["bench_bwd"](16, 16, impl, *(jnp.asarray(a) for a in arrays))
    got = devtime.bwd_program(q, k, v, do, 16, 16, impl, reps=REPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_devtime_prints_the_entry_points_refusal(capsys):
    (q, k, v, do), _ = _inputs()
    with pytest.raises(ValueError, match="block_q=12 must divide T=64"):
        devtime.measure("fwd,12,16", q, k, v, do)
    r = devtime.measure("bwd,16,16,pallas_split", q, k, v, do)
    # The CPU records no device events: nothing is timed there.
    assert r["ms"] is None and r["launches"] == {}
    assert "not measured" in devtime.line(r)


def test_tsweep_header_and_rows_are_the_jax_tools(monkeypatch, capsys):
    ns, g = _jax_tool("tsweep")
    g["grad_step"] = lambda fn: fn
    g["temp_gb"] = lambda jfn, *a: 3.0

    def device_ms(jfn, *args):
        if jfn.func.__name__ == "full_attention":
            raise MemoryError("RESOURCE_EXHAUSTED: out of memory")
        return 2.0
    g["device_ms"] = device_ms
    monkeypatch.setattr(sys, "argv", ["x", "16"])
    ns["main"]()
    lines = capsys.readouterr().out.splitlines()
    assert tuple(lines[:2]) == tsweep.HEADER
    assert lines[2] == tsweep.row(16, "flash", {"ms": 2.0,
                                                "peak_bytes": 3e9})
    assert lines[3] == tsweep.row(16, "full", {
        "error": "MemoryError: RESOURCE_EXHAUSTED: out of memory"})
    assert (tsweep.B, tsweep.H, tsweep.D, tsweep.REPS) == (1, 16, 128, 8)


def test_tsweep_row_notes_a_span_beyond_the_kernels():
    """The device ms is the kernels' own; a span more than
    ``tsweep.SPAN_NOTE`` above it (the card waiting on the host) stands
    beside it, and tokens/s follow the kernels' time."""
    r = {"ms": 0.35, "span_ms": 1.49, "peak_bytes": 7e7}
    assert tsweep.row(2048, "flash", r) == (
        "| 2048 | flash | 0.35 (span 1.49) | 5,851,429 | 0.07 |")
    assert tsweep.row(2048, "flash", dict(r, span_ms=0.36)) == (
        "| 2048 | flash | 0.35 | 5,851,429 | 0.07 |")


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_tsweep_program_is_the_jax_tools(hvd, impl):
    import jax.numpy as jnp
    from horovod_tpu.parallel.ring_attention import full_attention as jfull
    ns, g = _jax_tool("tsweep")
    jfn = (g["flash_attention"] if impl == "flash" else jfull)
    many = ns["grad_step"](functools.partial(jfn, causal=True))
    (q, k, v, do), arrays = _inputs()
    want = np.asarray(many(*(jnp.asarray(a) for a in arrays)))
    fn = dict(tsweep.IMPLS)[impl]
    got = tsweep.grad_program(fn, q, k, v, do, reps=REPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert dict(tsweep.IMPLS)["flash"].func is flash_attention
    assert dict(tsweep.IMPLS)["full"].func is full_attention


def _trace_with_kernels(tmp_path):
    """A trace that ``profiling.capture`` wrote on the CPU, with the device
    events of two steps added as a CUDA run records them: kernels, a copy,
    and the annotation ranges around them."""
    a = torch.randn(32, 32)
    log_dir = profiling.capture(lambda: a @ a, warmup=0, iters=2,
                                log_dir=str(tmp_path))
    path = profiling._latest_trace_file(log_dir)
    with gzip.open(path) as fh:
        trace = json.load(fh)
    ts = 1000.0
    for _ in range(2):
        for name, cat, dur in (
                ("void flash_fwd_kernel<128>(FlashParams)", "kernel", 30.0),
                ("void flash_fwd_kernel<128>(FlashParams)", "kernel", 30.0),
                ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", "kernel",
                 100.0),
                ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 10.0),
                ("nccl:all_reduce", "gpu_user_annotation", 500.0),
                ("Optimizer.step#SGD.step", "gpu_user_annotation", 500.0)):
            trace["traceEvents"].append({"ph": "X", "cat": cat,
                                         "name": name, "ts": ts,
                                         "dur": dur, "pid": 0, "tid": 7})
            ts += dur
        ts += 40.0
    with gzip.open(path, "wt") as fh:
        json.dump(trace, fh)
    return log_dir


def test_step_profile_aggregates_device_events_by_stem(tmp_path):
    rows, total, span = step_profile.aggregate(_trace_with_kernels(tmp_path))
    assert [(n, round(ms, 6), c) for n, ms, c in rows] == [
        ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", 0.1, 1),
        ("flash_fwd_kernel", 0.06, 2),
        ("Memcpy DtoD", 0.01, 1)]
    assert total == pytest.approx(0.17)
    # The span of both steps' device events (annotations left out): from
    # the first kernel at 1000 us to the second step's copy ending at
    # 2380 us, a step.
    assert span == pytest.approx((2380.0 - 1000.0) / 2 / 1e3)


def test_device_ms_is_the_kernels_time_beside_the_span(tmp_path,
                                                      monkeypatch):
    """``tools.device_ms`` on a captured trace of 2 reps: the kernels' and
    copies' time a rep (``profiling.kernel_table``'s sum), then the span
    of the device events a rep, which adds the gaps between them."""
    import horovod_tpu_torch.tools as tools
    _trace_with_kernels(tmp_path)
    monkeypatch.setattr(profiling, "capture",
                        lambda run, *, warmup, iters, log_dir: str(tmp_path))
    ms, span, passes = tools.device_ms(lambda: None, 2, torch.device("cpu"))
    assert passes == 1
    assert ms == pytest.approx(0.17)
    assert span == pytest.approx((2380.0 - 1000.0) / 2 / 1e3)


def test_step_profile_prints_the_top_rows(tmp_path, capsys):
    log_dir = _trace_with_kernels(tmp_path)
    calls = []

    def capture(run, *, warmup, iters, log_dir):
        calls.append(iters)
        return str(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "capture", capture)
        out = step_profile.profile_and_dump(lambda: None, "toy", topn=2)
    lines = capsys.readouterr().out.splitlines()
    assert calls == [step_profile.STEPS] and log_dir
    assert lines[0] == "== toy: step 0.69 ms, kernels total 0.17 ms =="
    assert lines[1] == "    0.100 ms  x   1  " \
                       "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT"
    assert lines[2] == "    0.060 ms  x   2  flash_fwd_kernel"
    assert len(lines) == 3 and out["kernel_ms"] == pytest.approx(0.17)


def test_step_profile_fills_parameters_as_bench_does():
    from horovod_tpu_torch.models import ResNet, TransformerLM
    lm = TransformerLM(vocab=64, dim=32, depth=1, num_heads=2, max_len=8,
                       device="cpu")
    net = ResNet(stage_sizes=[1], num_filters=8, num_classes=10,
                 device="cpu")
    for model in (lm, net):
        step_profile.synth_parameters(model, seed=1)
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if "scale" in name or "var" in name:
                assert torch.all(t == 1), name
            elif "bias" in name or "mean" in name:
                assert torch.all(t == 0), name
            elif t.numel() > 500:
                assert 0.015 < float(t.detach().std()) < 0.025, name


def test_the_bench_knobs_are_the_jax_tools():
    src = open("tools/step_profile.py").read()
    mine = open(step_profile.__file__).read()
    for knob in ("BENCH_TLM_ATTN", "BENCH_TLM_LN_DTYPE",
                 "BENCH_TLM_FUSED_XENT"):
        assert knob in src and knob in mine
    for width in ("dim, depth, heads, vocab, seq, bpc = 2048, 12, 16, "
                  "32768, 2048, 8", "bpc, size = 128, 224"):
        assert width in src and width in mine


def test_a_tool_asked_for_the_card_without_one_raises():
    assert require_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert require_device("cuda") == torch.device("cuda")
        return
    for main in (devtime.main, tsweep.main, step_profile.main):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            main([])
