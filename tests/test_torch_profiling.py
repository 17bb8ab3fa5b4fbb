"""The port's device profiler (``horovod_tpu_torch.profiling``) on a
fabricated trace in Kineto's shape, and on the CPU.

The trace holds what ``torch.profiler`` exports on the GPU: CPU ops
(``cat`` cpu_op) with ``External id``, ``flops`` and recorded input
shapes; the kernels they launch (``cat`` kernel) with the same
``External id`` and a ``correlation``; a host-to-device copy
(``gpu_memcpy``), a memset, and the annotation ranges that span kernels
(``gpu_user_annotation`` ``nccl:all_reduce`` and
``Optimizer.step#SGD.step``), which must never be counted.  The row keys
are held against the JAX package's ``per_op_rooflines``.
"""

import gzip
import json
import os

import pytest
import torch

from horovod_tpu import profiling as jax_profiling
from horovod_tpu_torch import profiling
from test_profiling import make_events, write_trace

GEMM = ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_"
        "bf16_64x64_64x4_tn_align8>(Params)")
ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::CUDAFunctor_add<float>, std::array<char*, 3> >"
               "(int, at::native::CUDAFunctor_add<float>, "
               "std::array<char*, 3>)")


def _op(name, ext, ts, dur, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": dict({"External id": ext}, **args)}


def _dev(cat, name, ext, corr, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur,
            "args": {"External id": ext, "correlation": corr, "device": 0,
                     "stream": 7}}


def kineto_events():
    """Two steps' worth: each a bf16 mm (1e9 FLOPs, 1 ms, inputs 2 x
    (1024, 512) bf16 = 2 MiB) and an add (no FLOPs, 0.5 ms); one copy and
    one memset; the annotations span everything."""
    ev = [{"ph": "M", "pid": 0, "name": "process_name",
           "args": {"name": "python"}}]
    mm_args = {"flops": 1_000_000_000, "Input Dims": [[1024, 512],
                                                      [512, 1024]],
               "Input type": ["c10::BFloat16", "c10::BFloat16"]}
    for step, t0 in enumerate((1000.0, 5000.0)):
        mm, add = 10 + 2 * step, 11 + 2 * step
        ev += [_op("aten::mm", mm, t0, 50.0, **mm_args),
               _op("aten::add", add, t0 + 60, 20.0,
                   **{"Input Dims": [[256], [256]],
                      "Input type": ["float", "float"]}),
               _dev("kernel", GEMM, mm, 100 + mm, t0 + 100, 1000.0),
               _dev("kernel", ELEMENTWISE, add, 100 + add, t0 + 1200, 500.0)]
    ev += [
        _dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 50, 900.0,
             50.0),
        _dev("gpu_memset", "Memset (Device)", 6, 51, 6800.0, 10.0),
        # Annotations on the device span the kernels: never counted.
        _dev("gpu_user_annotation", "nccl:all_reduce", 0, 0, 500.0, 7000.0),
        _dev("gpu_user_annotation", "Optimizer.step#SGD.step", 0, 0, 900.0,
             6000.0),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 1010.0, "dur": 5.0,
         "args": {"External id": 10, "correlation": 110}},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 110, "pid": 1,
         "tid": 1, "ts": 1010.0},
    ]
    return ev


def write_kineto(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return str(tmp_path)


def test_device_time_is_the_span_of_device_events(tmp_path):
    """First device event's start (the copy at 900) to the last one's end
    (the memset at 6810): 5.91 ms, 2.955 ms a step; the annotations,
    which start earlier and end later, are not device work."""
    d = write_kineto(tmp_path, kineto_events())
    assert profiling.device_time_ms(d) == pytest.approx(5.91)
    assert profiling.device_time_ms(d, per=2) == pytest.approx(2.955)


def test_device_time_none_without_device_events(tmp_path):
    host_only = [e for e in kineto_events() if e.get("pid") != 0]
    assert profiling.device_time_ms(write_kineto(tmp_path, host_only)) is None


def test_annotations_are_not_device_events():
    names = {e["name"] for e in profiling.device_events(kineto_events())}
    assert "nccl:all_reduce" not in names
    assert "Optimizer.step#SGD.step" not in names
    assert len(names) == 4


def test_rooflines_join_flops_and_bytes_through_the_external_id(tmp_path):
    d = write_kineto(tmp_path, kineto_events())
    rows = profiling.per_op_rooflines(d, peak_flops=2e12, peak_bytes=4e9)
    by_op = {r["op"]: r for r in rows}
    gemm = by_op["cutlass::Kernel2"]
    assert gemm["source"] == "aten::mm" and gemm["count"] == 2
    assert gemm["ms"] == 2.0
    # 2e9 FLOPs in 2 ms = 1 TFLOP/s, 50% of the 2e12 peak.
    assert gemm["tflops_per_sec"] == 1.0
    assert gemm["pct_of_peak_flops"] == 50.0
    # 2 x 2 MiB of inputs in 2 ms = 2.097 GB/s, 52.4% of 4e9.
    assert gemm["gbytes_per_sec"] == 2.1
    assert gemm["pct_of_peak_bw"] == 52.4
    add = by_op["at::native::vectorized_elementwise_kernel"]
    assert add["source"] == "aten::add" and add["ms"] == 1.0
    assert add["tflops_per_sec"] == 0.0 and add["gbytes_per_sec"] == 0.0
    # Sorted by time; copies are rows; annotations are not.
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)
    assert "Memcpy HtoD" in by_op and "Memset" in by_op
    assert not any(r["op"].startswith(("nccl", "Optimizer")) for r in rows)


def test_row_keys_are_the_references(tmp_path):
    ref = jax_profiling.per_op_rooflines(
        write_trace(tmp_path / "jax", make_events()))
    rows = profiling.per_op_rooflines(write_kineto(tmp_path / "torch",
                                                   kineto_events()))
    assert ref and rows
    assert all(list(r) == list(ref[0]) for r in rows)


def test_defaults_are_the_h100_peaks():
    import inspect
    sig = inspect.signature(profiling.per_op_rooflines)
    assert sig.parameters["peak_flops"].default == 989e12
    assert sig.parameters["peak_bytes"].default == 3.35e12


@pytest.mark.parametrize("name,stem", [
    (GEMM, "cutlass::Kernel2"),
    (ELEMENTWISE, "at::native::vectorized_elementwise_kernel"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN",
     "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN"),
    ("flash_fwd_kernel<128>", "flash_fwd_kernel")])
def test_kernel_stem(name, stem):
    assert profiling.kernel_stem(name) == stem


def test_capture_on_the_cpu_degrades_gracefully(tmp_path):
    """On the CPU: a gzipped trace in the reference's layout with the
    ops' FLOPs written in, no device time and no rows."""
    a, b = torch.randn(64, 128), torch.randn(128, 256)
    log_dir = profiling.capture(lambda: torch.mm(a, b), iters=1,
                                log_dir=str(tmp_path))
    assert log_dir == str(tmp_path) and os.path.isdir(log_dir)
    path = profiling._latest_trace_file(log_dir)
    assert path.endswith(".trace.json.gz")
    assert jax_profiling.load_trace_events(log_dir) == \
        profiling.load_trace_events(log_dir)
    mm = [e for e in profiling.load_trace_events(log_dir)
          if e.get("name") == "aten::mm"]
    assert mm and mm[0]["args"]["flops"] == 2 * 64 * 128 * 256
    assert profiling.device_time_ms(log_dir) is None
    assert profiling.per_op_rooflines(log_dir) == []


def test_print_rooflines_one_line_a_row(tmp_path, capsys):
    rows = profiling.per_op_rooflines(write_kineto(tmp_path,
                                                   kineto_events()))
    profiling.print_rooflines(rows, top=3)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[1].endswith(
        "cutlass::Kernel2 @ aten::mm")
