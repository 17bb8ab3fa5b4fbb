"""The port's multi-rank example twins on the CPU, and the top-level
names.

One 4-rank gloo group (``_torch_injit_worker.examples_worker``, spawned
once per session) runs ``pod_training``, ``model_parallel`` and
``pipeline_transformer`` at the arguments of their JAX examples' tests
(``tests/test_examples.py:53-82``), which must meet the same bars, and
``long_context`` (which has no JAX test) in each ``--attn`` mode at a
small size: finite losses and its tokens/sec line.  Each twin has its
JAX example's flags, and its data are the JAX example's: captured from
the JAX example itself (run with its training step stubbed out) and held
against the twin's, bit for bit (``model_parallel``'s targets ``tanh(X @
W)`` to 1e-6: XLA's CPU ``tanh`` is its own approximation).  Every name
that ``horovod_tpu/__init__.py`` imports, except ``jax``, exists on
``horovod_tpu_torch``.
"""

import ast
import inspect
import re
import runpy
import sys

import numpy as np
import pytest

import horovod_tpu_torch
from _torch_injit_worker import examples_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu_torch.examples import (long_context, model_parallel,
                                        pipeline_transformer, pod_training)

N = 4
ATTNS = ("ring", "ring_zigzag", "ulysses", "ulysses_flash")
RUNS = (
    ("pod_training", ("--steps", "60")),
    ("model_parallel", ("--steps", "30", "--batch-size", "8", "--dim", "16",
                        "--hidden-per-chip", "8")),
    ("pipeline_transformer", ("--steps", "25", "--dim", "16", "--heads",
                              "2", "--seq-len", "8")),
) + tuple(("long_context", ("--attn", attn, "--seq-len", "32", "--vocab",
                            "64", "--dim", "32", "--depth", "2", "--heads",
                            "4", "--steps", "3")) for attn in ATTNS)
TWINS = {"pod_training": pod_training, "model_parallel": model_parallel,
         "pipeline_transformer": pipeline_transformer,
         "long_context": long_context}


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """{rank: [(result, stdout) of each of RUNS]}."""
    return once(request, tmp_path_factory, "examples_parallel",
                lambda: run_group(examples_worker, N, RUNS, timeout=300))


def _run(runs, name, attn=None):
    for i, (n, argv) in enumerate(RUNS):
        if n == name and (attn is None or attn in argv):
            return runs[0][i]
    raise KeyError(name)


def test_pod_training_meets_its_bar(runs):
    (loss0, final), out = _run(runs, "pod_training")
    assert final < 0.05 * loss0, (loss0, final)
    assert f"pod: {N} process(es), {N} ranks" in out
    assert f"final loss {final:.6f} (from {loss0:.6f})" in out
    for r in range(1, N):
        assert runs[r][0][0] == (loss0, final)
        assert runs[r][0][1] == ""          # rank 0 prints


def test_model_parallel_meets_its_bar(runs):
    losses, out = _run(runs, "model_parallel")
    assert len(losses) == 30
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert "col kernel: global (16, 16), sharded (None, 'tp') over mesh " \
           "{'dp': 2, 'tp': 2}, (16, 8) on each rank" in out
    for r in range(1, N):
        assert runs[r][1][0] == losses


def test_pipeline_transformer_meets_its_bar(runs):
    losses, out = _run(runs, "pipeline_transformer")
    assert len(losses) == 25
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert f"pipeline stages={N} microbatches={2 * N} loss " in out
    for r in range(1, N):
        assert runs[r][2][0] == losses


@pytest.mark.parametrize("attn", ATTNS)
def test_long_context_runs_every_attention_mode(runs, attn):
    losses, out = _run(runs, "long_context", attn)
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert f"step 0: loss={losses[0]:.4f}" in out
    assert re.search(rf"^{attn} attention, seq 32 over {N} ranks: \d+ "
                     r"tokens/sec$", out, re.M), out


def test_long_context_modes_agree_on_the_first_loss(runs):
    """The four modes compute one function of the same tokens (zigzag's
    permuted with their labels): the first losses agree to bf16
    rounding."""
    first = [_run(runs, "long_context", a)[0][0] for a in ATTNS]
    np.testing.assert_allclose(first, first[0], rtol=1e-3)


def _flags(src):
    """{flag: its default's source text (None without one)}."""
    out = {}
    for m in re.finditer(r'add_argument\("(--[a-z-]+)"([^)]*)\)', src):
        d = re.search(r"default=([^,\s)]+)", m.group(2))
        out[m.group(1)] = d.group(1) if d else None
    return out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_has_the_jax_flags(name):
    """The same flags with the same defaults as the JAX example."""
    want = _flags(open(f"examples/jax_{name}.py").read())
    assert want and _flags(inspect.getsource(TWINS[name])) == want


class _Stop(Exception):
    pass


def _capture_pod(monkeypatch):
    import horovod_tpu.data
    import horovod_tpu.jax.spmd
    got = {}

    def shard(batch, mesh):
        got["batch"] = [np.asarray(a) for a in batch]
        raise _Stop
    monkeypatch.setattr(horovod_tpu.jax.spmd, "make_train_step",
                        lambda *a, **k: None)
    monkeypatch.setattr(horovod_tpu.data, "shard_for_process", shard)
    monkeypatch.setattr(sys, "argv", ["x"])
    with pytest.raises(_Stop):
        runpy.run_path("examples/jax_pod_training.py")["main"]()
    return got["batch"]


def _capture_jit_args(monkeypatch, path, argv):
    """The arguments of the first call of a function that the JAX example
    compiles with ``jax.jit``, and the arrays it ``device_put``s before."""
    import jax
    put, got = [], {}

    def device_put(x, *a, **k):
        put.append(np.asarray(x))
        return x

    def jit(fn, *a, **k):
        def call(*args):
            got["args"] = [np.asarray(x) for x in args]
            raise _Stop
        return call
    monkeypatch.setattr(jax, "device_put", device_put)
    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    with pytest.raises(_Stop):
        runpy.run_path(path)["main"]()
    return put, got["args"]


def test_pod_training_data_is_the_jax_examples(hvd, monkeypatch):
    want = _capture_pod(monkeypatch)
    got = pod_training.make_data(32, hvd.size())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_model_parallel_data_is_the_jax_examples(hvd, monkeypatch):
    put, _ = _capture_jit_args(monkeypatch, "examples/jax_model_parallel.py",
                               ["--batch-size", "8", "--dim", "16"])
    x, y = model_parallel.make_data(8, 2, 16)
    np.testing.assert_array_equal(x, put[0])
    assert y.dtype == put[1].dtype
    np.testing.assert_allclose(y, put[1], rtol=0, atol=1e-6)


def test_pipeline_transformer_data_is_the_jax_examples(hvd, monkeypatch):
    _, (x, y) = _capture_jit_args(
        monkeypatch, "examples/jax_pipeline_transformer.py",
        ["--seq-len", "8", "--vocab", "50"])
    gx, gy = pipeline_transformer.make_data(50, 2 * 2 * hvd.size(), 8)
    for g, w in ((gx, x), (gy, y)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("attn", ("ring", "ring_zigzag"))
def test_long_context_data_is_the_jax_examples(hvd, monkeypatch, attn):
    import horovod_tpu.jax.spmd
    import jax
    put = []

    def device_put(x, *a, **k):
        if isinstance(x, np.ndarray) and x.dtype == np.int32:
            put.append(x.copy())
        return x

    def make_train_step(*a, **k):
        return lambda params, aux, opt_state, batch: (
            params, aux, opt_state, np.float32(0))
    monkeypatch.setattr(horovod_tpu.jax.spmd, "make_train_step",
                        make_train_step)
    monkeypatch.setattr(jax, "device_put", device_put)
    argv = ["--attn", attn, "--seq-len", "32", "--vocab", "64", "--dim",
            "16", "--depth", "1", "--heads", "2", "--steps", "3",
            "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    runpy.run_path("examples/jax_long_context.py")["main"]()
    args = type("Args", (), dict(attn=attn, seq_len=32, vocab=64, steps=3,
                                 batch_size=2))
    got = [a for step in long_context.batches(args, hvd.size())
           for a in step]
    assert len(got) == len(put) == 6
    for g, w in zip(got, put):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _reference_names():
    tree = ast.parse(open("horovod_tpu/__init__.py").read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    # Private names are the module's own compatibility shims, deleted
    # after use.
    return sorted(n for n in names if not n.startswith("_") and n != "jax")


def test_every_top_level_name_of_the_reference_exists():
    names = _reference_names()
    assert {"devices", "local_devices", "ranks_mesh", "injit", "SUM",
            "AVERAGE", "MIN", "MAX"} <= set(names)
    missing = [n for n in names if not hasattr(horovod_tpu_torch, n)]
    assert not missing, missing
    from horovod_tpu.ops import injit as jinjit
    for op in ("SUM", "AVERAGE", "MIN", "MAX"):
        assert getattr(horovod_tpu_torch, op) == getattr(jinjit, op)
