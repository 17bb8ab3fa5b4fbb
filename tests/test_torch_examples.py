"""The port's example twins (``horovod_tpu_torch/examples``) on the CPU.

``mnist`` is the twin of ``examples/jax_mnist.py``: one epoch at batch 16
on its synthetic data must reach a test accuracy above 0.9, as the JAX
example's test (``tests/test_examples.py:16``) asks of two epochs at 64;
the JAX example runs beside it on the same data and passes the same bar.
``synthetic_benchmark`` is the twin of ``examples/jax_synthetic_benchmark.py``
with the same flags; one iteration at 32 x 32 prints its throughput
lines.  Both run in this process at size 1, initialised with
``device="cpu"`` and shut down after.
"""

import runpy

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import mnist, synthetic_benchmark


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: the test runner's workers
    share the cores, and these small ops lose more to threads waiting on
    each other than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def size1(monkeypatch):
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "TIMELINE", "FUSION_THRESHOLD", "FAULT"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    yield
    hvd.shutdown()


def test_mnist_twin_learns_the_synthetic_data(size1, capsys):
    acc = mnist.main(["--epochs", "1", "--batch-size", "16"], device="cpu")
    out = capsys.readouterr().out
    assert acc > 0.9, out
    assert "epoch 0: loss=" in out and "test accuracy:" in out
    assert hvd.size() == 1


def test_mnist_twin_uses_the_jax_examples_data():
    """The same synthetic stand-in as the JAX example (no file given)."""
    jax_example = runpy.run_path("examples/jax_mnist.py",
                                 run_name="jax_mnist")
    for got, want in zip(mnist.load_data(""), jax_example["load_data"]("")):
        np.testing.assert_array_equal(got, want)


def test_synthetic_benchmark_twin_prints_throughput(size1, capsys):
    img_secs = synthetic_benchmark.main(
        ["--batch-size", "2", "--image-size", "32", "--num-iters", "1",
         "--num-warmup-batches", "1", "--num-batches-per-iter", "1"],
        device="cpu")
    out = capsys.readouterr().out
    assert len(img_secs) == 1 and img_secs[0] > 0
    assert "Model: resnet50, batch size (per rank): 2, ranks: 1" in out
    assert "Iter #0:" in out and "Img/sec per rank:" in out
    assert "Total img/sec on 1 rank(s):" in out


def test_synthetic_benchmark_twin_has_the_jax_flags():
    """Same models and flags as the JAX example, nothing more."""
    import inspect
    import re
    src = open("examples/jax_synthetic_benchmark.py").read()
    flags = set(re.findall(r'add_argument\("(--[a-z-]+)"', src))
    twin = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                          inspect.getsource(synthetic_benchmark)))
    assert flags == twin
    assert sorted(synthetic_benchmark.MODELS) == ["resnet101", "resnet152",
                                                  "resnet50"]


def test_mnist_twin_has_the_jax_flags():
    import inspect
    import re
    src = open("examples/jax_mnist.py").read()
    flags = set(re.findall(r'add_argument\("(--[a-z-]+)"', src))
    twin = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                          inspect.getsource(mnist)))
    assert flags == twin
