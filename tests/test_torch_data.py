"""The port's input pipeline against the JAX package's.

``epoch_batches`` gives the JAX package's rows, row for row (numpy in,
numpy out; tensors in, tensors out), for several world sizes, with and
without the epoch shuffle, including sizes that do not divide the data.
``ShardedLoader`` yields the batches of its source in order on the given
device, stacked ``steps_per_call`` deep with a trailing partial group
dropped -- the same values the JAX package's loader puts on a one-device
mesh.  No tolerance: rows are copied, never computed.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import horovod_tpu_torch as hvd
from horovod_tpu import data as jdata
from horovod_tpu_torch import data as tdata


def _arrays(n=23):
    rng = np.random.RandomState(4)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("size", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [None, 7])
def test_epoch_batches_row_for_row(size, seed):
    x, y = _arrays()
    for rank in range(size):
        want = list(jdata.epoch_batches(x, y, 2, rank=rank, size=size,
                                        seed=seed))
        got = list(tdata.epoch_batches(x, y, 2, rank=rank, size=size,
                                       seed=seed))
        tgot = list(tdata.epoch_batches(torch.from_numpy(x),
                                        torch.from_numpy(y), 2, rank=rank,
                                        size=size, seed=seed))
        assert len(got) == len(tgot) == len(want) == (23 // size) // 2
        for (a, b), (ta, tb), (wa, wb) in zip(got, tgot, want):
            np.testing.assert_array_equal(a, wa)
            np.testing.assert_array_equal(b, wb)
            np.testing.assert_array_equal(ta.numpy(), wa)
            np.testing.assert_array_equal(tb.numpy(), wb)


def _batches(k=7):
    x, y = _arrays(4 * k)
    return [{"x": x[4 * i:4 * i + 4], "y": y[4 * i:4 * i + 4]}
            for i in range(k)]


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_sharded_loader_matches_the_jax_loader(steps_per_call):
    src = _batches()
    mesh = Mesh(np.array(jax.devices()[:1]), ("ranks",))
    want = list(jdata.ShardedLoader(lambda: iter(src), mesh,
                                    steps_per_call=steps_per_call))
    loader = tdata.ShardedLoader(lambda: iter(src), "cpu",
                                 steps_per_call=steps_per_call)
    for _ in range(2):               # a factory re-iterates
        got = list(loader)
        assert len(got) == len(want) == 7 // steps_per_call
        for g, w in zip(got, want):
            for k in ("x", "y"):
                assert isinstance(g[k], torch.Tensor)
                assert g[k].device.type == "cpu"
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(w[k]))


def test_sharded_loader_of_a_plain_iterable_is_single_use():
    loader = tdata.ShardedLoader(iter(_batches(2)), "cpu", prefetch=1)
    assert len(list(loader)) == 2
    with pytest.raises(RuntimeError, match="single-use"):
        list(loader)


def test_sharded_loader_raises_what_the_source_raises():
    def source():
        yield _batches(1)[0]
        raise KeyError("bad record")

    got = []
    with pytest.raises(KeyError, match="bad record"):
        for b in tdata.ShardedLoader(source, "cpu"):
            got.append(b)
    assert len(got) == 1


@pytest.mark.parametrize("kw", [dict(steps_per_call=0), dict(prefetch=0)])
def test_sharded_loader_refuses_bad_arguments(kw):
    with pytest.raises(ValueError, match=">= 1"):
        tdata.ShardedLoader([], "cpu", **kw)


def test_loader_defaults_to_the_device_of_init(monkeypatch):
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        out = next(iter(hvd.ShardedLoader(_batches(1))))
        assert out["x"].device == torch.device("cpu")
        one = tdata.shard_for_process({"x": np.ones(3)})
        assert torch.equal(one["x"], torch.ones(3, dtype=torch.float64))
    finally:
        hvd.shutdown()
