"""The port's sparse gradients (``horovod_tpu_torch.sparse``) against the
JAX package's (``horovod_tpu.sparse``), in one process.

``IndexedSlices.from_sparse`` of an ``nn.Embedding(sparse=True)`` gradient
(repeated ids, so duplicate indices) gives the rows and indices that
``horovod_tpu.sparse.IndexedSlices`` is built from; ``to_dense`` and
``apply_indexed_slices`` sum duplicates as the JAX package does, bit for
bit (tolerance: none; both add the duplicates of a row in index order).
The two-rank routes run in ``test_torch_eager_optimizer.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import sparse as jsparse
from horovod_tpu_torch import sparse

IDS = [[4, 1, 4, 9], [4, 0, 4, 9]]       # row 4 four times, row 9 twice


def _slices(seed=0):
    """An Embedding(12, 5, sparse=True) gradient with duplicate ids and
    non-integer rows, f32."""
    torch.manual_seed(seed)
    emb = torch.nn.Embedding(12, 5, sparse=True)
    w = torch.randn(2, 4, 5)
    (emb(torch.tensor(IDS)) * w).sum().backward()
    return sparse.IndexedSlices.from_sparse(emb.weight.grad)


def _jax(s):
    return jsparse.IndexedSlices(jnp.asarray(s.values.numpy()),
                                 jnp.asarray(s.indices.numpy()),
                                 s.dense_shape)


def test_from_sparse_keeps_every_row():
    s = _slices()
    assert s.dense_shape == (12, 5)
    assert s.values.shape == (8, 5) and s.indices.dtype == torch.int64
    assert sorted(s.indices.tolist()) == sorted(sum(IDS, []))


@pytest.mark.parametrize("seed", [0, 3])
def test_to_dense_sums_duplicates_as_jax(seed):
    s = _slices(seed=seed)
    got = s.to_dense().numpy()
    want = np.asarray(_jax(s).to_dense())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s.to_sparse().to_dense().numpy(), got)


@pytest.mark.parametrize("scale", [1.0, -0.1])
def test_apply_indexed_slices_as_jax(scale):
    s = _slices(seed=1)
    dense = torch.randn(12, 5, generator=torch.Generator().manual_seed(2))
    got = sparse.apply_indexed_slices(dense, s, scale=scale).numpy()
    want = np.asarray(jsparse.apply_indexed_slices(
        jnp.asarray(dense.numpy()), _jax(s), scale=scale))
    np.testing.assert_array_equal(got, want)


def test_from_sparse_refuses_other_layouts():
    with pytest.raises(ValueError, match="one sparse dimension"):
        sparse.IndexedSlices.from_sparse(torch.ones(3, 2))
    two = torch.sparse_coo_tensor([[0, 1], [1, 0]], [1.0, 2.0], (2, 2),
                                  check_invariants=False)
    with pytest.raises(ValueError, match="one sparse dimension"):
        sparse.IndexedSlices.from_sparse(two)
    with pytest.raises(ValueError, match="dense_shape"):
        sparse.IndexedSlices(torch.ones(1, 2), torch.zeros(1)).to_dense()


def test_spmd_allreduce_without_a_group_is_the_identity():
    s = _slices()
    for average in (True, False):
        out = sparse.allreduce(s, average=average)
        assert torch.equal(out.values, s.values)
        assert torch.equal(out.indices, s.indices)
        assert out.dense_shape == s.dense_shape


def test_allreduce_eager_at_size_one(monkeypatch):
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "TIMELINE", "FUSION_THRESHOLD"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        s = _slices()
        out = sparse.allreduce_eager(s, name="sparse.one")
        assert torch.equal(out.values, s.values)
        assert torch.equal(out.indices, s.indices)
    finally:
        hvd.shutdown()
