"""The port's two-tier gradient reduction against the JAX package's.

Four gloo processes on two fake hosts (``HOROVOD_TPU_HOST_FINGERPRINT``
A, A, B, B, set in the spawned workers' environment only) build
``hierarchical_mesh()`` and reduce the same per-rank gradients that the
JAX package's ``reduce_gradients`` reduces on a ``('dcn', 'ici')`` (2, 2)
mesh of the conftest's CPU devices (after
``tests/test_spmd_step.py:137``): fused and leaf by leaf, raw, bf16 and
int8 (eligible leaves snapped onto the int8 grid around the reduce),
within 1e-6 relative (Frobenius, per leaf).  Integer-valued payloads are
bit-identical to the flat ``all_reduce``; overlap on and off are
bit-identical; one small-ResNet step on the mesh matches the flat step
within 1e-5 relative.  The process group is spawned once per session
(``_torch_spmd_worker.once``).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _torch_spmd_worker import (HOSTS, hier_worker, int_payload, once,
                                rank_grads, run_group)
from horovod_tpu import topology as jax_topology
from horovod_tpu.jax.spmd import reduce_gradients as jax_reduce_gradients
from horovod_tpu.parallel.mesh import DCN_AXIS, ICI_AXIS
from horovod_tpu_torch import topology
from horovod_tpu_torch.parallel import mesh as tmesh
from test_torch_resnet import rel, resnet_problem


UNFUSED = {"xla_disable_hlo_passes": "fusion"}
TOL = 1e-6
TOL_STEP = 1e-5


@pytest.fixture(scope="module")
def hier_run(request, tmp_path_factory):
    return once(request, tmp_path_factory, "hier", _hier_run)


def _hier_run():
    variables, images, labels = resnet_problem(batch=8, steps=2)
    return run_group(hier_worker, 4, variables, images, labels,
                     fingerprints=HOSTS)


def _jax_reduce(comp, fuse, average=True):
    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, (DCN_AXIS, ICI_AXIS))
    per_rank = [rank_grads(r) for r in range(4)]
    stacked = [np.stack([g[i] for g in per_rank])
               for i in range(len(per_rank[0]))]
    spec = P((DCN_AXIS, ICI_AXIS))

    def body(gs):
        red = jax_reduce_gradients([g[0] for g in gs], (DCN_AXIS, ICI_AXIS),
                                   average=average, compression=comp,
                                   fuse=fuse, bucket_bytes=4096)
        return [r[None] for r in red]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                              out_specs=spec))
    out = f.lower(stacked).compile(compiler_options=UNFUSED)(stacked)
    return [np.asarray(o) for o in out]


def test_mesh_groups_follow_the_host_fingerprints(hier_run):
    for r in range(4):
        grid, ici, dcn, ici_rank, dcn_rank = hier_run[r]["mesh"]
        assert grid == ((0, 1), (2, 3))
        assert (ici, dcn, ici_rank, dcn_rank) == (2, 2, r % 2, r // 2)
        assert hier_run[r]["fixed"] == (((0, 1, 2, 3),), 4, 1)


def test_ici_size_that_does_not_divide_raises_in_the_group(hier_run):
    want = _jax_uneven_message(4, ici_size=3)
    for r in range(4):
        assert hier_run[r]["uneven"] == want


@pytest.mark.parametrize("average", [False, True])
def test_integer_payload_bit_identical_to_flat(hier_run, average):
    total = sum(int_payload(r) for r in range(4))
    for r in range(4):
        hier, flat = hier_run[r][("int", average)]
        assert hier.tobytes() == flat.tobytes()
        want = total / 4 if average else total
        np.testing.assert_array_equal(hier, want.astype(np.float32))


@pytest.mark.parametrize("comp", ["none", "bf16", "int8"])
@pytest.mark.parametrize("fuse", [True, False])
def test_reduce_gradients_matches_jax(hier_run, monkeypatch, comp, fuse):
    # The Pallas codec fails JAX's vma check inside shard_map; its jnp
    # lowering computes the same grid.
    monkeypatch.setenv("HOROVOD_TPU_INJIT_PALLAS", "0")
    want = _jax_reduce(comp, fuse)
    for r in range(4):
        got = hier_run[r][(comp, fuse, False)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape[1:]
            assert rel(g, w[r]) <= TOL


def test_sum_matches_jax(hier_run):
    want = _jax_reduce("none", True, average=False)
    for r in range(4):
        for g, w in zip(hier_run[r]["sum"], want):
            assert rel(g, w[r]) <= TOL


@pytest.mark.parametrize("comp", ["none", "bf16", "int8"])
@pytest.mark.parametrize("fuse", [True, False])
def test_overlap_on_and_off_bit_identical(hier_run, comp, fuse):
    for r in range(4):
        for a, b in zip(hier_run[r][(comp, fuse, False)],
                        hier_run[r][(comp, fuse, True)]):
            assert a.tobytes() == b.tobytes()


def test_train_step_on_the_mesh_matches_the_flat_step(hier_run):
    for r in range(4):
        mesh_losses, mesh_state = hier_run[r]["step_mesh"]
        flat_losses, flat_state = hier_run[r]["step_flat"]
        np.testing.assert_allclose(mesh_losses, flat_losses, rtol=TOL_STEP)
        for name, value in flat_state.items():
            assert rel(mesh_state[name], value) <= TOL_STEP, name
    # Every rank ends with the same parameters and statistics.
    for name, value in hier_run[0]["step_mesh"][1].items():
        for r in range(1, 4):
            np.testing.assert_array_equal(hier_run[r]["step_mesh"][1][name],
                                          value)


# ------------------------------------------------------------ host grid


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


def _jax_uneven_message(n, ici_size=None, process_index=None):
    devs = [_Dev(process_index[i] if process_index else 0)
            for i in range(n)]
    with pytest.raises(ValueError) as info:
        jax_topology.slice_groups(devs, ici_size)
    return str(info.value)


@pytest.mark.parametrize("fps,grid", [
    (["A", "A", "B", "B"], [[0, 1], [2, 3]]),
    (["A", "B", "A", "B"], [[0, 2], [1, 3]]),
    (["B", "A", "A", "B"], [[0, 3], [1, 2]]),
    (["A"] * 4, [[0, 1, 2, 3]]),
    (["A", "B", "C", "D"], [[0], [1], [2], [3]]),
])
def test_host_grid_ordered_by_leader(fps, grid):
    assert tmesh._host_grid(fps, None) == grid
    groups, leaders = jax_topology.derive_host_groups(fps)
    assert [groups[fps[lead]] for lead in leaders] == grid


def test_uneven_host_groups_raise_the_reference_text():
    with pytest.raises(ValueError) as info:
        tmesh._host_grid(["A", "A", "A", "B"], None)
    want = _jax_uneven_message(4, process_index=[0, 0, 0, 1])
    got = str(info.value)
    assert got.startswith("device host groups are uneven ([('A', 3), "
                          "('B', 1)])")
    assert got.split("); ", 1)[1] == want.split("); ", 1)[1]


@pytest.mark.parametrize("n,ici_size", [(4, 3), (6, 4), (5, 2)])
def test_ici_size_that_does_not_divide_raises(n, ici_size):
    with pytest.raises(ValueError) as info:
        tmesh._host_grid(["A"] * n, ici_size)
    assert str(info.value) == _jax_uneven_message(n, ici_size=ici_size)


def test_fixed_ici_size_splits_consecutive_ranks():
    assert tmesh._host_grid(["A", "B"] * 3, 3) == [[0, 1, 2], [3, 4, 5]]


def test_one_rank_mesh_is_the_identity():
    import torch
    from horovod_tpu_torch.parallel.hierarchical import (
        hierarchical_allreduce)
    m = tmesh.build_hierarchical_mesh(topology.Topology(1, 0, 0, 1))
    assert (m.size, m.ici_size, m.dcn_size) == (1, 1, 1)
    x = torch.arange(5.0)
    assert torch.equal(hierarchical_allreduce(x, average=True, mesh=m), x)


def test_host_fingerprint_and_groups_match_the_reference():
    assert topology.host_fingerprint() == jax_topology.host_fingerprint()
    rng = np.random.default_rng(4)
    for _ in range(50):
        fps = [str(v) for v in rng.integers(0, 4, int(rng.integers(1, 9)))]
        assert topology.derive_host_groups(fps) == \
            jax_topology.derive_host_groups(fps)
