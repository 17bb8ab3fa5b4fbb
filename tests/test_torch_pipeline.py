"""The port's pipeline schedule against the JAX package's, on the CPU.

Four gloo processes (``_torch_parallel_worker.pipeline_worker``, spawned
once per session) each hold one stage, a ``BlockStack`` of one block
(width 32, 4 heads), loaded from the JAX package's per-stage parameters
(stacked over ``pp``, ``weights.load_flax_stage_params``), and run
``pipeline_apply`` over 4 microbatches of a replicated input ``x @ w``;
the JAX side runs the same stages under ``shard_map(check_vma=True)`` on a
``('pp',)`` mesh of four of the conftest's CPU devices.  The outputs (on
every stage), the loss, every stage's parameter gradients and the
gradients of the replicated ``x`` and ``w`` within 1e-5 relative
(Frobenius, f32); the no-grad schedule gives the same outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parallel_worker import pipeline_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu.models import BlockStack as JaxBlockStack
from horovod_tpu.parallel import pipeline as jpp
from horovod_tpu_torch import weights
from horovod_tpu_torch.parallel import pipeline as tpp
from test_torch_ring_attention import rel

TOL = 1e-5
S, M, MB, T, DIM, D_IN = 4, 4, 2, 8, 32, 16
CFG = dict(dim=DIM, heads=4, depth=1, attn="full")


def _inputs():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((M * MB, T, D_IN)).astype(np.float32)
    w = (rng.standard_normal((D_IN, DIM)) * 0.3).astype(np.float32)
    tgt = rng.standard_normal((M * MB, T, DIM)).astype(np.float32)
    return x, w, tgt


def _jax_run():
    x, w, tgt = _inputs()
    bs = JaxBlockStack(num_heads=CFG["heads"], depth=CFG["depth"],
                       attn=CFG["attn"], dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:S]), ("pp",))

    def body(x, w, tgt):
        stage = jpp.stage_params_init(
            lambda k: bs.init(k, jnp.zeros((MB, T, DIM)))["params"],
            jax.random.PRNGKey(1))

        def loss_fn(p, x, w):
            y = jpp.unmicrobatch(jpp.pipeline_apply(
                lambda p, a: bs.apply({"params": p}, a), p,
                jpp.microbatch(x @ w, M)))
            return ((y - tgt) ** 2).mean(), y

        (loss, y), (gp, gx, gw) = jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2), has_aux=True)(stage, x, w)
        stack = jax.tree.map(lambda a: a[None], (stage, gp))
        return loss, y, stack[0], stack[1], gx, gw

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P(), P()),
                              out_specs=(P(), P(), P("pp"), P("pp"), P(),
                                         P()), check_vma=True))
    return jax.tree.map(np.asarray, f(x, w, tgt))


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


@pytest.fixture(scope="module")
def pp_run(request, tmp_path_factory, jax_run):
    x, w, tgt = _inputs()
    return once(request, tmp_path_factory, "pipeline", lambda: run_group(
        pipeline_worker, S, jax_run[2], w, x, tgt, CFG, M))


def test_outputs_and_loss_match_jax(pp_run, jax_run):
    loss, y = jax_run[0], jax_run[1]
    for r in range(S):
        assert rel(pp_run[r]["y"], y) <= TOL, r
        assert pp_run[r]["loss"] == pytest.approx(float(loss), rel=TOL)
        np.testing.assert_array_equal(pp_run[r]["y_no_grad"],
                                      pp_run[r]["y"])


def test_stage_gradients_match_jax(pp_run, jax_run):
    grads = jax_run[3]
    for r in range(S):
        want = {k: v.numpy() for k, v in weights.from_flax(
            jax.tree.map(lambda a: a[r], grads)).items()}
        got = pp_run[r]["grads"]
        assert set(got) == set(want)
        for name, g in got.items():
            assert rel(g, want[name]) <= TOL, (r, name, rel(g, want[name]))


def test_replicated_input_gradients_match_jax(pp_run, jax_run):
    gx, gw = jax_run[4], jax_run[5]
    for r in range(S):
        assert rel(pp_run[r]["x_grad"], gx) <= TOL, r
        assert rel(pp_run[r]["w_grad"], gw) <= TOL, r


def test_stages_draw_distinct_parameters(pp_run):
    assert len({pp_run[r]["seed"] for r in range(S)}) == S


def test_stage_trees_round_trip(jax_run):
    """Each stage of the stacked JAX tree loads into a ``BlockStack`` and
    reads back unchanged."""
    from horovod_tpu_torch.models import BlockStack
    stacked = jax_run[2]
    for s in range(S):
        stage = BlockStack(DIM, 4, 1, dtype=torch.float32, device="cpu")
        weights.load_flax_stage_params(stage, stacked, s)
        for name, p in stage.state_dict().items():
            node = stacked
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(p.numpy(), node[s])


def test_microbatch_round_trip_and_error():
    x = torch.arange(24.0).reshape(6, 4)
    mb = tpp.microbatch(x, 3)
    assert mb.shape == (3, 2, 4)
    assert torch.equal(tpp.unmicrobatch(mb), x)
    with pytest.raises(ValueError) as want:
        jpp.microbatch(jnp.zeros((7, 4)), 2)
    with pytest.raises(ValueError) as got:
        tpp.microbatch(torch.zeros(7, 4), 2)
    assert str(got.value) == str(want.value)


def test_stage_given_as_a_tree_of_tensors():
    """As in the JAX package, a stage may be a tree of tensors: on a
    one-stage axis the schedule is the stage applied to each microbatch,
    and gradients reach the tree's leaves."""
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.topology import Topology
    mesh = build_mesh(Topology(1, 0, 0, 1), (1,), ("pp",))
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    params = {"w": w.clone().requires_grad_(), "b": torch.zeros(
        4, requires_grad=True)}
    x = torch.from_numpy(rng.standard_normal((3, 2, 4)).astype(np.float32))

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    y = tpp.pipeline_apply(stage_fn, params, x, mesh=mesh)
    y.square().sum().backward()
    ref = {"w": w.clone().requires_grad_(),
           "b": torch.zeros(4, requires_grad=True)}
    want = stage_fn(ref, x)
    want.square().sum().backward()
    assert rel(y.detach().numpy(), want.detach().numpy()) <= TOL
    for k in ("w", "b"):
        assert rel(params[k].grad.numpy(), ref[k].grad.numpy()) <= TOL
