"""The port's MoELayer against the JAX package's, on the CPU.

Four gloo processes (``_torch_parallel_worker.moe_worker``, spawned once
per session) hold one expert each, loaded from the JAX package's
per-shard parameters (``w1``/``w2`` stacked over ``ep``, the replicated
router; ``weights.load_flax_expert_params``), and route their shards of
the same tokens that the JAX package's ``MoELayer`` routes under
``shard_map(check_vma=True)`` on an ``('ep',)`` mesh of four of the
conftest's CPU devices: top-1 and top-2, with and without capacity
pressure (tokens drop), with and without the router z-loss.  Outputs, the
aux loss and its two sown components, and the gradients of
``sum(out * g) + aux`` for the tokens, every expert and the router
(summed over ``ep``) within 1e-5 relative (Frobenius, f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parallel_worker import moe_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu.parallel.moe import MoELayer as JaxMoE
from test_torch_ring_attention import rel

TOL = 1e-5
E, T_LOCAL, DIM, HID = 4, 8, 8, 16
CASES = {
    "top1": dict(top_k=1, capacity_factor=1.25, router_z_weight=0.0),
    "top2_z": dict(top_k=2, capacity_factor=1.25, router_z_weight=0.1),
    "top1_drop": dict(top_k=1, capacity_factor=0.5, router_z_weight=0.0),
    "top2_drop": dict(top_k=2, capacity_factor=0.5, router_z_weight=0.01),
}


def _inputs(key):
    rng = np.random.default_rng(60 + list(CASES).index(key))
    x = rng.standard_normal((E * T_LOCAL, DIM)).astype(np.float32)
    g = rng.standard_normal((E * T_LOCAL, DIM)).astype(np.float32)
    return x, g


def _jax_run(key):
    layer = JaxMoE(hidden=HID, dtype=jnp.float32, **CASES[key])
    mesh = Mesh(np.array(jax.devices()[:E]), ("ep",))

    def body(x, g):
        params = layer.init(jax.random.PRNGKey(1), x)["params"]

        def loss_fn(p, x):
            (out, aux), state = layer.apply({"params": p}, x,
                                            mutable=["intermediates"])
            inter = state["intermediates"]
            return (out * g).sum() + aux, (
                out, aux, inter["aux_load_balance"][0],
                inter["aux_router_z"][0])

        (_, (out, aux, bal, z)), (gp, gx) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(params, x)

        def stack(tree):
            return {"router": tree["router"], "w1": tree["w1"][None],
                    "w2": tree["w2"][None]}

        return (out, aux[None], bal[None], z[None], gx, stack(params),
                stack(gp))

    pspec = {"router": {"kernel": P()}, "w1": P("ep"), "w2": P("ep")}
    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("ep"), P("ep")),
        out_specs=(P("ep"),) * 5 + (pspec, pspec), check_vma=True))
    return jax.tree.map(np.asarray, f(*_inputs(key)))


@pytest.fixture(scope="module")
def jax_runs():
    return {key: _jax_run(key) for key in CASES}


@pytest.fixture(scope="module")
def moe_run(request, tmp_path_factory, jax_runs):
    cases = {key: (jax_runs[key][5], *_inputs(key), CASES[key])
             for key in CASES}
    return once(request, tmp_path_factory, "moe",
                lambda: run_group(moe_worker, E, cases))


@pytest.mark.parametrize("key", list(CASES))
def test_moe_matches_jax(moe_run, jax_runs, key):
    out, aux, bal, z, gx, _, grads = jax_runs[key]
    for r in range(E):
        got = moe_run[r][key]
        assert rel(got["y"], np.split(out, E)[r]) <= TOL, (key, r)
        assert got["aux"] == pytest.approx(float(aux[r]), rel=TOL)
        assert got["balance"] == pytest.approx(float(bal[r]), rel=TOL)
        assert got["z"] == pytest.approx(float(z[r]), rel=TOL)
        assert rel(got["x_grad"], np.split(gx, E)[r]) <= TOL, (key, r)
        want = {"router.kernel": grads["router"]["kernel"],
                "w1": grads["w1"][r], "w2": grads["w2"][r]}
        assert set(got["grads"]) == set(want)
        for name, g in got["grads"].items():
            assert rel(g, want[name]) <= TOL, (key, r, name)


@pytest.mark.parametrize("key", list(CASES))
def test_capacity_and_dropped_share(moe_run, key):
    cfg = CASES[key]
    want_c = max(1, int(cfg["capacity_factor"] * cfg["top_k"] * T_LOCAL
                        / E))
    dropped = [moe_run[r][key]["dropped"] for r in range(E)]
    assert all(moe_run[r][key]["capacity"] == want_c for r in range(E))
    if key.endswith("_drop"):
        # k·T choices into E·C slots: at least the excess drops.
        floor = 1 - E * want_c / (cfg["top_k"] * T_LOCAL)
        assert all(d >= floor - 1e-6 for d in dropped), dropped
        assert max(dropped) > 0
    else:
        assert all(0.0 <= d < 1.0 for d in dropped), dropped


def test_expert_trees_load_whole_router_and_one_expert(jax_runs):
    import torch
    from horovod_tpu_torch import weights
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.moe import MoELayer
    from horovod_tpu_torch.topology import Topology
    params = jax_runs["top1"][5]
    mesh = build_mesh(Topology(1, 0, 0, 1), (1,), ("ep",))
    # A one-rank layer holds one expert; load each expert in turn.
    for e in range(E):
        layer = MoELayer(DIM, HID, axis="ep", dtype=torch.float32,
                         mesh=mesh, device="cpu")
        layer.router = type(layer.router)(DIM, E, use_bias=False,
                                          dtype=torch.float32,
                                          device="cpu", gen=None)
        weights.load_flax_expert_params(layer, params, e)
        np.testing.assert_array_equal(layer.w1.detach().numpy(),
                                      params["w1"][e])
        np.testing.assert_array_equal(layer.w2.detach().numpy(),
                                      params["w2"][e])
        np.testing.assert_array_equal(layer.router.kernel.detach().numpy(),
                                      params["router"]["kernel"])
