"""The port's tensor parallelism against the JAX package's, on the CPU.

Four gloo processes (``_torch_parallel_worker.tp_worker``, spawned once
per session) form a (dp 2, tp 2) ``build_mesh`` and run
``ColumnParallelDense``, ``RowParallelDense`` (with and without
``scatter_output``), ``TPMlp`` and ``TPSelfAttention`` through
``tp_value_and_grad(dp_axes=("dp",))`` with the JAX package's per-shard
parameters, carried across by ``weights.tp_shard_tree``; the JAX side
runs the same layers in ``shard_map(check_vma=True)`` on a (2, 2) mesh of
the conftest's CPU devices.  Outputs, losses and every shard's gradients
within 1e-5 relative (Frobenius, f32); ``matmul_reducescatter`` against
JAX's and against ``psum_scatter`` of the full product.  The mesh's
coordinates are JAX's ``axis_index`` values, and a replicated loss
through ``torch.distributed.nn.functional.all_reduce`` (in place of
``collectives.psum``) gives tp times JAX's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parallel_worker import tp_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu.parallel import tensor_parallel as jtp
from horovod_tpu_torch import weights
from horovod_tpu_torch.models import TransformerLM
from horovod_tpu_torch.parallel import tensor_parallel as ttp
from test_torch_ring_attention import rel

TOL = 1e-5
KINDS = ("col", "row", "row_scatter", "mlp", "attn")
WRAP = {"col": "col", "row": "row", "row_scatter": "row"}


def _mesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))


def _x(kind):
    rng = np.random.default_rng(20 + KINDS.index(kind))
    shape = {"col": (8, 6), "row": (8, 12), "row_scatter": (8, 12),
             "mlp": (8, 8), "attn": (4, 5, 8)}[kind]
    return rng.standard_normal(shape).astype(np.float32)


def _jax_layer(kind):
    f32 = jnp.float32
    return {"col": lambda: jtp.ColumnParallelDense(16, dtype=f32),
            "row": lambda: jtp.RowParallelDense(5, dtype=f32),
            "row_scatter": lambda: jtp.RowParallelDense(
                5, dtype=f32, scatter_output=True),
            "mlp": lambda: jtp.TPMlp(hidden=8, out=8, dtype=f32),
            "attn": lambda: jtp.TPSelfAttention(num_heads=4, dtype=f32),
            }[kind]()


def _param_specs(kind, layer, x_local):
    if kind in WRAP:
        return ({"kernel": P(None, "tp"), "bias": P("tp")} if kind == "col"
                else {"kernel": P("tp", None), "bias": P()})
    shapes = jtp.tp_abstract_params(
        lambda: layer.init(jax.random.PRNGKey(1), x_local)["params"], 2)
    return jtp.tp_spec_tree(shapes)


def _jax_run(kind):
    """(loss, y, params, grads) of the JAX layer on the (dp, tp) mesh."""
    layer = _jax_layer(kind)
    x = _x(kind)
    x_spec = P("dp", "tp") if kind.startswith("row") else P("dp")
    local = jnp.zeros((x.shape[0] // 2,) + x.shape[1:-1]
                      + (x.shape[-1] // (2 if kind.startswith("row")
                                         else 1),))
    pspecs = _param_specs(kind, layer, local)
    y_spec = {"col": P("dp", "tp"), "row_scatter": P(("dp", "tp"))}.get(
        kind, P("dp"))

    def body(x):
        params = layer.init(jax.random.PRNGKey(1), x)["params"]

        def loss_fn(p):
            loss = (layer.apply({"params": p}, x) ** 2).mean()
            if kind in ("col", "row_scatter"):
                loss = lax.psum(loss, "tp")
            return loss

        loss, grads = jtp.tp_value_and_grad(loss_fn, params,
                                            dp_axes=("dp",))
        return loss, layer.apply({"params": params}, x), params, grads

    f = jax.jit(jax.shard_map(body, mesh=_mesh(), in_specs=(x_spec,),
                              out_specs=(P(), y_spec, pspecs, pspecs),
                              check_vma=True))
    return jax.tree.map(np.asarray, f(x))


def _mrs_inputs():
    rng = np.random.default_rng(30)
    return (rng.standard_normal((4, 8, 12)).astype(np.float32),
            rng.standard_normal((12, 5)).astype(np.float32))


@pytest.fixture(scope="module")
def tp_run(request, tmp_path_factory):
    def go():
        cases = {kind: (_jax_run(kind)[2], _x(kind)) for kind in KINDS}
        return run_group(tp_worker, 4, cases, _mrs_inputs())
    return once(request, tmp_path_factory, "tensor_parallel", go)


def _shard_of(tree, kind, tp_index):
    """Shard ``tp_index``'s flat ``state_dict``-named arrays of a global
    JAX tree of ``kind``'s layer."""
    wrap = WRAP.get(kind)
    sliced = weights.tp_shard_tree({wrap: tree} if wrap else tree,
                                   tp_index, 2)
    return {k: v.numpy() for k, v in weights.from_flax(
        sliced[wrap] if wrap else sliced).items()}


@pytest.mark.parametrize("kind", KINDS)
def test_layer_matches_jax_through_tp_value_and_grad(tp_run, kind):
    loss, y, _, grads = _jax_run(kind)
    for r in range(4):
        dp_i, tp_i = divmod(r, 2)
        got = tp_run[r]
        assert got[(kind, "loss")] == pytest.approx(float(loss), rel=TOL)
        want_y = np.split(y, 2, axis=0)[dp_i]
        if kind == "col":
            want_y = np.split(want_y, 2, axis=-1)[tp_i]
        if kind == "row_scatter":
            want_y = np.split(y, 4, axis=0)[r]
        assert rel(got[(kind, "y")], want_y) <= TOL, (kind, r)
        want = _shard_of(grads, kind, tp_i)
        assert set(got[(kind, "grads")]) == set(want)
        for name, g in got[(kind, "grads")].items():
            assert g.shape == want[name].shape, (kind, name)
            assert rel(g, want[name]) <= TOL, (kind, r, name)


def test_naive_all_reduce_doubles_the_row_gradient(tp_run):
    """A replicated loss through a row-parallel sum: ``collectives.psum``
    gives JAX's kernel gradient, the naive all-reduce twice it."""
    _, _, _, grads = _jax_run("row")
    for r in range(4):
        want = _shard_of(grads, "row", r % 2)["kernel"]
        assert rel(tp_run[r][("row", "grads")]["kernel"], want) <= TOL
        assert rel(tp_run[r]["row_naive"], 2 * want) <= TOL


def test_matmul_reducescatter_matches_jax_and_psum(tp_run):
    xk, kern = _mrs_inputs()
    specs = (P("dp", None, "tp"), P("tp", None))
    mrs = jax.jit(jax.shard_map(
        lambda x, k: jtp.matmul_reducescatter(x, k, "tp"), mesh=_mesh(),
        in_specs=specs, out_specs=P("dp", "tp")))(xk, kern)
    mrs = np.asarray(mrs)
    for r in range(4):
        dp_i, tp_i = divmod(r, 2)
        want = np.split(np.split(mrs, 2, axis=0)[dp_i], 2, axis=1)[tp_i]
        assert rel(tp_run[r]["mrs"], want) <= TOL
        assert rel(tp_run[r]["mrs"], tp_run[r]["mrs_psum"]) <= TOL
    full = np.einsum("brk,kf->brf", xk.astype(np.float64), kern)
    assert rel(mrs, full) <= TOL


def test_mesh_coordinates_are_jax_axis_indices(tp_run):
    def body(x):
        return jnp.stack([lax.axis_index("dp"), lax.axis_index("tp"),
                          lax.axis_index(("dp", "tp"))])[None, None]

    idx = np.asarray(jax.jit(jax.shard_map(
        body, mesh=_mesh(), in_specs=P("dp", "tp"),
        out_specs=P("dp", "tp")))(np.zeros((2, 2), np.float32)))
    for r in range(4):
        coords, dp_i, tp_i, dp_ranks, tp_ranks, both = tp_run[r]["coords"]
        i, j = divmod(r, 2)
        assert coords == (i, j)
        assert (dp_i, tp_i, both) == tuple(idx[i, j])
        assert dp_ranks == (j, j + 2) and tp_ranks == (2 * i, 2 * i + 1)


def test_spec_tree_matches_jax():
    params = {
        "col": {"kernel": 0, "bias": 0},
        "row": {"kernel": 0, "bias": 0},
        "col_qkv": {"kernel": 0},
        "RowParallelDense_0": {"kernel": 0},
        "ColumnParallelDense_3": {"bias": 0},
        "outer_col_thing": {"dense": {"kernel": 0}},
        "head": {"kernel": 0, "bias": 0},
        "block_0": {"mlp": {"row": {"kernel": 0}}},
    }
    want = jtp.tp_spec_tree(params)
    got = ttp.tp_spec_tree(params)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, P))[0]
    for path, spec in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        assert node == tuple(spec), path


def test_tp_shards_concatenate_back_to_the_jax_tree():
    """Round trip of the TP layout: the shards of a JAX (global) TPMlp
    tree, concatenated along their sharded dimensions, are the tree."""
    _, _, params, _ = _jax_run("mlp")
    shards = [weights.tp_shard_tree(params, i, 2) for i in range(2)]
    for sub in ("col", "row"):
        for leaf, dim in {("col", "kernel"): 1, ("col", "bias"): 0,
                          ("row", "kernel"): 0}.items():
            if leaf[0] != sub:
                continue
            cat = np.concatenate([s[sub][leaf[1]] for s in shards], dim)
            np.testing.assert_array_equal(cat, params[sub][leaf[1]])
    for s in shards:
        np.testing.assert_array_equal(s["row"]["bias"],
                                      params["row"]["bias"])


def test_dense_and_tp_states_round_trip():
    """``dense_to_tp_state`` then ``tp_to_dense_state`` gives back an
    ``attn="full"`` model's weights, for tp 2 and 4."""
    import torch
    model = TransformerLM(vocab=64, dim=32, depth=2, num_heads=4,
                          max_len=16, device="cpu")
    state = model.state_dict()
    for n in (2, 4):
        shards = [weights.dense_to_tp_state(state, 2, i, n)
                  for i in range(n)]
        assert shards[0]["block_1.attn.col_qkv.kernel"].shape == \
            (32, 96 // n)
        back = weights.tp_to_dense_state(shards, 2)
        assert back.keys() == state.keys()
        for k, v in state.items():
            assert torch.equal(back[k], v), k


def test_one_rank_tp_model_computes_the_dense_model():
    """``dense_to_tp_state`` carries an ``attn="full"`` model into its
    ``tp_axis`` twin: on a one-rank tp axis both give the same logits and
    the same gradients (mapped back by ``tp_to_dense_state``)."""
    import torch
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.topology import Topology
    mesh = build_mesh(Topology(1, 0, 0, 1), (1,), ("tp",))
    cfg = dict(vocab=64, dim=32, depth=2, num_heads=4, max_len=16,
               dtype=torch.float32, device="cpu")
    dense = TransformerLM(**cfg, attn="full", seed=2)
    tpm = TransformerLM(**cfg, attn="full", tp_axis="tp", mesh=mesh)
    tpm.load_state_dict(weights.dense_to_tp_state(dense.state_dict(), 2,
                                                  0, 1))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (2, 16)))
    a, b = dense(tokens), tpm(tokens)
    assert rel(b.detach().numpy(), a.detach().numpy()) <= TOL
    a.square().mean().backward()
    b.square().mean().backward()
    grads = weights.tp_to_dense_state(
        [{n: p.grad for n, p in tpm.named_parameters()}], 2)
    for n, p in dense.named_parameters():
        assert rel(grads[n].numpy(), p.grad.numpy()) <= TOL, n


def test_tp_value_and_grad_takes_a_tree_of_tensors():
    """``params`` may be a tree of tensors, as in the JAX package: the
    gradients come back in the same tree (one rank, no dp axis)."""
    import torch
    w = {"a": torch.tensor([1.0, 2.0], requires_grad=True),
         "b": [torch.tensor(3.0, requires_grad=True)]}
    loss, grads = ttp.tp_value_and_grad(
        lambda p: (p["a"] ** 2).sum() * p["b"][0], w)
    assert float(loss) == 15.0
    assert grads["a"].tolist() == [6.0, 12.0]
    assert float(grads["b"][0]) == 5.0
