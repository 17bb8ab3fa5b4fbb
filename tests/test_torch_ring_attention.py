"""The port's ring attention, mesh and collectives against the JAX
package's, on the CPU.

Four gloo processes (``_torch_parallel_worker.ring_worker``, spawned once
per session) run ``ring_attention`` on their shards of the same numpy
inputs that the JAX package's ``ring_attention`` runs on a ``('sp',)``
mesh of four of the conftest's CPU devices inside ``shard_map``: causal
and not, contiguous and zigzag; outputs and the q/k/v gradients of
``sum(out * g)`` within 1e-5 relative (Frobenius, f32).  The collectives
(``psum``, ``pvary``, ``ppermute``, ``all_to_all``, ``psum_scatter``)
give JAX's values and the gradients of JAX's transposes
under ``check_vma=True``; the zigzag layout helpers are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parallel_worker import ring_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu.parallel import ring_attention as jra
from horovod_tpu_torch.parallel import ring_attention as tra

TOL = 1e-5
N = 4
B, T, H, D = 2, 32, 2, 8
CASES = {(c, layout): (c, layout) for c in (True, False)
         for layout in ("contiguous", "zigzag")}
PERM = [(0, 2), (2, 1), (1, 3)]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("sp",))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _collective_inputs():
    rng = np.random.default_rng(40)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"x": r(N, 8, 6), "g_rep": r(8, 6), "g": r(N, 8, 6),
            "g_a2a": r(N, 2, 24), "g_ps": r(N, 2, 6), "w": r(8, 6)}


@pytest.fixture(scope="module")
def ring_run(request, tmp_path_factory):
    def go():
        cases = {key: (*_inputs(7 + i), *key)
                 for i, key in enumerate(CASES)}
        return run_group(ring_worker, N, cases, _collective_inputs())
    return once(request, tmp_path_factory, "ring_attention", go)


def _jax_ring(q, k, v, g, causal, layout):
    f = jax.shard_map(
        lambda q, k, v: jra.ring_attention(q, k, v, axis_name="sp",
                                           causal=causal, layout=layout),
        mesh=_mesh(), in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp"))
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    return (np.asarray(out),) + tuple(np.asarray(a) for a in vjp(g))


@pytest.mark.parametrize("key", list(CASES), ids=lambda k: f"{k[1]}-"
                         f"{'causal' if k[0] else 'full'}")
def test_ring_attention_matches_jax(ring_run, key):
    i = list(CASES).index(key)
    q, k, v, g = _inputs(7 + i)
    want = _jax_ring(q, k, v, g, *key)
    for r in range(N):
        got = ring_run[r][key]
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            w = np.split(w, N, axis=1)[r]
            assert a.shape == w.shape
            assert rel(a, w) <= TOL, (key, r, name, rel(a, w))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_one_rank_ring_equals_full_attention(layout):
    """On a world of one (no process group) the ring is one hop."""
    import torch
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3))
    want = tra.full_attention(q, k, v, causal=True)
    got = tra.ring_attention(q, k, v, causal=True, layout=layout)
    assert rel(got.numpy(), want.numpy()) <= TOL


@pytest.mark.parametrize("n,seq", [(1, 8), (2, 8), (4, 32), (3, 60)])
def test_zigzag_helpers_match_jax(n, seq):
    np.testing.assert_array_equal(tra.zigzag_indices(n, seq),
                                  jra.zigzag_indices(n, seq))
    np.testing.assert_array_equal(tra.inverse_zigzag_indices(n, seq),
                                  jra.inverse_zigzag_indices(n, seq))
    local = seq // n
    for r in range(n):
        np.testing.assert_array_equal(
            tra.zigzag_shard_positions(r, n, local).numpy(),
            np.asarray(jra.zigzag_shard_positions(r, n, local)))


def test_zigzag_rejects_what_jax_rejects():
    with pytest.raises(ValueError) as want:
        jra.zigzag_indices(4, 36)
    with pytest.raises(ValueError) as got:
        tra.zigzag_indices(4, 36)
    assert str(got.value) == str(want.value)


def test_mesh_axis_of_four_ranks(ring_run):
    for r in range(N):
        assert ring_run[r]["coords"] == (N, r, tuple(range(N)))


# ------------------------------------------------------------ collectives


def _jax_collective(name, coll):
    mesh = _mesh()
    x = jnp.asarray(coll["x"])
    if name == "psum":
        f = jax.shard_map(lambda x: lax.psum(x[0], "sp"), mesh=mesh,
                          in_specs=P("sp"), out_specs=P())
        g = coll["g_rep"]
    else:
        body, g = {
            "ppermute": (lambda x: lax.ppermute(x, "sp", PERM), coll["g"]),
            "all_to_all": (lambda x: lax.all_to_all(
                x, "sp", 0, 1, tiled=True), coll["g_a2a"]),
            "psum_scatter": (lambda x: lax.psum_scatter(
                x, "sp", scatter_dimension=0, tiled=True), coll["g_ps"]),
        }[name]
        f = jax.shard_map(lambda x: body(x[0])[None], mesh=mesh,
                          in_specs=P("sp"), out_specs=P("sp"))
    y, vjp = jax.vjp(jax.jit(f), x)
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("name", ["psum", "ppermute", "all_to_all",
                                  "psum_scatter"])
def test_collective_and_its_transpose_match_jax(ring_run, name):
    coll = _collective_inputs()
    want_y, want_dx = _jax_collective(name, coll)
    for r in range(N):
        y, dx = ring_run[r]["collectives"][name]
        wy = want_y if name == "psum" else want_y[r]
        np.testing.assert_allclose(y, wy, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, want_dx[r], rtol=1e-6, atol=1e-6)


def test_pvary_transpose_sums_the_cotangent(ring_run):
    coll = _collective_inputs()
    f = jax.shard_map(lambda w, x: (w * x[0])[None], mesh=_mesh(),
                      in_specs=(P(), P("sp")), out_specs=P("sp"))
    _, vjp = jax.vjp(jax.jit(f), jnp.asarray(coll["w"]),
                     jnp.asarray(coll["x"]))
    want = np.asarray(vjp(jnp.asarray(coll["g"]))[0])
    for r in range(N):
        np.testing.assert_allclose(ring_run[r]["collectives"]["pvary"],
                                   want, rtol=1e-5, atol=1e-6)


def test_naive_all_reduce_backward_is_not_the_transpose(ring_run):
    """``torch.distributed.nn.functional.all_reduce`` all-reduces the
    replicated cotangent in its backward: N times JAX's gradient, where
    ``collectives.psum`` gives JAX's."""
    coll = _collective_inputs()
    _, want = _jax_collective("psum", coll)
    for r in range(N):
        naive = ring_run[r]["collectives"]["naive_psum_grad"]
        np.testing.assert_allclose(naive, N * want[r], rtol=1e-6)
        assert not np.allclose(naive, want[r])
