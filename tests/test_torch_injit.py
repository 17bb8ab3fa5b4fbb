"""The port's in-step collectives (``horovod_tpu_torch.ops.injit``)
against the JAX package's under ``shard_map``, on the CPU.

Four gloo processes (``_torch_injit_worker.injit_worker``, spawned once
per session) run every case on their blocks of the seeded numpy inputs
of ``tests/test_injit_ops.py``; the JAX side runs the same function under
``jax.shard_map`` on a 4-device ``("ranks",)`` mesh (and a (2, 2)
``("dp", "tp")`` mesh) cut from the conftest's 8 CPU devices.  Each case
gives its output and the gradient of ``sum(out * w)``: on the JAX side
of the global loss, on the port's of each rank's own loss (the module
docstring's convention).  Data movement is bit-identical; sums and
gradients agree within 1e-6 relative, but for the allgather whose
gathered copy each rank weighs in a loss of its own: there the test pins
the divergence the module docstring states.  The permute broadcast's forward
runs with ``dist.all_reduce`` patched to raise (the counterpart of
``test_broadcast_forward_has_no_allreduce``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _torch_injit_worker import injit_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu.ops import injit as jinjit
from horovod_tpu_torch.ops import injit as tinjit

N = 4
TOL = 1e-6
RS = np.random.RandomState


def _f32(seed, *shape):
    return RS(seed).randn(*shape).astype(np.float32)


def _cases():
    """name -> (function, kwargs, x, w); x and w are global arrays whose
    blocks along dim 0 are the ranks' (w whole for allgather, whose
    gathered output counts once, unless ``per_rank``: each rank's loss
    then weighs its own copy with its block of w)."""
    n = N
    ranks = np.stack([np.full(4, r, np.float32) for r in range(n)])
    cases = {
        "allreduce_sum": ("allreduce", dict(average=False),
                          np.arange(n * 4, dtype=np.float32).reshape(n, 4),
                          _f32(2, n, 4)),
        "allreduce_mean": ("allreduce", dict(average=True),
                           _f32(2, n, 4), _f32(12, n, 4)),
        "allgather_0": ("allgather", dict(axis=0), _f32(4, n * 2, 3),
                        _f32(5, n * 2, 3)),
        "allgather_1": ("allgather", dict(axis=1), _f32(4, n * 2, 3),
                        _f32(5, 2, n * 3)),
        "allgather_per_rank": ("allgather", dict(axis=0, per_rank=True),
                               _f32(4, n * 2, 3), _f32(24, n * n * 2, 3)),
        "reducescatter": ("reducescatter", dict(axis=0),
                          _f32(1, n, n * 2).reshape(n * n, 2),
                          _f32(13, n, 2)),
        "reducescatter_avg": ("reducescatter", dict(axis=0, average=True),
                              _f32(1, n, n * 2).reshape(n * n, 2),
                              _f32(13, n, 2)),
        "reducescatter_1": ("reducescatter", dict(axis=1),
                            _f32(14, n * 2, n * 3), _f32(15, n * 2, 3)),
        "alltoall_00": ("alltoall", dict(split_axis=0, concat_axis=0),
                        _f32(8, n * n, 3), _f32(16, n * n, 3)),
        "alltoall_10": ("alltoall", dict(split_axis=1, concat_axis=0),
                        _f32(8, n * 2, n * 2), _f32(17, n * n * 2, 2)),
        "alltoall_01": ("alltoall", dict(split_axis=0, concat_axis=1),
                        _f32(8, n * n, 3), _f32(18, n, n * 3)),
        "broadcast_tp": ("broadcast", dict(root_rank=1, axis_name="tp",
                                           mesh=True),
                         _f32(7, n, 4), _f32(19, n, 4)),
        "broadcast_dp_tp": ("broadcast", dict(root_rank=2,
                                              axis_name=("dp", "tp"),
                                              mesh=True),
                            _f32(7, n, 4), _f32(19, n, 4)),
        "reducescatter_dp": ("reducescatter", dict(axis=1, axis_name="dp",
                                                   mesh=True),
                             _f32(20, n * 2, 4), _f32(21, n * 2, 2)),
        "allreduce_tp": ("allreduce", dict(average=True, axis_name="tp",
                                           mesh=True),
                         _f32(22, n, 4), _f32(23, n, 4)),
    }
    for root in (2, n - 1):
        for mode in ("permute", "psum"):
            cases[f"broadcast_{mode}_{root}"] = (
                "broadcast", dict(root_rank=root, mode=mode), _f32(7, n, 4),
                np.full((n, 4), 2.0, np.float32))
            cases[f"broadcast_{mode}_{root}_ranks"] = (
                "broadcast", dict(root_rank=root, mode=mode), ranks,
                _f32(9, n, 4))
    return cases


CASES = _cases()
BIT_EXACT = {"allgather_0", "allgather_1", "allgather_per_rank",
             "alltoall_00", "alltoall_10",
             "alltoall_01", "broadcast_tp", "broadcast_dp_tp"} | {
    k for k in CASES if k.startswith("broadcast_")}


def _jax_case(kind, kw, x, w):
    """(output, gradient) of the JAX function under shard_map."""
    kw = dict(kw)
    if kw.pop("mesh", False):
        mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2), ("dp", "tp"))
        spec = P(("dp", "tp"))
    else:
        mesh = Mesh(np.array(jax.devices()[:N]), ("ranks",))
        spec = P("ranks")
    fn = getattr(jinjit, kind)
    per_rank = kw.pop("per_rank", False)
    if kind == "allgather":
        kw["axis_name"] = "ranks"
    if kind == "allgather" and not per_rank:
        out_spec, check = P(), False
    else:
        out_spec, check = spec, True
    f = jax.shard_map(lambda a: fn(a, **kw), mesh=mesh, in_specs=spec,
                      out_specs=out_spec, check_vma=check)

    def loss(a):
        y = f(a)
        return jnp.sum(y * w), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(x)
    return np.asarray(y), np.asarray(g)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    def compute():
        torch_side = run_group(injit_worker, N, CASES)
        jax_side = {name: _jax_case(*case) for name, case in CASES.items()}
        mesh = Mesh(np.array(jax.devices()[:N]), ("ranks",))
        ids = jax.shard_map(
            lambda a: jnp.full((1,), jinjit.rank_index(), jnp.int32)
            + 0 * a.astype(jnp.int32),
            mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"))(
                np.zeros(N, np.int32))
        sizes = jax.shard_map(
            lambda a: jnp.full((1,), jinjit.num_ranks(), jnp.int32)
            + 0 * a.astype(jnp.int32),
            mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"))(
                np.zeros(N, np.int32))
        return torch_side, jax_side, (np.asarray(ids), np.asarray(sizes))
    return once(request, tmp_path_factory, "injit", compute)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _per_rank(name, got):
    """The ports' outputs laid out as JAX's global output, and their
    gradients as JAX's gradient of the global input."""
    kind = CASES[name][0]
    outs = [got[r][name][0] for r in range(N)]
    grads = np.concatenate([got[r][name][1] for r in range(N)])
    if kind == "allgather" and not CASES[name][1].get("per_rank"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
        return outs[0], grads
    return np.concatenate(outs), grads


def _own_and_summed_slices(name):
    """For a ``per_rank`` allgather: (each rank's slice of its own block
    of w, the sum over the ranks of every block's slice at this rank),
    stacked as the global input's gradient."""
    _, kw, x, w = CASES[name]
    rows = len(x) // N
    blocks = np.split(w, N)
    own = np.concatenate([blocks[r][r * rows:(r + 1) * rows]
                          for r in range(N)])
    summed = np.concatenate([sum(b[r * rows:(r + 1) * rows] for b in blocks)
                             for r in range(N)])
    return own, summed


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(runs, name):
    got, want, _ = runs
    out, _ = _per_rank(name, got)
    jout, _ = want[name]
    assert out.shape == jout.shape and out.dtype == jout.dtype
    if name in BIT_EXACT:
        np.testing.assert_array_equal(out, jout)
    else:
        assert _rel(out, jout) <= TOL, (name, _rel(out, jout))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_matches_jax(runs, name):
    got, want, _ = runs
    _, grad = _per_rank(name, got)
    _, jgrad = want[name]
    assert grad.shape == jgrad.shape
    if CASES[name][1].get("per_rank"):
        # The module docstring's divergence: each rank's loss of its own
        # gathered copy.  JAX sums every rank's slice (psum_scatter); the
        # port keeps this rank's slice of its own cotangent.
        own, summed = _own_and_summed_slices(name)
        np.testing.assert_array_equal(grad, own)
        assert _rel(jgrad, summed) <= TOL, _rel(jgrad, summed)
        return
    assert _rel(grad, jgrad) <= TOL, (name, _rel(grad, jgrad))


def test_gradients_are_the_reference_registered_ones(runs):
    """The values ``tests/test_injit_ops.py`` asserts: broadcast's root
    holds n x the cotangent and the others zero; allgather's gradient is
    ``w``; allreduce's (sum) is the sum of every rank's cotangent."""
    got, _, _ = runs
    for root in (2, N - 1):
        for mode in ("permute", "psum"):
            _, g = _per_rank(f"broadcast_{mode}_{root}", got)
            want = np.zeros((N, 4), np.float32)
            want[root] = 2.0 * N
            np.testing.assert_array_equal(g, want)
    _, g = _per_rank("allgather_0", got)
    np.testing.assert_array_equal(g, CASES["allgather_0"][3])
    _, g = _per_rank("allreduce_sum", got)
    w = CASES["allreduce_sum"][3]
    np.testing.assert_allclose(g, np.tile(w.sum(0), (N, 1)), rtol=1e-6)


def test_rank_queries_match_jax(runs):
    got, _, (ids, sizes) = runs
    assert [got[r]["rank_index"] for r in range(N)] == ids.tolist()
    assert [got[r]["num_ranks"] for r in range(N)] == sizes.tolist()


def test_integer_payloads_move_bit_for_bit(runs):
    """int64 through broadcast (both modes), allgather along axis 1,
    reducescatter and alltoall, against numpy."""
    got, _, _ = runs
    ints = [np.arange(N * 6, dtype=np.int64).reshape(N * 2, 3) * 7 + r
            for r in range(N)]
    total = sum(ints)
    for r in range(N):
        bcast, bcast_psum, gathered, scattered, exchanged = got[r]["int"]
        np.testing.assert_array_equal(bcast, ints[1])
        np.testing.assert_array_equal(bcast_psum, ints[1])
        np.testing.assert_array_equal(gathered, np.concatenate(ints, 1))
        np.testing.assert_array_equal(scattered, np.split(total, N)[r])
        np.testing.assert_array_equal(
            exchanged, np.concatenate([np.split(i, N)[r] for i in ints], 1))


def test_bad_broadcast_mode_raises_the_reference_text(runs):
    got, _, _ = runs
    with pytest.raises(ValueError) as want:
        jinjit.broadcast(np.zeros(1), 0, mode="tree")
    assert [got[r]["bad_mode"] for r in range(N)] == [str(want.value)] * N


def test_one_rank_axis_is_the_identity():
    """Without a process group every function returns its input, and the
    rank queries give one rank."""
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert tinjit.num_ranks() == 1 and tinjit.rank_index() == 0
    for fn in (lambda t: tinjit.allgather(t, axis=1),
               lambda t: tinjit.broadcast(t, 0),
               lambda t: tinjit.broadcast(t, 0, mode="psum"),
               tinjit.reducescatter, tinjit.alltoall):
        assert torch.equal(fn(x), x)
    with pytest.raises(ValueError, match="got 'tree'"):
        tinjit.broadcast(x, 0, mode="tree")
