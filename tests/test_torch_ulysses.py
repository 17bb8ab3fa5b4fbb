"""The port's Ulysses attention against the JAX package's, on the CPU.

Two gloo processes (``_torch_parallel_worker.ulysses_worker``, spawned
once per session) re-shard and attend their sequence shards of the same
numpy inputs that the JAX package's ``ulysses_attention`` runs on a
``('sp',)`` mesh of two of the conftest's CPU devices: ``seq_to_heads``
and its inverse bit for bit; attention with ``full_attention`` and with
the flash entry point (the port's plain version on the CPU; JAX's Pallas
kernel in interpret mode, as ``tests/test_transformer.py`` runs
``ulysses_flash``), causal and not, outputs and q/k/v gradients within
1e-5 relative (Frobenius, f32).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parallel_worker import ulysses_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu.ops.flash_attention import flash_attention_auto
from horovod_tpu.parallel import ulysses as jul
from test_torch_ring_attention import rel

TOL = 1e-5
N = 2
B, T, H, D = 2, 16, 4, 8


def _inputs():
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    x = rng.standard_normal((2, 6, 4, 3)).astype(np.float32)
    return q, k, v, g, x


@pytest.fixture(scope="module")
def ulysses_run(request, tmp_path_factory):
    return once(request, tmp_path_factory, "ulysses",
                lambda: run_group(ulysses_worker, N, *_inputs()))


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("sp",))


def test_seq_to_heads_is_jax_reshard_bit_for_bit(ulysses_run):
    x = _inputs()[4]
    f = jax.jit(jax.shard_map(
        lambda x: jul.seq_to_heads(x, axis_name="sp"), mesh=_mesh(),
        in_specs=P(None, "sp"), out_specs=P(None, None, "sp")))
    want = np.asarray(f(x))                        # (B, T, H, D) global
    for r in range(N):
        got = ulysses_run[r]["seq_to_heads"]
        np.testing.assert_array_equal(got, np.split(want, N, axis=2)[r])
        # heads_to_seq undoes it.
        np.testing.assert_array_equal(ulysses_run[r]["round_trip"],
                                      np.split(x, N, axis=1)[r])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("attn", ["full", "flash"])
def test_ulysses_attention_matches_jax(ulysses_run, attn, causal):
    q, k, v, g, _ = _inputs()
    fn = flash_attention_auto if attn == "flash" else None
    f = jax.shard_map(
        lambda q, k, v: jul.ulysses_attention(q, k, v, axis_name="sp",
                                              causal=causal, attn_fn=fn),
        mesh=_mesh(), in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp"), check_vma=False)
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    want = (np.asarray(out),) + tuple(np.asarray(a) for a in vjp(g))
    for r in range(N):
        got = ulysses_run[r][(attn, causal)]
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            w = np.split(w, N, axis=1)[r]
            assert a.shape == w.shape
            assert rel(a, w) <= TOL, (attn, causal, r, name, rel(a, w))
