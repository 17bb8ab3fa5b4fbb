"""The port's TransformerLM against the JAX package's, on the CPU.

A JAX ``TransformerLM`` is initialised and its flax params are carried into
the port's module with ``weights.from_flax``; both run the same tokens in
f32.  Tolerance 1e-4 absolute on hidden states and logits (two layers of
reassociated f32 sums).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu_torch import weights
from horovod_tpu_torch.models import TransformerLM
from horovod_tpu_torch.models import transformer as tt

CFG = dict(vocab=512, dim=256, depth=2, num_heads=2, max_len=128)
ATOL = 1e-4


def _jax_model(attn):
    model = JaxLM(**CFG, attn=attn, dtype=jnp.float32,
                  head_dtype=jnp.float32, ln_dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(
        0, CFG["vocab"], (2, 128)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return model, jax.tree.map(np.asarray, params), tokens


@pytest.mark.parametrize("attn", ["flash", "full"])
def test_forward_matches_jax(attn):
    jmodel, params, tokens = _jax_model(attn)
    want_h = jmodel.apply({"params": params}, jnp.asarray(tokens),
                          return_hidden=True)
    want_logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
    model = TransformerLM(**CFG, attn=attn, dtype=torch.float32,
                          head_dtype=torch.float32, ln_dtype=torch.float32,
                          device="cpu")
    weights.load_flax_params(model, params)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        h = model(t, return_hidden=True)
        logits = model(t)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=ATOL)


def test_param_tree_maps_onto_state_dict():
    """Names, shapes and the (in, out) / (C, 3C) layouts line up one to one,
    with biases on fc1/fc2 only."""
    _, params, _ = _jax_model("full")    # the same tree as "flash"
    sd = weights.from_flax(params)
    model = TransformerLM(**CFG, attn="flash", dtype=torch.float32,
                          device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    C = CFG["dim"]
    assert sd["block_0.attn.qkv.kernel"].shape == (C, 3 * C)
    assert sd["block_0.fc1.kernel"].shape == (C, 4 * C)
    biases = sorted(k for k in sd if k.endswith(".bias")
                    and ".ln" not in k and not k.startswith("ln_f"))
    assert biases == ["block_0.fc1.bias", "block_0.fc2.bias",
                      "block_1.fc1.bias", "block_1.fc2.bias"]


@pytest.mark.parametrize("ln_dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_matches_flax(ln_dtype):
    """Epsilon 1e-6, f32 statistics with the fast variance E[x^2] - E[x]^2,
    output in ln_dtype."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 256)) * 0.2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(256).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    ln = fnn.LayerNorm(dtype=ln_dtype)
    want = ln.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x))
    tdtype = torch.float32 if ln_dtype == jnp.float32 else torch.bfloat16
    mine = tt.LayerNorm(256, dtype=tdtype, device="cpu")
    assert mine.epsilon == ln.epsilon == 1e-6
    mine.load_state_dict({"scale": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = mine(torch.from_numpy(x))
    assert got.dtype == tdtype
    # bf16: one rounding of the same f32 value, allow one bf16 ulp.
    tol = dict(rtol=1e-5, atol=1e-5) if tdtype == torch.float32 \
        else dict(rtol=2 ** -8, atol=1e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(exact.numpy() - want).max() > 1e-4


def test_bf16_compute_dtypes():
    model = TransformerLM(**CFG, attn="flash", dtype=torch.bfloat16,
                          head_dtype=torch.bfloat16, ln_dtype=torch.float32,
                          device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tokens = torch.randint(0, CFG["vocab"], (1, 64))
    with torch.no_grad():
        assert model(tokens, return_hidden=True).dtype == torch.float32
        assert model(tokens).dtype == torch.bfloat16


def test_seeded_init_is_reproducible_and_flax_scaled():
    a = TransformerLM(**CFG, attn="flash", seed=3, device="cpu")
    b = TransformerLM(**CFG, attn="flash", seed=3, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    C = CFG["dim"]
    std = a.block_0.fc1.kernel.std().item()
    assert abs(std - C ** -0.5) < 0.1 * C ** -0.5
    assert abs(a.tok_emb.embedding.std().item() - C ** -0.5) < 0.1 * C ** -0.5


@pytest.mark.parametrize("kw", [dict(attn="ring"), dict(attn="ulysses"),
                                dict(attn="full", tp_axis="tp")])
def test_unported_attention_paths_raise(kw):
    with pytest.raises(NotImplementedError):
        TransformerLM(**CFG, device="cpu", **kw)


def test_unknown_attention_raises():
    with pytest.raises(ValueError, match="unknown attention impl"):
        TransformerLM(**CFG, attn="nope", device="cpu")


def test_small_head_flash_model_matches_jax():
    """Head size 8 (dim 32, 4 heads, the reference's own case in
    ``tests/test_flash_attention.py``) takes ``flash_attention_auto`` in
    both packages; on the card the port runs it on the general flash
    kernels.  Same tokens, weights carried across: logits within 1e-5, and
    every parameter's gradient within 1e-5 of that tensor's largest entry
    (f32; each entry sums the 2 x 32 positions in another order, so its
    error scales with the tensor, whose entries reach ~40 here)."""
    cfg = dict(vocab=64, dim=32, depth=2, num_heads=4, max_len=32)
    jmodel = JaxLM(**cfg, attn="flash", dtype=jnp.float32,
                   head_dtype=jnp.float32, ln_dtype=jnp.float32)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg["vocab"], (2, 32)).astype(np.int32)
    g = rng.standard_normal((2, 32, cfg["vocab"])).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]

    def jloss(params):
        return (jmodel.apply({"params": params}, jnp.asarray(tokens))
                * jnp.asarray(g)).sum()

    want_logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
    want_grads = weights.from_flax(jax.tree.map(np.asarray,
                                                jax.grad(jloss)(params)))
    model = TransformerLM(**cfg, attn="flash", dtype=torch.float32,
                          head_dtype=torch.float32, ln_dtype=torch.float32,
                          device="cpu")
    weights.load_flax_params(model, jax.tree.map(np.asarray, params))
    logits = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5,
                               atol=1e-5)
    (logits * torch.from_numpy(g)).sum().backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(want_grads)
    for name, p in grads.items():
        want = np.asarray(want_grads[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
