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


# ----------------------------------------- sequence and tensor parallel
#
# Four gloo processes (``_torch_parallel_worker.transformer_worker``,
# spawned once per session) run the same models as the JAX package does on
# four of the conftest's CPU devices: the four sequence-parallel modes on
# an ``('sp',)`` mesh (loss and gradients), a (dp 2, sp 2) ring-attention
# train step through ``make_train_step`` with Adam (``tests/
# test_transformer.py:142``'s), and ``tp_axis`` on (dp 2, tp 2) through
# ``tp_value_and_grad``.  All within 1e-5 relative (Frobenius, f32).

SP_ATTNS = ("ring", "ring_zigzag", "ulysses", "ulysses_flash")
SP_CFG = dict(vocab=64, dim=64, depth=2, num_heads=4, max_len=64)
SP_T, SP_N = 16, 4
DPSP_CFG = dict(vocab=64, dim=32, depth=2, num_heads=4, max_len=32)
DPSP_STEPS = 3
TP_CFG = dict(vocab=64, dim=32, depth=2, num_heads=4, max_len=32)
PAR_TOL = 1e-5


def _tokens(batch, seq, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _xent(logits, labels):
    import optax
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()


def _sp_problem(attn):
    from horovod_tpu.parallel.ring_attention import zigzag_indices
    twin = JaxLM(**SP_CFG, attn="full", dtype=jnp.float32)
    params = jax.tree.map(np.asarray, twin.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    tokens, labels = _tokens(2, SP_T, SP_CFG["vocab"], 4)
    if attn == "ring_zigzag":
        idx = zigzag_indices(SP_N, SP_T)
        tokens, labels = tokens[:, idx], labels[:, idx]
    return params, tokens, labels


def _jax_sp(attn):
    from jax.sharding import Mesh, PartitionSpec as P
    params, tokens, labels = _sp_problem(attn)
    model = JaxLM(**SP_CFG, attn=attn, sp_axis="sp", dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:SP_N]), ("sp",))

    def body(params, tokens, labels):
        return _xent(model.apply({"params": params}, tokens), labels)[None]

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(P(), P(None, "sp"), P(None, "sp")),
                      out_specs=P("sp"), check_vma=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: f(p, tokens, labels).mean()))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _dpsp_problem():
    twin = JaxLM(**DPSP_CFG, attn="full", dtype=jnp.float32)
    params = jax.tree.map(np.asarray, twin.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    steps = [_tokens(4, 8, DPSP_CFG["vocab"], 10 + i)
             for i in range(DPSP_STEPS)]
    return params, steps


def _jax_dpsp():
    """The JAX package's dp x sp step (``tests/test_transformer.py:142``):
    ring attention, gradients pmean'd over (dp, sp), Adam 1e-2."""
    import optax
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    params, steps = _dpsp_problem()
    model = JaxLM(**DPSP_CFG, attn="ring", sp_axis="sp", dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    tx = optax.adam(1e-2)

    def step(params, opt_state, tokens, labels):
        loss, grads = jax.value_and_grad(lambda p: _xent(
            model.apply({"params": p}, tokens), labels))(params)
        grads = jax.tree.map(lambda g: lax.pmean(g, ("dp", "sp")), grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                lax.pmean(loss, ("dp", "sp")))

    fn = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(), P(), P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(), P(), P()), check_vma=False))
    opt_state = tx.init(params)
    losses = []
    for tokens, labels in steps:
        params, opt_state, loss = fn(params, opt_state, tokens, labels)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _jax_tp():
    """(params, tokens, labels, loss, grads) of the JAX package's
    ``tp_axis`` model on (dp 2, tp 2), globals laid out by
    ``tp_spec_tree``."""
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel.tensor_parallel import (
        tp_abstract_params, tp_spec_tree, tp_value_and_grad)
    model = JaxLM(**TP_CFG, tp_axis="tp", dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    tokens, labels = _tokens(4, 8, TP_CFG["vocab"], 21)
    specs = tp_spec_tree(tp_abstract_params(
        lambda: model.init(jax.random.PRNGKey(5),
                           jnp.zeros((2, 8), jnp.int32))["params"], 2))

    def body(tokens, labels):
        params = model.init(jax.random.PRNGKey(5), tokens)["params"]
        loss, grads = tp_value_and_grad(lambda p: _xent(
            model.apply({"params": p}, tokens), labels), params,
            dp_axes=("dp",))
        return params, loss, grads

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P("dp"), P("dp")),
                              out_specs=(specs, P(), specs),
                              check_vma=True))
    params, loss, grads = jax.tree.map(np.asarray, f(tokens, labels))
    return params, tokens, labels, float(loss), grads


@pytest.fixture(scope="module")
def jax_parallel():
    return {"sp": {a: _jax_sp(a) for a in SP_ATTNS}, "dpsp": _jax_dpsp(),
            "tp": _jax_tp()}


@pytest.fixture(scope="module")
def torch_parallel(request, tmp_path_factory, jax_parallel):
    from _torch_parallel_worker import transformer_worker
    from _torch_spmd_worker import once, run_group
    sp = {a: (SP_CFG, *_sp_problem(a)) for a in SP_ATTNS}
    params, steps = _dpsp_problem()
    tp_params, tokens, labels, _, _ = jax_parallel["tp"]
    return once(request, tmp_path_factory, "transformer_parallel",
                lambda: run_group(transformer_worker, 4, sp,
                                  (DPSP_CFG, params, steps),
                                  (TP_CFG, tp_params, tokens, labels)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("attn", SP_ATTNS)
def test_sequence_parallel_model_matches_jax(torch_parallel, jax_parallel,
                                             attn):
    loss, grads = jax_parallel["sp"][attn]
    want = {k: v.numpy() for k, v in weights.from_flax(grads).items()}
    for r in range(4):
        got_loss, got = torch_parallel[r][("sp", attn)]
        assert got_loss == pytest.approx(loss, rel=PAR_TOL)
        assert set(got) == set(want)
        for name, g in got.items():
            assert _rel(g, want[name]) <= PAR_TOL, (attn, r, name)


def test_dp_sp_train_step_matches_jax(torch_parallel, jax_parallel):
    losses, params = jax_parallel["dpsp"]
    want = {k: v.numpy() for k, v in weights.from_flax(params).items()}
    for r in range(4):
        got_losses, got = torch_parallel[r]["dpsp"]
        np.testing.assert_allclose(got_losses, losses, rtol=PAR_TOL)
        for name, p in got.items():
            assert _rel(p, want[name]) <= PAR_TOL, (r, name)


def test_tensor_parallel_model_matches_jax(torch_parallel, jax_parallel):
    _, _, _, loss, grads = jax_parallel["tp"]
    for r in range(4):
        got_loss, got = torch_parallel[r]["tp"]
        assert got_loss == pytest.approx(loss, rel=PAR_TOL)
        want = {k: v.numpy() for k, v in weights.from_flax(
            weights.tp_shard_tree(grads, r % 2, 2)).items()}
        assert set(got) == set(want)
        for name, g in got.items():
            assert _rel(g, want[name]) <= PAR_TOL, (r, name)


@pytest.mark.parametrize("attn", ["flash", "ring", "ulysses_flash"])
def test_tp_with_other_attention_raises_the_reference_error(attn):
    jmodel = JaxLM(**CFG, attn=attn, tp_axis="tp")
    with pytest.raises(ValueError) as want:
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError) as got:
        TransformerLM(**CFG, attn=attn, tp_axis="tp", device="cpu")
    assert str(got.value) == str(want.value)


def test_sequence_parallel_models_share_the_full_tree():
    """Same names, shapes and draws from the same seed as attn="full"."""
    full = TransformerLM(**CFG, attn="full", seed=4, device="cpu")
    for attn in SP_ATTNS:
        sp = TransformerLM(**CFG, attn=attn, seed=4, device="cpu")
        for (n, p), (m, q) in zip(full.state_dict().items(),
                                  sp.state_dict().items()):
            assert n == m and torch.equal(p, q), (attn, n)


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
