"""The port's checkpoint chains and model save/load against the JAX
package's, on the CPU.

The chain format (``chain.json`` + ``shards.npz``) is the reference's:
the same flat state (f32, int32 and bf16 leaves, then a second epoch with
some leaves changed) goes through both packages' ``save_chain``; the
manifests must be equal but for the shard file's CRC32C (zip entries
carry timestamps), every stored leaf's bytes equal, and each package
reads the other's chain.  Torn chains (a missing base, a flipped byte)
raise the same ``TornChainError`` text in both, and ``latest_epoch`` /
``resolve_committed_epoch`` agree on the same directories.  Key strings
equal ``jax.tree_util.keystr``.  A TransformerLM's ``{"params": ...}``
crosses packages both ways with logits within 1e-5 (f32), a ResNet's
variables bit for bit.  ``save_model`` -> ``load_model`` from the
directory alone resumes training bit-identically, and
``restore_and_broadcast`` runs on two gloo ranks (the epoch agreed, the
torn-tip fallback taken by both, the world-size check).
"""

import collections
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu import checkpoint as ref
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.models.resnet import ResNet as JaxResNet
from horovod_tpu_torch import checkpoint, weights
from horovod_tpu_torch.models import ResNet, TransformerLM

LM_CFG = dict(vocab=64, dim=32, depth=2, num_heads=2, max_len=16)
TOL_LOGITS = 1e-5


@pytest.fixture()
def size1(monkeypatch):
    import horovod_tpu_torch as hvd
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                 "ELASTIC", "STANDBY", "FAULT"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _leaves(seed, changed=False):
    """numpy leaves (bf16 as ml_dtypes) of one epoch; ``changed`` moves
    ``a`` and ``c`` only."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.integers(-50, 50, (7,)).astype(np.int32)
    c = rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16)
    if changed:
        a = a * 2
        c = (c.astype(np.float32) + 1).astype(ml_dtypes.bfloat16)
    return {"a": a, "b": b, "c": c}


def _torch_tree(leaves):
    return {"a": torch.from_numpy(leaves["a"].copy()),
            "b": torch.from_numpy(leaves["b"].copy()),
            "c": torch.from_numpy(leaves["c"].view(np.int16).copy()).view(
                torch.bfloat16)}


def _write_both(tmp_path):
    """Two epochs of the same state through each package: (ref dir, port
    dir, ref flats, port flats)."""
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    flats_ref, flats_port = [], []
    for e, changed in enumerate((False, True)):
        leaves = _leaves(0, changed)
        fr = ref.flatten_state(leaves)
        fp = checkpoint.flatten_state(_torch_tree(leaves))
        ref.save_chain(d_ref, fr, e, prev_epoch=e - 1,
                       prev_flat=flats_ref[-1] if flats_ref else None)
        checkpoint.save_chain(d_port, fp, e, prev_epoch=e - 1,
                              prev_flat=flats_port[-1] if flats_port
                              else None)
        flats_ref.append(fr)
        flats_port.append(fp)
    return d_ref, d_port, flats_ref, flats_port


def _shard_leaves(d, e):
    path = os.path.join(ref.checkpoint_path(d, e), ref.CHAIN_SHARDS)
    with np.load(path, allow_pickle=False) as z:
        return {k: (z[k].dtype, z[k].shape, z[k].tobytes()) for k in z.files}


def test_chain_manifests_and_shards_match_the_reference(tmp_path):
    d_ref, d_port, _, _ = _write_both(tmp_path)
    for e in (0, 1):
        m_ref = ref._chain_manifest(d_ref, e)
        m_port = checkpoint._chain_manifest(d_port, e)
        assert isinstance(m_port.pop("crc32c"), int)
        m_ref.pop("crc32c")
        assert m_port == m_ref
        assert _shard_leaves(d_port, e) == _shard_leaves(d_ref, e)
    assert m_port["kind"] == "delta" and m_port["shards"] == ["['a']",
                                                              "['c']"]


def test_each_package_reads_the_others_chain(tmp_path):
    """The CRC32C check passes both ways; bf16 leaves cross as raw
    2-byte records (``V2``) and the port reinterprets them by the
    template's dtype."""
    d_ref, d_port, flats_ref, _ = _write_both(tmp_path)
    want = flats_ref[1]
    assert ref.latest_epoch(d_port) == 1 and checkpoint.latest_epoch(
        d_ref) == 1
    got = ref.read_chain_state(d_port, 1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()
    assert got["['c']"].dtype == np.dtype("V2")   # the reference's quirk
    got = checkpoint.read_chain_state(d_ref, 1)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    like = _torch_tree(_leaves(9))
    restored = checkpoint.restore(d_ref, 1, like)
    expect = _torch_tree(_leaves(0, changed=True))
    for k in expect:
        assert restored[k].dtype == expect[k].dtype
        assert torch.equal(restored[k].view(torch.uint8) if k == "c"
                           else restored[k],
                           expect[k].view(torch.uint8) if k == "c"
                           else expect[k])


def _torn_dirs(tmp_path):
    """Chains 0 (base) -> 1 -> 2 (deltas), and three damaged copies."""
    base = tmp_path / "intact"
    prev = None
    for e in range(3):
        flat = checkpoint.flatten_state(_torch_tree(_leaves(e)))
        checkpoint.save_chain(str(base), flat, e, prev_epoch=e - 1,
                              prev_flat=prev)
        prev = flat
    dirs = {"intact": str(base)}
    for name in ("no_base", "flipped", "debris"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(base, dirs[name])
    shutil.rmtree(ref.checkpoint_path(dirs["no_base"], 0))
    shard = os.path.join(ref.checkpoint_path(dirs["flipped"], 1),
                         ref.CHAIN_SHARDS)
    with open(shard, "r+b") as f:
        data = f.read()
        f.seek(len(data) // 2)
        f.write(bytes([data[len(data) // 2] ^ 0x5A]))
    os.makedirs(os.path.join(dirs["debris"], ".tmp-checkpoint-3-999"))
    with open(os.path.join(dirs["debris"], "checkpoint-4.world.json"),
              "w") as f:
        json.dump({"world_size": 2}, f)
    return dirs


@pytest.mark.parametrize("damage", ["no_base", "flipped"])
def test_torn_chain_raises_the_reference_text(tmp_path, damage):
    d = _torn_dirs(tmp_path)[damage]
    with pytest.raises(ref.TornChainError) as want:
        ref.read_chain_state(d, 2)
    with pytest.raises(checkpoint.TornChainError) as got:
        checkpoint.read_chain_state(d, 2)
    assert str(got.value) == str(want.value)


def test_latest_and_resolved_epochs_agree(tmp_path):
    for name, d in _torn_dirs(tmp_path).items():
        assert checkpoint.latest_epoch(d) == ref.latest_epoch(d), name
        for e in range(-1, 5):
            assert (checkpoint.resolve_committed_epoch(d, e)
                    == ref.resolve_committed_epoch(d, e)), (name, e)
    assert checkpoint.latest_epoch(str(tmp_path / "none")) == -1


NT = collections.namedtuple("NT", ["x", "y"])


def _key_tree(make):
    return {"params": {"block_0": {"kernel": make(0), "bias": make(1)}},
            "opt": [make(2), (make(3), {"mu": make(4), "nu": make(5)})],
            "state": {0: {"momentum_buffer": make(6)},
                      1: {"momentum_buffer": make(7)}},
            "steps": (make(8),), "none": None, "nt": NT(make(9), make(10)),
            "lr": 0.125}


def test_key_strings_equal_keystr():
    arrays = _key_tree(lambda i: np.full((2,), i, np.float32))
    tensors = _key_tree(lambda i: torch.full((2,), float(i)))
    want = ref.flatten_state(arrays)
    got = checkpoint.flatten_state(tensors)
    assert list(got) == list(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert "['state'][0]['momentum_buffer']" in got and "['nt'].y" in got
    back = checkpoint.unflatten_like(_key_tree(lambda i: torch.zeros(2)),
                                     got)
    assert back["state"][1]["momentum_buffer"].tolist() == [7.0, 7.0]
    assert isinstance(back["nt"], NT) and back["lr"] == 0.125


def test_snapshot_owns_its_bytes():
    """A CPU tensor's snapshot is a copy: an in-place update after
    ``flatten_state`` does not reach it."""
    w = torch.ones(4)
    flat = checkpoint.flatten_state({"w": w})
    w.add_(1)
    assert flat["['w']"].tolist() == [1.0] * 4


def test_to_flax_and_back_keep_tensors_where_they_lie():
    """A restored state's tensors load into the model from their device:
    ``from_flax`` takes tensors as they are (a meta tensor stands in for
    a CUDA one: neither converts to numpy), and inverts ``to_flax``,
    convolution kernels included."""
    state = {"conv.kernel": torch.randn(4, 3, 2, 2), "fc.bias": torch.ones(3),
             "on.device.w": torch.empty(2, device="meta")}
    tree = weights.to_flax(state)
    assert tree["conv"]["kernel"].shape == (2, 2, 3, 4)
    back = weights.from_flax(tree)
    assert back.keys() == state.keys()
    assert torch.equal(back["conv.kernel"], state["conv.kernel"])
    assert back["on.device.w"].device.type == "meta"


def _jax_lm():
    model = JaxLM(**LM_CFG, attn="full", dtype=jnp.float32,
                  head_dtype=jnp.float32, ln_dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(
        0, LM_CFG["vocab"], (2, LM_CFG["max_len"])).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return model, jax.tree.map(np.asarray, params), tokens


def _port_lm(seed=0):
    return TransformerLM(**LM_CFG, attn="full", dtype=torch.float32,
                         head_dtype=torch.float32, ln_dtype=torch.float32,
                         device="cpu", seed=seed)


def _port_logits(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens).long()).numpy()


def test_jax_lm_chain_restores_into_the_port(tmp_path):
    jmodel, params, tokens = _jax_lm()
    ref.save_chain(str(tmp_path), ref.flatten_state({"params": params}), 0)
    model = _port_lm(seed=7)
    like = {"params": weights.to_flax(dict(model.named_parameters()))}
    weights.load_flax_params(
        model, checkpoint.restore(str(tmp_path), 0, like)["params"])
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    np.testing.assert_allclose(_port_logits(model, tokens), want, rtol=0,
                               atol=TOL_LOGITS)


def test_port_lm_chain_restores_into_jax(tmp_path, size1):
    jmodel, params, tokens = _jax_lm()
    model = _port_lm(seed=3)
    checkpoint.save(str(tmp_path), {"params": weights.to_flax(
        dict(model.named_parameters()))}, 0)
    got = ref.restore(str(tmp_path), 0, {"params": params})["params"]
    logits = np.asarray(jmodel.apply({"params": got}, jnp.asarray(tokens)))
    np.testing.assert_allclose(logits, _port_logits(model, tokens), rtol=0,
                               atol=TOL_LOGITS)


def test_resnet_variables_cross_both_ways(tmp_path, size1):
    """Convolution kernels cross as flax's HWIO: a JAX ResNet's chain
    loads into the port bit for bit, and the port's chain gives JAX its
    variables back."""
    cfg = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
    images = np.zeros((1, 16, 16, 3), np.float32)
    v = jax.tree.map(np.asarray, JaxResNet(**cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(images), train=False))
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    ref.save_chain(str(tmp_path / "jax"), ref.flatten_state(variables), 0)
    model = ResNet(**cfg, device="cpu", seed=4)
    restored = checkpoint.restore(str(tmp_path / "jax"), 0,
                                  checkpoint.model_state(model))
    checkpoint.load_model_state(model, None, restored)
    want = weights.from_flax(v["params"])
    want.update(weights.from_flax(v["batch_stats"]))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    checkpoint.save(str(tmp_path / "port"), checkpoint.model_state(model), 0)
    back = ref.restore(str(tmp_path / "port"), 0, variables)
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        node = back
        for p in path:
            node = node[p.key]
        assert node.tobytes() == leaf.tobytes(), path


def _lm_loss(model, tokens):
    logits = model(tokens[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def _steps(model, opt, batches):
    losses = []
    for b in batches:
        opt.zero_grad()
        loss = _lm_loss(model, b)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_load_model_resumes_bit_identically(tmp_path, size1):
    """save_model after 3 steps, 2 more steps (run A); a fresh model and
    ``load_model`` from the directory alone, the same 2 steps (run B):
    losses and parameters bit-identical."""
    hvd = size1
    gen = torch.Generator().manual_seed(5)
    batches = [torch.randint(0, LM_CFG["vocab"], (2, LM_CFG["max_len"] + 1),
                             generator=gen) for _ in range(5)]
    model = _port_lm(seed=1)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.05, momentum=0.9))
    _steps(model, opt, batches[:3])
    d = str(tmp_path)
    hvd.save_model(d, model, opt, 3, optimizer=opt)
    assert json.loads(open(checkpoint._optimizer_spec_path(d, 3)).read())[
        "steps"][0][0] == "torch.optim.SGD"
    losses_a = _steps(model, opt, batches[3:])
    fresh = _port_lm(seed=2)
    fresh, opt_b, epoch = hvd.load_model(d, fresh)
    assert epoch == 3 and type(opt_b).__name__ == "DistributedSGD"
    losses_b = _steps(fresh, opt_b, batches[3:])
    assert losses_b == losses_a
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name


def test_optimizer_spec_errors():
    with pytest.raises(TypeError, match="not a chain"):
        checkpoint.OptimizerSpec.chain(("torch.optim.SGD", {"lr": 0.1}))
    with pytest.raises(ValueError, match="neither a torch.optim"):
        checkpoint.OptimizerSpec.of("os.system", command="true").build([])
    with pytest.raises(TypeError, match="OptimizerSpec"):
        checkpoint._as_optimizer_spec(object())


def test_legacy_orbax_epoch_names_the_format(tmp_path):
    os.makedirs(ref.checkpoint_path(str(tmp_path), 0))
    assert checkpoint.latest_epoch(str(tmp_path)) == 0
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.restore(str(tmp_path), 0, {"w": torch.zeros(1)})


@pytest.fixture(scope="module")
def restore_job(tmp_path_factory):
    from _torch_eager_worker import free_port, spawn
    from _torch_resilience_worker import restore_cases
    from horovod_tpu_torch import cpp_core
    assert cpp_core.available()      # built once, before the workers load it
    env = {"HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{free_port()}",
           "HOROVOD_TPU_CONTROL_TIMEOUT_S": "20",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2",
           "TEST_CKPT_DIR": str(tmp_path_factory.mktemp("ckpt"))}
    with pytest.MonkeyPatch.context() as mp:
        for knob in ("FAULT", "TIMELINE", "ELASTIC", "STANDBY",
                     "LOCAL_RANK", "NO_CPP"):
            mp.delenv("HOROVOD_TPU_" + knob, raising=False)
        got = spawn(restore_cases, 2, env)
    assert got["exit"] == [0, 0], got
    return {r: {m[0]: m[1:] for m in got[r]} for r in range(2)}


@pytest.mark.parametrize("rank", [0, 1])
def test_restore_and_broadcast_on_two_ranks(restore_job, rank):
    """The epoch is rank 0's scan (epoch 3 is corrupt, so 2) on both
    ranks; an explicit torn tip falls back to 2 on both; a resized world
    restores replicated state; a DTensor shard raises naming its leaf."""
    from _torch_resilience_worker import chain_state, digest
    got = restore_job[rank]
    want = digest(chain_state(2))
    assert got["scan"] == (2, want, 0.25)
    assert got["explicit"] == (2, want)
    assert got["resized"] == (2, want)
    msg = got["sharded"][0]
    assert "['w']" in msg and "sharded" in msg and "world size 3" in msg
