"""The port's precision autopilot (``horovod_tpu_torch/precision.py``, the
``"auto"`` routes of ``spmd`` and ``optimizer``, the request frame's
precision extension in ``core``), held against the JAX package.

* The wire: the port's request frames with and without
  ``FLAG_PRECISION_EXT`` byte-identical to the reference's, through the
  native codec too; the controller's tick attaches the drained reports
  (and nothing with the autopilot off).
* ``PrecisionAutopilot``: queue and drain, ``plan_version`` bumping on
  level edges only, against the reference's on the same sequence; the
  residual a reduced leaf reports (``_note_auto_residual``) against the
  reference's on the same arrays.
* The local response cache replays a stamped wire dtype as a copy and
  drops it on flush; the three wire-name canonicalisers agree.
* Bucket names: ``grads`` + the keystr of the flax path, built from the
  port's parameter names, equal to ``jax.tree_util.keystr`` of the same
  leaves.
* One 2-process gloo job over the native coordinator
  (``_torch_precision_worker``), autopilot armed: ``reduce_gradients``
  (flat and two-tier), ``allreduce_gradients``' SPMD branch and one step
  of ``DistributedOptimizer``'s, its buckets named by
  ``named_parameters``, under ``"auto"`` against the reference's in
  ``shard_map`` on per-rank inputs
  (``in_specs=P("ranks")``; the reference's replicated-input test takes
  its pre-summed branch instead), bit for bit; a small TransformerLM
  ``make_train_step(compression="auto")`` against the reference's on a
  2-device mesh, both ladders warmed on the same names (first loss and
  update within 1e-5); the eager branch with overlap: the residual
  reports reach the coordinator, every rank sees the same stamp, and
  the host ring applies it (bit-identical to a static allreduce of the
  same bucket on that wire).

The JAX side runs its int8 ring with the jnp codec
(``HOROVOD_TPU_INJIT_PALLAS=0``) and without XLA's fusion pass, as
``test_torch_distributed_optimizer.py`` explains.
"""

import fcntl
import pickle
import struct
from collections import Counter

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu  # noqa: F401  (jax.shard_map on this jax)
from horovod_tpu import core as ref_core
from horovod_tpu import jax as hvd_jax
from horovod_tpu import precision as ref_precision
from horovod_tpu import wire as ref_wire
from horovod_tpu.compression import canonical_wire_dtype as ref_canonical
from horovod_tpu.jax import spmd as ref_spmd
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.ops import quantized_collectives as jqc
from horovod_tpu.ops.losses import fused_softmax_xent as jax_xent
import horovod_tpu_torch as hvd
from horovod_tpu_torch import core, cpp_core, precision, wire
from horovod_tpu_torch.compression import canonical_wire_dtype
from horovod_tpu_torch.models import TransformerLM
from horovod_tpu_torch.ops import quantized_collectives as tqc
from horovod_tpu_torch.optimizer import _note_auto_residual
from horovod_tpu_torch.spmd import bucket_names, flax_keystr, \
    make_train_step

import _torch_precision_worker as W
from _torch_eager_worker import free_port, spawn

UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def _arm(monkeypatch, ticks="3", threshold="0.05"):
    monkeypatch.setenv("HOROVOD_TPU_PRECISION", "auto")
    monkeypatch.setenv("HOROVOD_TPU_PRECISION_TICKS", ticks)
    monkeypatch.setenv("HOROVOD_TPU_PRECISION_THRESHOLD", threshold)
    precision.reset_autopilot()
    ref_precision.reset_autopilot()


@pytest.fixture(autouse=True)
def _fresh_autopilots():
    yield
    precision.reset_autopilot()
    ref_precision.reset_autopilot()


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# ------------------------------------------------------------------- wire

def _req(mod, rank=0, name="t", shape=(4, 2), wire_dtype=""):
    return mod.Request(request_rank=rank,
                       request_type=mod.RequestType.ALLREDUCE,
                       tensor_name=name, tensor_type="float32",
                       tensor_shape=tuple(shape), root_rank=-1, device=rank,
                       wire_dtype=wire_dtype)


REPORTS = [("grads['w']", 0.1 + 0.2), ("β/bucket0", 2.0 ** -52),
           ("z", 0.0), ("DistributedOptimizer.grads.bucket3", 1e-300)]


@pytest.mark.parametrize("form", ["bare", "precision", "all_exts",
                                  "shutdown"])
def test_request_frames_byte_identical_to_reference(form):
    def frame(w, mod):
        kw = {}
        if form in ("precision", "all_exts"):
            kw["precision_ext"] = w.RequestPrecisionExt(reports=REPORTS)
        if form == "all_exts":
            kw["cache_ext"] = w.RequestCacheExt(epoch=7, bits=b"\x05")
            kw["elastic_ext"] = w.RequestElasticExt(generation=3)
        if form == "shutdown":
            kw["shutdown"] = True
        return w.serialize_request_list(
            [_req(mod, 0, "grads['w']"), _req(mod, 1, "grads['w']")], **kw)

    blob = frame(wire, core)
    assert blob == frame(ref_wire, ref_core)
    assert bool(blob[0] & wire.FLAG_PRECISION_EXT) == (
        form in ("precision", "all_exts"))
    *_, prec = wire.parse_request_list_precision(blob)
    if form in ("precision", "all_exts"):
        assert prec.reports == REPORTS
        for (_, a), (_, b) in zip(prec.reports, REPORTS):
            assert struct.pack("<d", a) == struct.pack("<d", b)
    else:
        assert prec is None
    # The precision-agnostic parser keeps reading frames with the ext.
    parsed, *_ = wire.parse_request_list_elastic(blob)
    assert [p.tensor_name for p in parsed] == ["grads['w']"] * 2
    if cpp_core.available():
        assert cpp_core.wire_request_list_roundtrip(blob) == blob
    with pytest.raises((ValueError, struct.error)):
        if form in ("precision", "all_exts"):
            wire.parse_request_list_precision(blob[:-4])
        else:
            raise ValueError("nothing to truncate")


class _FakePlane:
    """The native plane's ``tick`` as the controller calls it: keeps the
    request frame and answers with an empty response list."""

    def __init__(self):
        self.frames = []

    def tick(self, blob, fusion_threshold):
        self.frames.append(blob)
        return wire.serialize_response_list([])


def _tick(pending, shutting=False):
    """One ``Controller._run_loop_once_distributed`` on a controller whose
    plane is a fake; the frame it sent."""
    import collections
    import threading
    ctl = core.Controller.__new__(core.Controller)
    ctl._lock = threading.Lock()
    ctl._message_queue = collections.deque(pending)
    ctl._pending_report = None
    ctl._control = _FakePlane()
    ctl._tensor_table = {}
    ctl.fusion_threshold = 0
    ctl.timeline = None
    ctl._execute_ready = lambda ready: None
    ctl._maybe_check_stalls_distributed = lambda: None
    ctl._tick_telemetry = lambda: None
    ctl._run_loop_once_distributed(shutting)
    return ctl._control.frames[0]


@pytest.mark.parametrize("armed", [False, True])
def test_controller_tick_attaches_drained_reports(monkeypatch, armed):
    if armed:
        _arm(monkeypatch)
    else:
        monkeypatch.delenv("HOROVOD_TPU_PRECISION", raising=False)
        precision.reset_autopilot()
    pilot = precision.get_autopilot()
    pilot.note_residual("grads['w']", 0.02)
    pilot.note_residual("a", 0.01)
    pending = [_req(core, 0, "grads['w']")]
    blob = _tick(pending)
    want_ext = (ref_wire.RequestPrecisionExt(
        reports=[("a", 0.01), ("grads['w']", 0.02)]) if armed else None)
    assert blob == ref_wire.serialize_request_list(
        [_req(ref_core, 0, "grads['w']")], precision_ext=want_ext)
    assert pilot.drain_reports() == []
    # A tick without reports (and the shutdown tick) carries no ext.
    pilot.note_residual("b", 0.03)
    assert _tick([], shutting=True) == ref_wire.serialize_request_list(
        [], shutdown=True)
    assert _tick([]) == ref_wire.serialize_request_list(
        [], precision_ext=ref_wire.RequestPrecisionExt(
            reports=[("b", 0.03)]) if armed else None)


# ------------------------------------------------------------ autopilot

_SEQ = [("b", 0.02), ("a", 0.01), ("b", 0.03), ("c", -1.0), ("b", 0.01),
        ("b", 0.9), ("a", 0.01), ("a", 0.01), ("a", 0.01)]


@pytest.mark.parametrize("armed", [False, True])
def test_autopilot_matches_reference(monkeypatch, armed):
    if armed:
        _arm(monkeypatch, ticks="2")
    else:
        monkeypatch.delenv("HOROVOD_TPU_PRECISION", raising=False)
        precision.reset_autopilot()
        ref_precision.reset_autopilot()
    pilots = (precision.get_autopilot(), ref_precision.get_autopilot())
    assert precision.get_autopilot() is pilots[0]

    def state(p):
        return (p.enabled, p.plan_version, p.promotions, p.demotions,
                [(p.wire_dtype_for(n), p.level_for(n), p.ewma_for(n))
                 for n in "abc"])

    versions = []
    for i, (name, r) in enumerate(_SEQ):
        for p in pilots:
            p.note_residual(name, r)
        assert state(pilots[0]) == state(pilots[1])
        versions.append(pilots[0].plan_version)
        if i in (2, 8):
            assert pilots[0].drain_reports() == pilots[1].drain_reports()
    for p in pilots:
        p.note_bandwidth(1e12)
    assert state(pilots[0]) == state(pilots[1])
    if armed:
        # Bumped on the level edges only: b up at its 2nd healthy report,
        # up again, down on the spike; a up twice.
        assert versions == [0, 0, 1, 1, 1, 2, 3, 3, 4]
    else:
        assert versions == [0] * len(_SEQ)
        assert pilots[0].drain_reports() == []
    precision.reset_autopilot()
    assert precision.get_autopilot() is not pilots[0]


def test_precision_auto_initializes(monkeypatch):
    """``HOROVOD_TPU_PRECISION=auto`` no longer refuses ``hvd.init``."""
    for var in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
                "WIRE_DTYPE", "FAULT"):
        monkeypatch.delenv("HOROVOD_TPU_" + var, raising=False)
    _arm(monkeypatch)
    hvd.shutdown()
    try:
        hvd.init(device="cpu")
        assert hvd.is_initialized()
        assert precision.get_autopilot().enabled
        out = hvd.allreduce(torch.ones(3), name="auto.init")
        assert torch.equal(out, torch.ones(3))
    finally:
        hvd.shutdown()


def _residual_leaves():
    rng = np.random.RandomState(3)
    spike = np.zeros((33, 31), np.float32)
    spike[0] = 300.0
    spike[1:] = rng.randn(32, 31)
    return {"w": rng.randn(64, 300).astype(np.float32),
            "spike": spike,
            "small": rng.randn(8, 8).astype(np.float32),
            "flat": rng.randn(70000).astype(np.float32),
            "zero": np.zeros((128, 128), np.float32),
            "half": rng.randn(128, 160).astype(np.float16)}


@pytest.mark.parametrize("floor", [None, "0"])
def test_residual_reports_match_reference(monkeypatch, floor):
    """``_note_auto_residual`` on the same reduced leaves: the same
    buckets report (f32, int8-eligible; with ``flat_ok`` the size floor
    only) with the same residual, to float32 rounding of the norms."""
    _arm(monkeypatch)
    monkeypatch.setenv("HOROVOD_TPU_INJIT_PALLAS", "0")
    if floor is None:
        monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_INJIT_INT8_FLOOR", floor)
    for name, x in _residual_leaves().items():
        for flat_ok in (False, True):
            _note_auto_residual(f"{name}.{flat_ok}", torch.from_numpy(x),
                                flat_ok=flat_ok)
            hvd_jax._note_auto_residual(f"{name}.{flat_ok}", jnp.asarray(x),
                                        flat_ok=flat_ok)
    got = precision.get_autopilot().drain_reports()
    want = ref_precision.get_autopilot().drain_reports()
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-9), name
    names = {n for n, _ in got}
    assert "half.False" not in names and "flat.False" not in names
    assert dict(got)["zero.True"] == 0.0
    # The spike leaf (4 KB) is under the default 64 KiB floor.
    assert ("spike.False" in names) == (floor == "0")
    if floor == "0":
        assert dict(got)["spike.False"] > 0.01


# ----------------------------------------------------------- cache replay

def _fused(mod, names, wire_dtype):
    return [mod.Response(mod.ResponseType.ALLREDUCE, list(names),
                         devices=[0], tensor_sizes=[8] * len(names),
                         wire_dtype=wire_dtype)]


@pytest.mark.parametrize("mod", [core, ref_core], ids=["port", "jax"])
def test_cache_replays_stamp_as_copy_and_flush_drops_it(mod):
    cache = mod._LocalResponseCache(capacity=8)
    pending = [_req(mod, name="grads['w']")]
    assert cache.lookup(pending, table_empty=True) is None
    cache.store(pending, _fused(mod, ["grads['w']"], "bf16"))
    out = cache.lookup(pending, table_empty=True)
    assert out is not None and out[0].wire_dtype == "bf16"
    out[0].wire_dtype = "int8"                # a copy: the stamp survives
    assert cache.lookup(pending, table_empty=True)[0].wire_dtype == "bf16"
    assert cache.lookup(pending, table_empty=False) is None
    cache.flush()
    assert cache.lookup(pending, table_empty=True) is None


# ---------------------------------------------------------- canonicalise

_ALIASES = ["", "none", "fp32", "float32", "bf16", "bfloat16", "fp16",
            "float16", "int8", " BF16 ", "int4", "auto", "q4"]


@pytest.mark.parametrize("name", _ALIASES)
def test_three_canonicalisers_match_reference(monkeypatch, name):
    def outcome(fn):
        try:
            r = fn()
        except ValueError as e:
            return ("error", str(e))
        return ("ok", r if isinstance(r, str) else r.__name__)

    pairs = [
        (lambda: core.normalize_wire_dtype(name),
         lambda: ref_core.normalize_wire_dtype(name)),
        (lambda: canonical_wire_dtype(name),
         lambda: ref_canonical(name)),
        (lambda: tqc.resolve_injit_compression(name),
         lambda: jqc.resolve_injit_compression(name))]
    for mine, theirs in pairs:
        assert outcome(mine) == outcome(theirs)
    monkeypatch.setenv("HOROVOD_TPU_WIRE_DTYPE", name)
    assert outcome(core.default_wire_dtype) == \
        outcome(ref_core.default_wire_dtype)
    monkeypatch.setenv("HOROVOD_TPU_INJIT_WIRE_DTYPE", name)
    from horovod_tpu.compression import NoneCompressor as JNone
    from horovod_tpu_torch.compression import NoneCompressor as TNone
    assert outcome(lambda: tqc.resolve_injit_compression(TNone)) == \
        outcome(lambda: jqc.resolve_injit_compression(JNone))


# ---------------------------------------------------------- bucket names

LM_SMALL = dict(vocab=64, dim=32, depth=2, num_heads=2, max_len=16,
                attn="full")


def test_bucket_names_are_the_reference_keystr():
    """``grads`` + the keystr of the flax path, built from the port's
    parameter names, equals ``jax.tree_util.keystr`` of each leaf of the
    reference's params tree; a list keys by index."""
    jmodel = JaxLM(**LM_SMALL, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    want = sorted(f"grads{jtu.keystr(p)}"
                  for p, _ in jtu.tree_flatten_with_path(params)[0])
    model = TransformerLM(**LM_SMALL, dtype=torch.float32, device="cpu")
    got = sorted(bucket_names([n for n, _ in model.named_parameters()]))
    assert got == want
    assert flax_keystr("block_0.attn.qkv.kernel") == \
        jtu.keystr((jtu.DictKey("block_0"), jtu.DictKey("attn"),
                    jtu.DictKey("qkv"), jtu.DictKey("kernel")))
    assert bucket_names(3) == [f"grads{jtu.keystr((jtu.SequenceKey(i),))}"
                               for i in range(3)]


def test_make_train_step_rebuilds_only_when_the_plan_moves(monkeypatch):
    """One process: each call reads ``plan_version``; the route is
    rebuilt when it has moved (a promotion, a demotion), never inside a
    call, and holds the mirror's wire of every bucket."""
    _arm(monkeypatch, ticks="2")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 4),
                                torch.nn.Linear(4, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_train_step(model, lambda m, b: m(b).pow(2).mean(), opt,
                           compression="auto")
    x = torch.ones(3, 8)
    pilot = precision.get_autopilot()
    step(x)
    step(x)
    assert step.rebuilds == 1 and set(step.route.values()) == {""}
    assert sorted(step.route) == sorted(
        ["grads['0']['weight']", "grads['0']['bias']",
         "grads['1']['weight']", "grads['1']['bias']"])
    pilot.note_residual("grads['0']['weight']", 0.001)
    step(x)
    assert step.rebuilds == 1              # no level moved
    pilot.note_residual("grads['0']['weight']", 0.001)
    step(x)
    assert step.rebuilds == 2
    assert step.route["grads['0']['weight']"] == "bf16"
    pilot.note_residual("grads['0']['weight']", 0.9)
    step(x)
    assert step.rebuilds == 3 and step.route["grads['0']['weight']"] == ""


# ---------------------------------------------- the 2-process gloo job

def _once(request, tmp_path_factory, name, fn):
    root = tmp_path_factory.getbasetemp()
    if hasattr(request.config, "workerinput"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(fn(root)))
        return pickle.loads(path.read_bytes())


def _lm_params():
    jmodel = JaxLM(**W.LM_CFG, dtype=jnp.float32, head_dtype=jnp.float32,
                   ln_dtype=jnp.float32)
    tokens = W.lm_tokens()
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(tokens[:, :-1]))["params"]
    return jmodel, jax.tree.map(np.asarray, params)


def _job(root):
    _, params = _lm_params()
    path = root / "precision_lm_params.pkl"
    path.write_bytes(pickle.dumps(params))
    env = dict(W.JOB_ENV, TEST_LM_PARAMS=str(path),
               HOROVOD_TPU_COORD_ADDR=f"127.0.0.1:{free_port()}")
    got = spawn(W.precision_cases, W.N, env, timeout=240,
                fingerprints=W.FINGERPRINTS)
    assert got["exit"] == [0] * W.N, got["exit"]
    return {r: {m[0]: m[1:] for m in got[r]} for r in range(W.N)}


@pytest.fixture(scope="module")
def job(request, tmp_path_factory):
    return _once(request, tmp_path_factory, "precision_job", _job)


@pytest.fixture()
def ref_auto(monkeypatch):
    """The reference's autopilot armed as the job's, with the jnp codec."""
    for k, v in W.JOB_ENV.items():
        if k.startswith("HOROVOD_TPU_PRECISION") or k.endswith("PALLAS"):
            monkeypatch.setenv(k, v)
    monkeypatch.delenv("HOROVOD_TPU_INJIT_INT8_FLOOR", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_INJIT_WIRE_DTYPE", raising=False)
    ref_precision.reset_autopilot()
    return ref_precision.get_autopilot()


def _stacked():
    per = [W.leaf_grads(r) for r in range(W.N)]
    return {k: np.stack([p[k] for p in per]) for k in W.LEAVES}


def _ref_spmd(fn, mesh_shape, axes, spec):
    mesh = Mesh(np.array(jax.devices()[:W.N]).reshape(mesh_shape), axes)
    x = _stacked()
    f = jax.jit(jax.shard_map(
        lambda g: fn(jax.tree.map(lambda v: v.reshape(v.shape[1:]), g)),
        mesh=mesh, in_specs=(P(spec),), out_specs=P()))
    return jax.tree.map(np.asarray,
                        f.lower(x).compile(compiler_options=UNFUSED)(x))


def _hold_bits(got, want, label):
    for r in range(W.N):
        for k, (a, b) in enumerate(zip(got[r], want)):
            assert a.shape == b.shape and a.dtype == np.float32
            assert np.array_equal(_bits(a), _bits(b)), (label, r, k)


def test_job_is_armed(job):
    assert all(job[r]["armed"] == (True,) for r in range(W.N))


def test_reduce_gradients_auto_matches_reference(job, ref_auto):
    W.warm(ref_auto, W.spmd_names("grads", keyed=False))
    want = _ref_spmd(lambda g: ref_spmd.reduce_gradients(
        list(g.values()), ("ranks",), compression="auto"),
        (W.N,), ("ranks",), "ranks")
    _hold_bits({r: job[r]["rg"][0] for r in range(W.N)}, want, "flat")
    # The rungs showed: a (int8 ring) and b (bf16) are not the f32 mean,
    # c (int8 rung, 1-D: raw) and d (fp32) are.
    mean = {k: v.mean(0) for k, v in _stacked().items()}
    got = dict(zip(W.LEAVES, job[0]["rg"][0]))
    for k in W.LEAVES:
        exact = np.array_equal(got[k], mean[k].astype(np.float32))
        assert exact == (k in ("c", "d")), k
    np.testing.assert_allclose(got["a"], mean["a"], rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got["b"], mean["b"], rtol=1e-2, atol=1e-2)


def test_allreduce_gradients_auto_spmd_matches_reference(job, ref_auto):
    W.warm(ref_auto, W.spmd_names("DistributedOptimizer.grads", keyed=True))
    want = _ref_spmd(lambda g: hvd_jax.allreduce_gradients(
        g, axis_name="ranks", compression="auto"),
        (W.N,), ("ranks",), "ranks")
    _hold_bits({r: [job[r]["ag"][0][k] for k in W.LEAVES]
                for r in range(W.N)},
               [want[k] for k in W.LEAVES], "tree")


def test_distributed_optimizer_auto_spmd_matches_reference(job, ref_auto):
    """DistributedOptimizer's SPMD branch under "auto", its buckets named
    by ``named_parameters``: one SGD step (lr 1, from ones: from zeros
    XLA folds ``0 + u`` to ``u`` and keeps a -0.0 that PyTorch's sum
    does not) against the reference's optimizer on the flax tree of the
    same leaves, bit for bit, the int8 and bf16 rungs showing."""
    W.warm(ref_auto, W.spmd_names("DistributedOptimizer.grads", keyed=True))
    W.warm(ref_auto, W.opt_names("DistributedOptimizer.grads"))
    tx = hvd_jax.DistributedOptimizer(optax.sgd(1.0), compression="auto")

    def fn(g):
        tree = W.opt_tree(g)
        params = jax.tree.map(lambda v: jnp.ones(v.shape, v.dtype), tree)
        updates, _ = tx.update(tree, tx.init(params), params)
        new = optax.apply_updates(params, updates)
        return {"a": new["blk"]["a"], "b": new["blk"]["b"], "c": new["c"],
                "d": new["d"]}

    want = _ref_spmd(fn, (W.N,), ("ranks",), "ranks")
    _hold_bits({r: [job[r]["opt"][0][k] for k in W.LEAVES]
                for r in range(W.N)},
               [want[k] for k in W.LEAVES], "optimizer")
    mean = {k: v.mean(0) for k, v in _stacked().items()}
    for k in W.LEAVES:
        exact = np.array_equal(job[0]["opt"][0][k],
                               np.float32(1) - mean[k].astype(np.float32))
        assert exact == (k in ("c", "d")), k


def test_reduce_gradients_auto_two_tier_matches_reference(job, ref_auto):
    W.warm(ref_auto, W.spmd_names("grads", keyed=False))
    assert job[0]["mesh"][0] == (2, 1)
    want = _ref_spmd(lambda g: ref_spmd.reduce_gradients(
        list(g.values()), ("dcn", "ici"), compression="auto"),
        (W.N, 1), ("dcn", "ici"), ("dcn", "ici"))
    _hold_bits({r: job[r]["mesh"][1] for r in range(W.N)}, want, "mesh")


def test_make_train_step_auto_matches_reference(job, ref_auto):
    jmodel, params = _lm_params()
    for name, n in W.LM_REPORTS.items():
        for _ in range(n):
            ref_auto.note_residual(name, W.HEALTHY)

    def jloss(p, aux, batch):
        h = jmodel.apply({"params": p}, batch[:, :-1], return_hidden=True)
        return jax_xent(h.reshape(-1, W.LM_CFG["dim"]), p["head"]["kernel"],
                        batch[:, 1:].reshape(-1)).mean(), aux

    tx = optax.sgd(W.LM_LR, momentum=W.LM_MOMENTUM)
    mesh = Mesh(np.array(jax.devices()[:W.N]), ("ranks",))
    jstep = ref_spmd.make_train_step(jloss, tx, mesh, compression="auto")
    p = jax.tree.map(jnp.array, params)
    p, _, _, loss = jstep(p, {}, tx.init(p), jnp.asarray(W.lm_tokens()))
    from horovod_tpu_torch import weights
    want = weights.from_flax(jax.tree.map(np.asarray, p))
    levels = Counter()
    for r in range(W.N):
        got_loss, route, rebuilds, state = job[r]["lm"]
        assert got_loss == pytest.approx(float(loss), rel=1e-5)
        assert rebuilds == 1
        for name, wire_ in route.items():
            assert wire_ == ref_auto.wire_dtype_for(name), name
            levels[wire_] += r == 0
        assert state.keys() == want.keys()
        for name, value in want.items():
            np.testing.assert_allclose(state[name], value.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
    # int8 on qkv and tok_emb, bf16 on head and fc1; the 1-D ln1 scale's
    # int8 rung goes raw.
    assert levels == Counter({"int8": 3, "bf16": 2, "": 10})


def test_eager_auto_stamps_apply_on_the_host_ring(job):
    steps = [job[r]["eager"][0] for r in range(W.N)]
    seen = [job[r]["eager"][1] for r in range(W.N)]
    assert seen[0] == seen[1]              # every rank, the same stamps
    wires = [w for _, w, _ in steps[0]]
    # Two ranks report each step, TICKS 2: the coordinator's ladder
    # climbs a rung a step.
    assert wires == [[""], ["bf16"], ["int8"], ["int8"]]
    flats = [[np.concatenate([red[k].reshape(-1) for k in W.EAGER])
              for red, _, _ in steps[r]] for r in range(W.N)]
    # The raw step is the same on every rank.  On a compressed wire the
    # host ring leaves each rank its own chunk of the sum unrounded (the
    # others receive it on the wire), so the ranks differ by a rounding
    # there, statically as well.
    assert np.array_equal(_bits(flats[0][0]), _bits(flats[1][0]))
    assert not np.array_equal(_bits(flats[0][1]), _bits(flats[1][1]))
    for r in range(W.N):
        for s, (_, _, static) in enumerate(steps[r]):
            assert np.array_equal(_bits(flats[r][s]), _bits(static)), (r, s)
        exact = np.mean([np.concatenate(
            [W.eager_grads(q, 1)[k].reshape(-1) for k in W.EAGER])
            for q in range(W.N)], axis=0)
        bf16_step = np.concatenate([steps[r][1][0][k].reshape(-1)
                                    for k in W.EAGER])
        assert not np.array_equal(bf16_step, exact)
        np.testing.assert_allclose(bf16_step, exact, rtol=2e-2, atol=2e-2)
    # The bucket reported every step (the mirror's queue drained by the
    # frames); the coordinator's native ladder saw them.
    gauges = job[0]["coordinator"][0]
    assert gauges[
        "precision.level#bucket=DistributedOptimizer.grads.bucket0"] == 2
    assert 0 < gauges[
        "precision.residual#bucket=DistributedOptimizer.grads.bucket0"] \
        < 0.05


def test_eager_auto_leaves_report_per_leaf(job):
    """Without overlap each reduced f32 int8-eligible leaf reports under
    ``f"{name_prefix}.{i}"`` (the 1-D leaf and the one under the floor do
    not), and the results are the same on every rank."""
    a, b = job[0]["eager_leaves"][0], job[1]["eager_leaves"][0]
    for k in W.EAGER:
        assert np.array_equal(_bits(a[k]), _bits(b[k]))
    want = np.mean([W.eager_grads(q, 9)["w"] for q in range(W.N)], axis=0)
    np.testing.assert_array_equal(a["w"], want)      # level 0: raw
    gauges = job[0]["coordinator"][0]
    assert gauges["precision.level#bucket=plain.0"] == 1   # two reports
    assert "precision.level#bucket=plain.1" not in gauges
    assert "precision.level#bucket=plain.2" not in gauges
