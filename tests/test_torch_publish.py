"""The port's parameter publisher against the JAX package's
(``horovod_tpu/publish.py``).

* The knob defaults, set with ``monkeypatch`` only, and the validation
  texts equal the reference's.
* A job of one process with a one-rank publish set: the publisher streams
  committed chain tips (``every`` respected, the first publish on any
  tip), skips a torn and an in-flight tip as the reference's does, and
  each published state equals the reference's ``read_chain_state`` of
  the same directory bit for bit (a bfloat16 leaf too).
* The publish-while-training drill on four gloo processes, spawned once
  (``_torch_pset_worker.publish_drill``): the world trains a TransformerLM
  (2 layers, d 64) through ``make_train_step`` twice from one seed; in the
  second leg rank 0 commits the parameters every 2 steps through
  ``ckpt_stream.AsyncCheckpointer`` and ranks 2 and 3 poll a
  ``ParameterPublisher(dir, "serve")`` between steps.  Every published
  state equals the reference's ``read_chain_state`` of its epoch, and the
  publishing leg's losses equal the baseline's bit for bit.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import checkpoint as ref_checkpoint
from horovod_tpu import process_set as ref_ps
from horovod_tpu import publish as ref_publish
from horovod_tpu_torch import checkpoint, cpp_core, publish

from _torch_eager_worker import free_port, spawn
from _torch_pset_worker import SERVE, STEPS, CKPT_EVERY, publish_drill

KNOBS = ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR",
         "PROCESS_SETS", "PUBLISH_EVERY", "PUBLISH_TIMEOUT_S", "NO_CPP",
         "FAULT", "TIMELINE", "CACHE_CAPACITY", "HOST_FINGERPRINT",
         "ELASTIC", "CONTROL_TOPO")


@pytest.mark.parametrize("every,timeout", [
    (None, None), ("5", "2.5"), ("0", "junk"), ("-3", "-1"), ("x", "0")])
def test_knob_defaults_equal_the_reference(monkeypatch, every, timeout):
    for knob, value in (("HOROVOD_TPU_PUBLISH_EVERY", every),
                        ("HOROVOD_TPU_PUBLISH_TIMEOUT_S", timeout)):
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    assert (publish.publish_every_default(),
            publish.publish_timeout_default()) == (
        ref_publish.publish_every_default(),
        ref_publish.publish_timeout_default())


@pytest.fixture
def solo(monkeypatch):
    """A job of one process on the CPU with the one-rank set ``pub`` (and
    its twin in the reference's registry, for the validation texts)."""
    for knob in KNOBS:
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    ps = hvd.add_process_set([0], name="pub")
    ref = ref_ps.add_process_set([0], name="pub")
    yield ps
    ref_ps.remove_process_set(ref)
    hvd.shutdown()


def _flat(scale):
    bf = checkpoint.flatten_state(
        {"h": torch.arange(4, dtype=torch.bfloat16) * scale})["['h']"]
    return {"['w']": np.arange(6, dtype=np.float32).reshape(2, 3) * scale,
            "['b']": np.full(2, float(scale), np.float32),
            "['h']": bf, "['step']": np.int64(scale)}


def _save(d, epochs):
    prev = None
    for e in epochs:
        checkpoint.save_chain(d, _flat(e + 1), e, prev_epoch=e - 1,
                              prev_flat=prev)
        prev = _flat(e + 1)


def _same_as_reference(out, d, epoch):
    want = ref_checkpoint.read_chain_state(d, epoch)
    assert sorted(out) == sorted(want)
    for k, v in want.items():
        got = out[k]
        assert got.dtype == np.asarray(v).dtype and got.shape == np.shape(v)
        assert got.tobytes() == np.asarray(v).tobytes(), k


def test_validation_texts_equal_the_reference(solo, tmp_path):
    for make in (ref_publish.ParameterPublisher, publish.ParameterPublisher):
        with pytest.raises(ValueError) as exc:
            make(str(tmp_path), "pub", root_rank=2)
        if make is ref_publish.ParameterPublisher:
            want = str(exc.value)
    assert str(exc.value) == want
    for make in (ref_publish.ParameterPublisher, publish.ParameterPublisher):
        with pytest.raises(ValueError) as exc:
            make(str(tmp_path), "pub", every="2x")
        if make is ref_publish.ParameterPublisher:
            want = str(exc.value)
    assert str(exc.value) == want
    with pytest.raises(ValueError) as want:
        ref_publish.ParameterPublisher(str(tmp_path), "pub").publish()
    with pytest.raises(ValueError) as got:
        publish.ParameterPublisher(str(tmp_path), "pub").publish()
    assert str(got.value) == str(want.value)
    assert publish.ParameterPublisher(str(tmp_path), "pub").poll() is None


def test_publisher_streams_committed_tips(solo, tmp_path):
    d = str(tmp_path)
    pub = publish.ParameterPublisher(d, solo, every=2)
    ref = ref_publish.ParameterPublisher(d, "pub", every=2)
    assert pub.committed_tip() == ref.committed_tip() == -1
    _save(d, [0, 1])
    assert pub.pending_epoch() == ref.pending_epoch() == 1
    out = pub.poll()
    assert pub.last_published_epoch == 1
    _same_as_reference(out, d, 1)
    ref.last_published_epoch = 1
    assert pub.poll() is None
    checkpoint.save_chain(d, _flat(3), 2, prev_epoch=1, prev_flat=_flat(2))
    assert pub.pending_epoch() == ref.pending_epoch() == -1
    assert pub.poll() is None
    checkpoint.save_chain(d, _flat(4), 3, prev_epoch=2, prev_flat=_flat(3))
    assert pub.pending_epoch() == ref.pending_epoch() == 3
    out = pub.poll()
    assert pub.last_published_epoch == 3
    _same_as_reference(out, d, 3)
    _same_as_reference(pub.publish(1), d, 1)
    snap = hvd.metrics()
    assert snap["counters"]["publish.count"] >= 3
    assert snap["counters"]["publish.bytes"] > 0
    assert snap["gauges"]["publish.epoch#process_set=pub"] == 1
    for name in ("publish.latency_seconds",
                 "publish.latency_seconds#process_set=pub",
                 "publish.staleness_seconds#process_set=pub"):
        assert name in snap["histograms"]


def test_publisher_skips_torn_and_in_flight_tips(solo, tmp_path):
    d = str(tmp_path)
    _save(d, [0, 1, 2])
    # Tear the chain: epoch 2's replay needs link 1, which vanished; and
    # an in-flight epoch 3 sits in its staging directory.
    shutil.rmtree(checkpoint.checkpoint_path(d, 1))
    os.makedirs(os.path.join(d, ".tmp-checkpoint-3-1"))
    pub = publish.ParameterPublisher(d, "pub")
    ref = ref_publish.ParameterPublisher(d, "pub")
    assert pub.committed_tip() == ref.committed_tip() == 0
    out = pub.poll()
    assert pub.last_published_epoch == 0
    _same_as_reference(out, d, 0)
    with pytest.raises(checkpoint.TornChainError):
        pub.publish(2)


# ------------------------------------------------ four gloo processes

@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    assert cpp_core.available()      # built once, before the workers load it
    d = tmp_path_factory.mktemp("publish")
    env = {"HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{free_port()}",
           "HOROVOD_TPU_CONTROL_TIMEOUT_S": "20",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2",
           "HOROVOD_TPU_PROCESS_SETS": SERVE,
           "TEST_PUBLISH_DIR": str(d)}
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv("HOROVOD_TPU_" + knob, raising=False)
        got = spawn(publish_drill, 4, env, timeout=180)
    assert got["exit"] == [0] * 4
    return str(d), {r: got[r][0][1:] for r in range(4)}


@pytest.mark.parametrize("rank", range(4))
def test_publishing_leg_losses_equal_the_baseline(drill, rank):
    base, losses = drill[1][rank][:2]
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert losses == base


@pytest.mark.parametrize("rank", [2, 3])
def test_every_publish_is_a_committed_epoch(drill, rank):
    d, results = drill
    published = results[rank][2]
    epochs = [e for e, _ in published]
    assert len(epochs) >= 2 and epochs == sorted(set(epochs))
    assert epochs[-1] == STEPS // CKPT_EVERY - 1
    for epoch, out in published:
        _same_as_reference(out, d, epoch)
    counters, names = results[rank][3:]
    assert counters["publish.count"] == len(published)
    assert counters["publish.bytes"] == sum(
        sum(v.nbytes for v in out.values()) for _, out in published)
    assert {"publish.latency_seconds",
            "publish.latency_seconds#process_set=serve",
            "publish.staleness_seconds#process_set=serve",
            "publish.epoch#process_set=serve"} <= set(names)


@pytest.mark.parametrize("rank", [0, 1])
def test_training_ranks_publish_nothing(drill, rank):
    published, counters = drill[1][rank][2:4]
    assert published == [] and "publish.count" not in counters
