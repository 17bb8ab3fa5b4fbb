"""The port's training callbacks against the JAX package's.

Each schedule runs through both packages batch by batch over 3 epochs:
the JAX package's callbacks on an ``optax.inject_hyperparams(optax.sgd)``
state, the port's on a ``torch.optim.SGD`` (plain and wrapped by
``DistributedOptimizer``) whose ``param_groups`` hold the same learning
rate and momentum.  The LR and momentum each callback sets, read after
every ``on_batch_begin`` and ``on_batch_end``, must agree within 1e-6
relative: the reference stores its hyperparameters as f32 arrays, the
port as Python floats, and otherwise computes the same products (the
test's base LR and momentum are exact in f32).  ``hvd.size()`` is 4 in
both for the warmup, so that it ramps from ``lr / 4`` to ``lr``.

``MetricAverageCallback`` and ``BroadcastGlobalVariablesCallback`` over
two gloo ranks run in ``test_torch_eager_optimizer.py``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import basics as jbasics
from horovod_tpu import callbacks as jcb
from horovod_tpu_torch import basics as tbasics
from horovod_tpu_torch import callbacks as tcb

LR, MOMENTUM, SIZE, EPOCHS, STEPS = 0.25, 0.875, 4, 3, 4

SCHEDULES = {
    "staircase": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 0.1 ** e, momentum_correction=True),
    "smooth": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 + e, staircase=False,
        steps_per_epoch=STEPS, momentum_correction=True),
    "window": lambda m: m.LearningRateScheduleCallback(
        multiplier=0.5, start_epoch=1, end_epoch=2,
        momentum_correction=True),
    "warmup": lambda m: m.LearningRateWarmupCallback(
        warmup_epochs=2, steps_per_epoch=STEPS),
    "no_correction": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 2.0 ** e, momentum_correction=False),
}


def _drive(module, state, cb, read):
    """Run ``cb`` through EPOCHS x STEPS batches; ("begin" or "end", lr,
    momentum) after every batch begin and end, and ("lr", the logged lr)
    at every epoch's end."""
    seen = []
    cbs = module.CallbackList([cb], state, params={"steps": STEPS})
    cbs.on_train_begin()
    for epoch in range(EPOCHS):
        cbs.on_epoch_begin(epoch)
        for b in range(STEPS):
            cbs.on_batch_begin(b)
            seen.append(("begin",) + read(state))
            cbs.on_batch_end(b)
            seen.append(("end",) + read(state))
        logs = {}
        cbs.on_epoch_end(epoch, logs=logs)
        seen.append(("lr", logs["lr"]))
    return seen


def _jax_state():
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=LR,
                                             momentum=MOMENTUM)
    params = {"w": jnp.ones((3,))}
    return jcb.TrainingState(params=params, opt_state=tx.init(params))


def _jax_read(state):
    hp = jcb.find_hyperparams(state.opt_state)
    return (float(np.asarray(hp["learning_rate"])),
            float(np.asarray(hp["momentum"])))


def _torch_state(wrapped):
    opt = torch.optim.SGD([torch.nn.Parameter(torch.ones(3))], lr=LR,
                          momentum=MOMENTUM)
    if wrapped:
        opt = hvd.DistributedOptimizer(opt)
    return tcb.TrainingState(opt_state=opt)


def _torch_read(state):
    g = state.opt_state.param_groups[0]
    return (g["lr"], g["momentum"])


@pytest.fixture()
def size4(monkeypatch):
    monkeypatch.setattr(jbasics, "size", lambda: SIZE)
    monkeypatch.setattr(tbasics, "size", lambda: SIZE)


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_sets_the_reference_lr_and_momentum(size4, name, wrapped):
    want = _drive(jcb, _jax_state(), SCHEDULES[name](jcb), _jax_read)
    got = _drive(tcb, _torch_state(wrapped), SCHEDULES[name](tcb),
                 _torch_read)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-6,
                                   err_msg=f"{name} {i}")
    # The schedule moved something, and momentum is back after each batch.
    assert len({x[1] for x in got}) > 1
    assert all(x[2] == MOMENTUM for x in got if x[0] == "end")


def test_warmup_ramps_to_lr(size4):
    state = _torch_state(False)
    seen = _drive(tcb, state, SCHEDULES["warmup"](tcb), _torch_read)
    lrs = [x[1] for x in seen if x[0] == "begin"]
    assert lrs[0] == pytest.approx(LR / SIZE * ((1 / STEPS) / 2 * 3 + 1))
    assert all(b >= a for a, b in zip(lrs, lrs[1:2 * STEPS]))
    assert lrs[2 * STEPS - 1] == pytest.approx(LR)


def test_every_param_group_from_its_own_lr():
    p, q = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(
        torch.ones(2))
    opt = torch.optim.SGD([{"params": [p], "lr": 0.5},
                           {"params": [q], "lr": 0.125}], momentum=0.5)
    state = tcb.TrainingState(opt_state=opt)
    cb = tcb.LearningRateScheduleCallback(multiplier=lambda e: 0.5 ** e)
    cb.on_train_begin(state)
    cb.on_epoch_begin(2, state)
    cb.on_batch_begin(0, state)
    assert [g["lr"] for g in opt.param_groups] == [0.125, 0.03125]
    assert [g["momentum"] for g in opt.param_groups] == [0.125, 0.125]
    cb.on_batch_end(0, state)
    assert [g["momentum"] for g in opt.param_groups] == [0.5, 0.5]


def test_adam_momentum_is_betas_0():
    opt = torch.optim.Adam([torch.nn.Parameter(torch.ones(2))], lr=0.5,
                           betas=(0.75, 0.999))
    state = tcb.TrainingState(opt_state=opt)
    cb = tcb.LearningRateScheduleCallback(multiplier=0.5)
    cb.on_train_begin(state)
    cb.on_epoch_begin(0, state)
    cb.on_batch_begin(0, state)
    assert opt.param_groups[0]["lr"] == 0.25
    assert opt.param_groups[0]["betas"] == (0.375, 0.999)
    cb.on_batch_end(0, state)
    assert opt.param_groups[0]["betas"] == (0.75, 0.999)


@pytest.mark.parametrize("hp,key", [
    ({"learning_rate": 1.0, "lr": 2.0}, None),
    ({"lr": 1.0, "momentum": 0.9}, None),
    ({"eta": 0.1}, None),
    ({"eta": 0.1, "momentum": 0.9}, "eta"),
    ({"momentum": 0.9}, None),
    ({"eta": 0.1, "momentum": 0.9}, None),
    ({"lr": 0.1}, "alpha"),
])
def test_resolve_lr_key_as_the_reference(hp, key):
    """The same dicts resolve to the same key, or both raise KeyError."""
    try:
        want = jcb.resolve_lr_key(hp, key)
    except KeyError:
        with pytest.raises(KeyError):
            tcb.resolve_lr_key(hp, key)
        return
    assert tcb.resolve_lr_key(hp, key) == want


def test_find_hyperparams_is_param_groups():
    opt = torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1)
    assert tcb.find_hyperparams(opt) is opt.param_groups
    with pytest.raises(ValueError, match="param_groups"):
        tcb.find_hyperparams({"not": "an optimizer"})


def test_smooth_schedule_needs_the_epoch_length():
    cb = tcb.LearningRateScheduleCallback(multiplier=lambda e: e,
                                          staircase=False)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        cb.on_train_begin(_torch_state(False))


def test_callback_list_dispatch():
    calls = []

    class Probe(tcb.Callback):
        def on_epoch_begin(self, epoch, state, logs=None):
            calls.append((epoch, state))

    state = tcb.TrainingState()
    cl = tcb.CallbackList([Probe()], state, params={"steps": 10})
    cl.on_epoch_begin(3)
    assert calls == [(3, state)]
    with pytest.raises(AttributeError):
        cl.not_a_hook


def test_metric_average_and_broadcast_at_size_one(monkeypatch):
    """Without a job of several ranks the broadcast is the identity; the
    metric average runs on the eager plane (size 1)."""
    for knob in ("SIZE", "RANK", "LOCAL_RANK", "LOCAL_SIZE", "COORD_ADDR"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(3, 2)
        before = [p.detach().clone() for p in model.parameters()]
        state = tcb.TrainingState(params=model, opt_state=torch.optim.SGD(
            model.parameters(), lr=0.1))
        tcb.BroadcastGlobalVariablesCallback(0).on_train_begin(state)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, model.parameters()))
        logs = {"loss": 2.0, "acc": torch.tensor(0.5), "note": "skipme"}
        tcb.MetricAverageCallback().on_epoch_end(0, state, logs=logs)
        assert logs == {"loss": 2.0, "acc": 0.5, "note": "skipme"}
    finally:
        hvd.shutdown()
