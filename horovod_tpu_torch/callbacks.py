"""Training callbacks -- the reference's Keras callback set
(``horovod/keras/callbacks.py``, ``callbacks_impl.py``).

Port of ``horovod_tpu/callbacks.py:35-341``:

* :class:`BroadcastGlobalVariablesCallback` -- rank-0 state sync at train
  start (``callbacks_impl.py:20-30``).
* :class:`MetricAverageCallback` -- epoch-end allreduce of metric logs
  (``callbacks_impl.py:33-67``), through the negotiated eager plane.
* :class:`LearningRateScheduleCallback` -- staircase/smooth LR multipliers
  with **momentum correction** (``callbacks_impl.py:70-146``).
* :class:`LearningRateWarmupCallback` -- Goyal et al. linear warmup from
  ``lr`` to ``lr x size`` over N epochs (``callbacks_impl.py:149-168``).

The JAX package's callbacks adjust the ``hyperparams`` dict of an
``optax.inject_hyperparams`` state; here the hyperparameters are the
wrapped optimizer's ``param_groups``: ``lr``, and the momentum --
``momentum`` (SGD, RMSprop) or ``betas[0]`` (Adam and its kin).  Every
group is scheduled from its own initial learning rate.  The callbacks
operate on a :class:`TrainingState` that the training loop owns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from horovod_tpu_torch import basics


@dataclasses.dataclass
class TrainingState:
    """Mutable holder the callbacks operate on (the analogue of the Keras
    ``model`` the reference's callbacks mutate): ``params`` a module or a
    ``state_dict``, ``opt_state`` the (wrapped) ``torch.optim.Optimizer``,
    ``aux_state`` further tensors to keep equal across ranks."""
    params: Any = None
    opt_state: Any = None
    aux_state: Any = None


def find_hyperparams(opt_state) -> List[Dict[str, Any]]:
    """The hyperparameter dicts of an optimizer: its ``param_groups``."""
    groups = getattr(opt_state, "param_groups", None)
    if not groups:
        raise ValueError(
            "optimizer state has no param_groups; give the callbacks the "
            "torch.optim.Optimizer (or the DistributedOptimizer wrapping "
            "it) as TrainingState.opt_state so they can adjust the "
            "learning rate")
    return groups


class Callback:
    """Minimal callback protocol for training loops (the surface the
    reference's callbacks use from Keras)."""

    def on_train_begin(self, state: TrainingState, logs=None):
        pass

    def on_epoch_begin(self, epoch: int, state: TrainingState, logs=None):
        pass

    def on_batch_begin(self, batch: int, state: TrainingState, logs=None):
        pass

    def on_batch_end(self, batch: int, state: TrainingState, logs=None):
        pass

    def on_epoch_end(self, epoch: int, state: TrainingState, logs=None):
        pass


class CallbackList:
    """Drives a list of callbacks; the loop calls these hooks."""

    def __init__(self, callbacks: List[Callback], state: TrainingState,
                 params: Optional[dict] = None):
        self.callbacks = callbacks
        self.state = state
        self.params = params or {}
        for c in self.callbacks:
            c.params = self.params   # steps/samples/batch_size autodetect

    def __getattr__(self, hook):
        if not hook.startswith("on_"):
            raise AttributeError(hook)

        def call(*args, **kw):
            for c in self.callbacks:
                getattr(c, hook)(*args, state=self.state, **kw)
        return call


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast parameters, optimizer state and aux state from
    ``root_rank`` at train start, so that all ranks begin identical
    (reference ``callbacks_impl.py:20-30``)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state: TrainingState, logs=None):
        from horovod_tpu_torch.optimizer import (broadcast_optimizer_state,
                                                 broadcast_parameters)
        if state.params is not None:
            broadcast_parameters(state.params, self.root_rank)
        if state.opt_state is not None:
            broadcast_optimizer_state(state.opt_state, self.root_rank)
        if state.aux_state is not None:
            broadcast_parameters(state.aux_state, self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch-end metrics over ranks in place (reference
    ``callbacks_impl.py:33-67``): afterwards every rank's ``logs`` holds
    the all-rank mean, as a float."""

    def on_epoch_end(self, epoch: int, state: TrainingState, logs=None):
        if not logs:
            return
        from horovod_tpu_torch.optimizer import allreduce_
        # Sorted, so that every rank issues the collectives in one order.
        for metric in sorted(logs.keys()):
            value = logs[metric]
            if isinstance(value, (int, float, np.ndarray, torch.Tensor)):
                reduced = allreduce_(
                    torch.as_tensor(value, dtype=torch.float32),
                    average=True, eager=True,
                    name_prefix=f"MetricAverageCallback.{metric}")
                logs[metric] = float(reduced)


# Names that commonly hold the learning rate, in the reference's order
# (torch's optimizers use ``lr``).
_LR_KEYS = ("learning_rate", "lr", "step_size")
# Names that are definitely NOT the learning rate: a single-entry dict
# holding one of these must not be scaled as if it were the LR.
_NON_LR_KEYS = frozenset({
    "momentum", "weight_decay", "b1", "b2", "eps", "eps_root", "decay",
    "nesterov", "initial_scale", "max_norm"})


def resolve_lr_key(hp: Dict[str, Any], lr_key: Optional[str] = None) -> str:
    """Pick the key of a param group that holds the learning rate.

    Explicit ``lr_key`` wins; otherwise the conventional names of
    :data:`_LR_KEYS`; a single-entry dict is taken as the LR unless its
    name is a known non-LR hyperparameter.  Anything else raises, listing
    the available keys."""
    if lr_key is not None:
        if lr_key not in hp:
            raise KeyError(
                f"lr_key={lr_key!r} is not a hyperparameter of the param "
                f"group; available keys: {sorted(hp)}")
        return lr_key
    for k in _LR_KEYS:
        if k in hp:
            return k
    if len(hp) == 1:
        only = next(iter(hp))
        if only not in _NON_LR_KEYS:
            return only
    raise KeyError(
        "could not identify the learning-rate hyperparameter among "
        f"{sorted(hp)}; name it one of {list(_LR_KEYS)} or pass lr_key= "
        "to the callback")


class _Hyperparams:
    """Accessor for the live learning rates and momenta of every param
    group (a list each, in group order)."""

    def __init__(self, state: TrainingState, lr_key: Optional[str] = None):
        self._groups = find_hyperparams(state.opt_state)
        self._lr_key = resolve_lr_key(self._groups[0], lr_key)

    @property
    def lr(self) -> List[float]:
        return [float(g[self._lr_key]) for g in self._groups]

    @lr.setter
    def lr(self, values: List[float]) -> None:
        for g, v in zip(self._groups, values):
            g[self._lr_key] = v

    @property
    def momentum(self) -> Optional[List[float]]:
        g0 = self._groups[0]
        if "momentum" in g0:
            return [float(g["momentum"]) for g in self._groups]
        if "betas" in g0:
            return [float(g["betas"][0]) for g in self._groups]
        return None

    @momentum.setter
    def momentum(self, values: List[float]) -> None:
        for g, v in zip(self._groups, values):
            if "momentum" in g:
                g["momentum"] = v
            else:
                g["betas"] = (v,) + tuple(g["betas"][1:])


class LearningRateScheduleCallback(Callback):
    """Multiply each param group's initial LR by ``multiplier(epoch)``
    inside ``[start_epoch, end_epoch)`` -- the reference's LR schedule
    callback (``callbacks_impl.py:70-146``).

    ``staircase=True`` applies at epoch boundaries; ``False`` interpolates
    every batch using fractional epochs.  With ``momentum_correction``,
    the momentum is scaled by ``new_lr / old_lr`` for the batches where
    the LR changes and restored afterwards (Goyal et al.)."""

    def __init__(self, multiplier: Union[float, Callable[[float], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 lr_key: Optional[str] = None):
        self.lr_key = lr_key
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        # A constant multiplier has nothing to interpolate.
        self.staircase = staircase or not callable(multiplier)
        self.multiplier = (multiplier if callable(multiplier)
                           else lambda epoch: multiplier)
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr: Optional[List[float]] = None
        self.restore_momentum: Optional[List[float]] = None
        self.current_epoch: Optional[int] = None
        self.params: dict = {}

    def _schedule_point(self, batch: int) -> Optional[float]:
        """The (fractional) epoch to evaluate the multiplier at for this
        batch, or None when the schedule doesn't fire."""
        e = self.current_epoch
        if e < self.start_epoch:
            return None
        if self.end_epoch is not None and e >= self.end_epoch:
            return None
        if self.staircase:
            return float(e) if batch == 0 else None
        return e + float(batch) / self.steps_per_epoch

    def _apply(self, epoch: float, state: TrainingState) -> None:
        hp = _Hyperparams(state, self.lr_key)
        prev_lr = hp.lr
        new_lr = [lr * self.multiplier(epoch) for lr in self.initial_lr]
        hp.lr = new_lr
        momentum = hp.momentum
        if self.momentum_correction and momentum is not None and \
                all(lr > 0 for lr in prev_lr):
            # Goyal et al.: while the LR ramps, scale momentum by the LR
            # ratio for the adjusted batch, then put it back.
            self.restore_momentum = momentum
            hp.momentum = [m * n / p for m, n, p in
                           zip(momentum, new_lr, prev_lr)]

    # -- hooks ------------------------------------------------------------

    def on_train_begin(self, state: TrainingState, logs=None):
        self.initial_lr = _Hyperparams(state, self.lr_key).lr
        if not self.staircase and not self.steps_per_epoch:
            if self.params.get("steps"):
                self.steps_per_epoch = self.params["steps"]
            elif self.params.get("samples") and self.params.get("batch_size"):
                self.steps_per_epoch = (self.params["samples"]
                                        // self.params["batch_size"])
            else:
                raise ValueError(
                    f"{type(self).__name__} interpolates within epochs and "
                    "needs the epoch length: pass steps_per_epoch=, or give "
                    "CallbackList params a 'steps' (or 'samples' + "
                    "'batch_size') entry.")

    def on_epoch_begin(self, epoch: int, state: TrainingState, logs=None):
        self.current_epoch = epoch

    def on_batch_begin(self, batch: int, state: TrainingState, logs=None):
        point = self._schedule_point(batch)
        if point is not None:
            self._apply(point, state)

    def on_batch_end(self, batch: int, state: TrainingState, logs=None):
        if self.restore_momentum is not None:
            _Hyperparams(state, self.lr_key).momentum = self.restore_momentum
            self.restore_momentum = None

    def on_epoch_end(self, epoch: int, state: TrainingState, logs=None):
        if logs is not None:
            logs["lr"] = _Hyperparams(state, self.lr_key).lr[0]


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR warmup: ramp from ``lr`` to ``lr x size`` over
    ``warmup_epochs`` (reference ``callbacks_impl.py:149-168``)::

        lr_epoch = initial_lr / size * (epoch * (size - 1) / warmup + 1)
    """

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0,
                 lr_key: Optional[str] = None):
        def multiplier(epoch):
            size = basics.size()
            # Offset so that each epoch ends on a round multiplier value
            # (the reference applies the same 1/steps_per_epoch shift).
            epoch += 1.0 / self.steps_per_epoch
            return 1.0 / size * (epoch * (size - 1) / warmup_epochs + 1)
        super().__init__(multiplier, start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch, lr_key=lr_key)
        self.verbose = verbose

    def on_epoch_end(self, epoch: int, state: TrainingState, logs=None):
        super().on_epoch_end(epoch, state, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0:
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {_Hyperparams(state, self.lr_key).lr[0]:g}.")
