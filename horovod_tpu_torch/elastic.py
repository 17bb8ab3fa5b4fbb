"""Elastic membership: survive rank loss by reconfiguring, not aborting.

Port of ``horovod_tpu/elastic.py``.  With ``HOROVOD_TPU_ELASTIC=1`` the
coordinator reacts to a confirmed-dead rank by broadcasting RECONFIGURE
instead of ABORT: survivors quiesce their in-flight collectives (completed
RETRYABLE, not ABORTED), ranks are re-assigned densely (optionally
admitting parked standbys launched with ``python -m horovod_tpu_torch.run
--elastic --num-standby=N``), the data plane is re-bootstrapped, and the
job resumes under a bumped **membership generation**.

State machine (per process)::

    RUN -> QUIESCE -> RERANK -> REBOOTSTRAP -> RESTORE -> RUN

The native plane (``cpp/htpu/control.cc``) owns QUIESCE/RERANK and the TCP
half of REBOOTSTRAP; the controller (:mod:`horovod_tpu_torch.core`)
rebuilds the NCCL (or gloo) world group of the new generation; this module
owns RESTORE: :func:`run_elastic` re-enters the training function from the
latest checkpoint whenever a collective completes with
:class:`~horovod_tpu_torch.ops.eager.HorovodRetryableError`.

Elasticity covers the negotiated eager plane: train through
``DistributedOptimizer(eager=True)``.  A collective issued on the world
group directly (``make_train_step``, ``ops.injit``) is not renegotiated,
and a peer lost under it leaves it waiting until the group is aborted.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Optional, Sequence, Tuple

from horovod_tpu_torch import basics


def enabled() -> bool:
    """True when this process runs in elastic mode
    (``HOROVOD_TPU_ELASTIC=1``)."""
    return os.environ.get("HOROVOD_TPU_ELASTIC", "") == "1"


def min_ranks() -> int:
    """Smallest world size a reconfiguration may shrink to
    (``HOROVOD_TPU_ELASTIC_MIN_RANKS``, default 1); below it the job
    aborts with the original attributed failure."""
    return int(os.environ.get("HOROVOD_TPU_ELASTIC_MIN_RANKS", "1"))


def is_standby() -> bool:
    """True when this process was launched as a parked standby
    (``HOROVOD_TPU_STANDBY=1``): it holds no rank until a
    reconfiguration admits it."""
    return os.environ.get("HOROVOD_TPU_STANDBY", "") == "1"


def generation() -> int:
    """Current membership generation: 0 until the first reconfiguration,
    bumped once per membership change; -1 before init or when no native
    control plane is attached (single-process jobs)."""
    if not basics.is_initialized():
        return -1
    controller = basics.controller()
    ctl = getattr(controller, "_control", None)
    if ctl is None:
        return -1
    # The generation the controller ADOPTED (published after rank()/size()
    # and the world group describe the new world), not the native plane's,
    # which bumps a moment earlier.
    adopted = getattr(controller, "_adopted_generation", None)
    if adopted is not None:
        return adopted
    return ctl.membership()[3]


def successor_candidates(process_count: int) -> list:
    """Deterministic coordinator-successor order after process 0 is lost:
    the surviving process indices, ascending (the C++ election walk,
    ``FailoverOnCoordLoss``)."""
    return list(range(1, process_count))


def elect_successor(candidates: Sequence[int],
                    failed: Sequence[int] = ()) -> Optional[int]:
    """The elected successor: the lowest-indexed candidate not known to
    have failed.  None when every candidate is exhausted -- the caller
    degrades to the classic attributed abort."""
    down = set(failed)
    for c in candidates:
        if c not in down:
            return c
    return None


def quorum_ok(survivors: int, ranks_per_process: int,
              min_ranks_floor: int) -> bool:
    """True when a successor may take over: the surviving world must stay
    at or above ``HOROVOD_TPU_ELASTIC_MIN_RANKS`` (the C++ quorum gate,
    ``FailoverServe``)."""
    return survivors * ranks_per_process >= min_ranks_floor


def init(ranks=None, **kwargs) -> None:
    """``hvd.init()`` for elastic jobs (``ranks`` and the keyword
    arguments are :func:`horovod_tpu_torch.init`'s; an elastic job has a
    control plane, so a subset is refused, as in the reference).

    Identical to :func:`horovod_tpu_torch.init` except for standbys: a
    standby whose admission wait expires without a seat (the job finished
    healthy and never needed it) exits 0 instead of raising -- a spare
    that was never used is success, not failure.
    """
    try:
        basics.init(ranks, **kwargs)
    except Exception as exc:   # noqa: BLE001 -- an unseated spare has no job
        if is_standby() and ranks is None:
            print(f"horovod_tpu elastic: standby never admitted ({exc}); "
                  "exiting cleanly", file=sys.stderr)
            raise SystemExit(0)
        raise


# The active async snapshot stream, owned by run_elastic on the restore
# root (the writing rank).  Module-level so training loops can call
# elastic.snapshot(state, step) without threading the stream through.
_stream = None


def active_stream():
    """The run's :class:`~horovod_tpu_torch.ckpt_stream.AsyncCheckpointer`
    (restore-root rank only, while inside :func:`run_elastic` with
    snapshotting on), else None."""
    return _stream


def snapshot(state: Any, step: int) -> bool:
    """Per-step hook for the async checkpoint stream: a device->host
    snapshot every ``snapshot_every_steps`` steps on the writing rank; a
    no-op (False) everywhere else.  Re-raises the background writer's
    failure, if any, as the attributed ``HorovodRetryableError``."""
    s = _stream
    if s is None:
        return False
    return s.maybe_snapshot(state, step)


def run_elastic(train: Callable[[Any, int], Any], *, directory: str,
                like: Any, root_rank: int = 0,
                optional_keys: Tuple[str, ...] = (),
                max_reconfigures: int = 32,
                snapshot_every_steps: Optional[int] = None) -> Any:
    """Drive a training function across membership changes.

    ``train(state, resume_epoch)`` is entered with ``state`` restored
    from the latest checkpoint in ``directory`` (``like`` is the tree
    template; ``resume_epoch`` is -1 on a fresh start) and re-entered --
    freshly restored -- every time it raises
    :class:`~horovod_tpu_torch.ops.eager.HorovodRetryableError`, i.e.
    every time the membership reconfigured under it.

    ``snapshot_every_steps`` (default: ``HOROVOD_TPU_CKPT_EVERY_STEPS``,
    0 = off) arms the async incremental stream: the root rank gets an
    :class:`~horovod_tpu_torch.ckpt_stream.AsyncCheckpointer` seeded with
    the restored state, and ``train`` calls :func:`snapshot` once per
    step.

    Returns ``train``'s return value (the stream is flushed first).
    Aborts (:class:`~horovod_tpu_torch.ops.eager.HorovodAbortedError`)
    and every other exception propagate unchanged -- only membership
    changes retry.
    """
    import time

    from horovod_tpu_torch import checkpoint, ckpt_stream
    from horovod_tpu_torch import metrics as _metrics
    from horovod_tpu_torch.ops.eager import HorovodRetryableError

    global _stream
    cadence = (snapshot_every_steps if snapshot_every_steps is not None
               else ckpt_stream.snapshot_every_steps_default())
    use_stream = cadence > 0 or ckpt_stream.async_enabled()
    controller = basics.controller() if basics.is_initialized() else None
    attempts = 0
    try:
        while True:
            if controller is not None and generation() >= 0:
                # Each entry of train runs in one generation: a
                # collective submitted once the controller has adopted
                # another completes RETRYABLE instead of waiting for
                # members that restore (core.Controller.enqueue).  The
                # controller's own view: the native plane's number moves
                # before the controller adopts it.
                controller.expected_generation = controller.generation
            # The restore itself runs collectives (epoch agreement + state
            # broadcast), so a membership change landing mid-restore retries
            # the same way one landing mid-train does.
            try:
                t0 = time.monotonic()
                state, epoch = checkpoint.restore_and_broadcast(
                    directory, like, root_rank=root_rank,
                    optional_keys=optional_keys)
                if attempts:
                    _metrics.registry.observe("elastic.resume_seconds",
                                              time.monotonic() - t0)
                    _metrics.registry.set_gauge("elastic.last_resume_s",
                                                time.monotonic() - t0)
                if use_stream and basics.rank() == root_rank:
                    _stream = ckpt_stream.AsyncCheckpointer(
                        directory, snapshot_every_steps=cadence)
                    _stream.seed(state, epoch)
                try:
                    result = train(state, epoch)
                    if _stream is not None:
                        # Surface a pending writer failure before declaring
                        # success; on a clean exit the final snapshot commits.
                        _stream.flush()
                    return result
                finally:
                    if _stream is not None:
                        _stream.close(flush=False)
                        _stream = None
            except HorovodRetryableError as exc:
                attempts += 1
                if attempts > max_reconfigures:
                    raise
                print(f"horovod_tpu elastic: membership changed (generation "
                      f"{generation()}): {exc}; restoring from "
                      f"{directory!r} and re-entering train "
                      f"(reconfiguration {attempts})", file=sys.stderr)
    finally:
        if controller is not None:
            controller.expected_generation = None
