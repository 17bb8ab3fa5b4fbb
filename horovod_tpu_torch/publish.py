"""Parameter-publish serving plane: stream the training job's committed
checkpoint-chain tip to a subscriber process set.

Port of ``horovod_tpu/publish.py``, the serving half of the multi-tenant
design (docs/process-sets.md): a training tenant checkpoints through the
async incremental writer (:mod:`horovod_tpu_torch.ckpt_stream` -> base +
delta chains, :mod:`horovod_tpu_torch.checkpoint`), and a
:class:`ParameterPublisher` watches the chain directory for newly
COMMITTED epochs -- never a torn or in-flight tip -- and streams each
one's reconstructed state to the members of a publish process set via
set-scoped broadcast.  Training never stops: the publish traffic
negotiates in the publish set's own namespace on the shared coordinator
tick and its host tensors ride the set's gloo group, so the training
job's NCCL communicator never carries a byte of it.

One process drives one GPU here, so the members of the publish set are
several processes (the reference's one process read the chain for all of
them).  Every member calls :meth:`~ParameterPublisher.poll` at the same
points: the set-local root alone reads the directory and decides; it
broadcasts the epoch and the leaves' keys, dtypes and shapes first, then
every leaf.  A published state is the flat ``{key: np.ndarray}`` of
:func:`horovod_tpu_torch.checkpoint.read_chain_state`, bit for bit
(bfloat16 leaves as its ``V2`` records), on every member.

Knobs:

* ``HOROVOD_TPU_PUBLISH_EVERY`` -- publish every Nth committed epoch
  (default 1: every commit).
* ``HOROVOD_TPU_PUBLISH_TIMEOUT_S`` -- per-publish broadcast timeout in
  seconds (default 60).

Metrics: ``publish.count``, ``publish.bytes``,
``publish.latency_seconds``, ``publish.staleness_seconds#process_set=``
and ``publish.epoch#process_set=`` / ``publish.latency_seconds#process_set=``
tagged with the publish set's name, on every member.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch import checkpoint as _checkpoint
from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch import process_set as _process_set_mod

# Header codes beside an epoch: nothing due, and a root that failed to
# read the epoch it chose (it raises; the others raise with its word).
_NOTHING, _ROOT_FAILED = -1, -2


def publish_every_default() -> int:
    """HOROVOD_TPU_PUBLISH_EVERY: publish every Nth committed epoch
    (default 1 -- every commit; malformed/non-positive falls back)."""
    raw = os.environ.get("HOROVOD_TPU_PUBLISH_EVERY", "")
    try:
        v = int(raw)
        return v if v >= 1 else 1
    except ValueError:
        return 1


def publish_timeout_default() -> float:
    """HOROVOD_TPU_PUBLISH_TIMEOUT_S: per-publish broadcast timeout
    (default 60 s; malformed/non-positive falls back)."""
    raw = os.environ.get("HOROVOD_TPU_PUBLISH_TIMEOUT_S", "")
    try:
        v = float(raw)
        return v if v > 0 else 60.0
    except ValueError:
        return 60.0


def _to_tensor(leaf: np.ndarray) -> torch.Tensor:
    """A host tensor over the bytes of one chain leaf (``V2`` bfloat16
    records as int16)."""
    a = np.asarray(leaf)
    if not a.flags.c_contiguous:
        a = a.copy()
    if a.dtype == _checkpoint._BF16_RAW:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def _from_tensor(t: torch.Tensor, descr: str) -> np.ndarray:
    a = t.numpy()
    dtype = np.lib.format.descr_to_dtype(descr)
    return a.view(dtype) if dtype != a.dtype else a


class ParameterPublisher:
    """Watch a checkpoint-chain directory and broadcast committed tips to
    a subscriber process set.

    ``process_set`` is the PUBLISH set (object, name, or id): its
    set-local ``root_rank`` (default 0) must be a rank that can read the
    committed chain -- on the host of the training tenant's writer -- and
    the remaining members are the subscribers.  :meth:`poll` is the
    cheap call for a serving loop: it publishes only when a new committed
    epoch (respecting ``HOROVOD_TPU_PUBLISH_EVERY``) has appeared, and
    returns the published state so a subscriber can swap weights in
    place.  Every member of the set calls it at the same points.
    """

    def __init__(self, directory: str, process_set, *,
                 root_rank: int = 0,
                 every: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        self.directory = directory
        self._ps = _process_set_mod.resolve(process_set)
        self._root = int(root_rank)
        if not 0 <= self._root < self._ps.size():
            raise ValueError(
                f"publish root rank {root_rank} is not a set-local rank "
                f"of process set '{self._ps.name}' "
                f"(size {self._ps.size()})")
        self.every = int(every) if every is not None else \
            publish_every_default()
        self.timeout_s = (float(timeout_s) if timeout_s is not None
                          else publish_timeout_default())
        # Last epoch actually streamed (-1 = nothing yet) and a
        # monotonically increasing sequence for tensor naming, the same
        # on every member -- re-publishing the same epoch must not
        # collide with in-flight names.
        self.last_published_epoch = -1
        self._seq = 0

    # ------------------------------------------------------------- watching

    def committed_tip(self) -> int:
        """Highest committed (restorable) epoch in the directory, -1 when
        none.  Torn or in-flight chain tips are skipped -- the publisher
        only ever streams state a recovery could also reach."""
        latest = _checkpoint.latest_epoch(self.directory)
        if latest < 0:
            return -1
        return _checkpoint.resolve_committed_epoch(self.directory,
                                                   latest)

    def pending_epoch(self) -> int:
        """The epoch :meth:`poll` would publish now, or -1: the committed
        tip, if it advanced at least ``every`` epochs past the last
        publish (first publish fires on any committed tip)."""
        tip = self.committed_tip()
        if tip < 0:
            return -1
        if self.last_published_epoch < 0:
            return tip
        if tip - self.last_published_epoch >= self.every:
            return tip
        return -1

    def poll(self) -> Optional[Dict[str, Any]]:
        """Publish the newest committed epoch if one is due (the root's
        view decides for every member); returns the published flat state,
        or None when nothing new is committed."""
        return self._publish(self.pending_epoch, required=False)

    # ----------------------------------------------------------- publishing

    def publish(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """Stream committed epoch ``epoch`` (default: the committed tip,
        as the root sees it) to the publish set via set-scoped broadcast
        and return the flat state every member now holds.

        The chain is replayed on the ROOT member's process (committed
        links only -- ``read_chain_state`` raises on a torn chain); the
        epoch and the leaves' layout are broadcast first, then each leaf
        in sorted key order."""
        return self._publish(
            self.committed_tip if epoch is None else (lambda: int(epoch)),
            required=True)

    def _bcast(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        from horovod_tpu_torch.ops import eager as _eager
        handle = _eager.broadcast_async(
            t, self._root, name=f"publish/{self._ps.name}/s{self._seq}/{tag}",
            process_set=self._ps)
        return _eager.synchronize(handle, timeout=self.timeout_s)

    def _publish(self, choose, required: bool) -> Optional[Dict[str, Any]]:
        t0 = time.monotonic()
        self._seq += 1
        is_root = self._ps.rank() == self._root
        epoch, meta, flat = _NOTHING, b"", None
        failure: Optional[BaseException] = None
        if is_root:
            try:
                epoch = choose()
                if epoch >= 0:
                    # Staleness: how old the committed tip already was
                    # when this publish started -- commit-to-serve lag,
                    # the serving-plane SLO (taken before the chain read,
                    # which the latency counts).
                    age = self._commit_age_s(epoch)
                    flat = _checkpoint.read_chain_state(self.directory,
                                                        epoch)
                    meta = json.dumps({
                        "age": age,
                        "leaves": [[k, np.lib.format.dtype_to_descr(
                                        np.asarray(flat[k]).dtype),
                                    list(np.shape(flat[k]))]
                                   for k in sorted(flat)]}).encode()
            except Exception as exc:   # noqa: BLE001 -- re-raised below
                failure, epoch, meta = exc, _ROOT_FAILED, b""
        head = self._bcast(torch.tensor([epoch, len(meta)],
                                        dtype=torch.int64), "head")
        epoch, nmeta = int(head[0]), int(head[1])
        if failure is not None:
            raise failure
        if epoch == _ROOT_FAILED:
            raise RuntimeError(
                f"publish to process set '{self._ps.name}': its root "
                f"(set-local rank {self._root}) could not read the chain "
                f"in {self.directory!r}")
        if epoch < 0:
            if required:
                raise ValueError(
                    f"no committed checkpoint in {self.directory!r} to "
                    "publish")
            return None
        raw = torch.frombuffer(bytearray(meta), dtype=torch.uint8) \
            if is_root else torch.zeros(nmeta, dtype=torch.uint8)
        info = json.loads(bytes(self._bcast(raw, "meta").numpy()))
        nbytes = 0
        out: Dict[str, Any] = {}
        for i, (key, descr, shape) in enumerate(info["leaves"]):
            mine = (_to_tensor(flat[key]) if is_root else torch.zeros(
                shape, dtype=_to_tensor(np.empty(
                    0, np.lib.format.descr_to_dtype(descr))).dtype))
            out[key] = _from_tensor(self._bcast(mine, f"l{i}"), descr)
            nbytes += int(out[key].nbytes)
        del flat
        latency = time.monotonic() - t0
        self.last_published_epoch = epoch
        tag = self._ps.name
        _metrics.registry.inc("publish.count")
        _metrics.registry.inc("publish.bytes", nbytes)
        _metrics.registry.observe("publish.latency_seconds", latency)
        _metrics.registry.observe(
            f"publish.latency_seconds#process_set={tag}", latency)
        if info["age"] >= 0:
            _metrics.registry.observe(
                f"publish.staleness_seconds#process_set={tag}",
                info["age"] + latency)
        _metrics.registry.set_gauge(
            f"publish.epoch#process_set={tag}", epoch)
        return out

    def _commit_age_s(self, epoch: int) -> float:
        """Seconds since the chain link for ``epoch`` was committed, from
        the manifest's mtime (-1 when unreadable -- staleness is then
        unreported rather than wrong)."""
        path = os.path.join(
            _checkpoint.checkpoint_path(self.directory, epoch),
            _checkpoint.CHAIN_MANIFEST)
        try:
            return max(0.0, time.time() - os.path.getmtime(path))
        except OSError:
            return -1.0
