"""Input pipeline: the framework side of the data contract.

Port of ``horovod_tpu/data.py:34-185``.  The reference's examples all
repeat the same moves: shard the dataset per rank (``DistributedSampler``
/ ``dataset.shard``, e.g. ``examples/pytorch_mnist.py:98-103``), feed
each step, and keep per-rank batch counts equal so that no rank stalls
the collectives.  :func:`epoch_batches` does that over in-memory arrays.

:class:`ShardedLoader` adds the rest: this process's rows land on its own
GPU, prefetched ``prefetch`` batches ahead on a background thread, and,
for ``make_train_step(steps_per_call=k)``, stacked k deep.  On the card
the copies run on a side stream that the consumer's stream waits on, so
that staging the next batch overlaps the step running on this one.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _device(device) -> torch.device:
    """``device``, or this rank's (``hvd.init``'s choice) when None."""
    if device is not None:
        return torch.device(device)
    from horovod_tpu_torch import basics
    return basics._require_init().device


def shard_for_process(batch, device=None, *, non_blocking: bool = False):
    """Put this process's rows of the global batch on its device.

    With one process per GPU, the global batch is the concatenation of
    every process's rows in rank order, and each process passes only its
    OWN rows here (the reference's pod input contract).  If every process
    holds the identical GLOBAL batch instead, use
    :func:`horovod_tpu_torch.spmd.shard_batch`, which slices it: mixing
    the two contracts silently multiplies the global batch.  Leaves may
    be numpy arrays or tensors."""
    device = _device(device)

    def one(a):
        t = torch.as_tensor(a)
        if device.type == "cuda" and non_blocking and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=non_blocking)

    return pytree.tree_map(one, batch)


class ShardedLoader:
    """Prefetching batch iterator that puts batches on this rank's device.

    ``it`` yields host batches (trees of arrays or tensors; every leaf
    shares the leading batch dimension of this process's rows).  Iterating
    the loader yields device-resident batches, staged on a daemon thread
    ``prefetch`` batches ahead.  On a CUDA device the copies run on a side
    stream; each batch is handed over with an event that the consumer's
    current stream waits on.

    ``steps_per_call=k`` groups k consecutive batches and stacks them on a
    new leading axis -- the layout ``make_train_step(steps_per_call=k)``
    expects; a trailing group smaller than k is dropped (a partial call
    would desynchronize ranks)."""

    def __init__(self, it, device=None, *, steps_per_call: int = 1,
                 prefetch: int = 2):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{steps_per_call}")
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        # A zero-arg factory supports multi-epoch re-iteration; a plain
        # iterable/generator is single-use (a silently empty second epoch
        # would be a training bug, so it raises instead).
        self._factory = it if callable(it) else None
        self._it = None if callable(it) else it
        self._consumed = False
        self._device = _device(device)
        self._k = steps_per_call
        self._prefetch = prefetch

    def _stage(self, batch, stream):
        """A batch (a tuple of k batches when stacking) on the device, and
        the event after its copies (None off the card)."""
        if self._k > 1:
            batch = pytree.tree_map(
                lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                *batch)
        if stream is None:
            return shard_for_process(batch, self._device), None
        with torch.cuda.stream(stream):
            out = shard_for_process(batch, self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[Any]:
        if self._factory is not None:
            source = self._factory()
        else:
            if self._consumed:
                raise RuntimeError(
                    "ShardedLoader built from a plain iterable is "
                    "single-use (a generator would silently yield an "
                    "empty second epoch); pass a zero-arg factory for "
                    "multi-epoch iteration")
            self._consumed = True
            source = self._it
        stream = (torch.cuda.Stream(self._device)
                  if self._device.type == "cuda" else None)
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        _END = object()

        def put(item) -> bool:
            # Bounded put that gives up when the consumer went away, so
            # that an abandoned iteration can't wedge the producer thread
            # holding device-resident batches forever.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                group = []
                for host_batch in source:
                    if stop.is_set():
                        return
                    if self._k == 1:
                        if not put(self._stage(host_batch, stream)):
                            return
                        continue
                    group.append(host_batch)
                    if len(group) == self._k:
                        if not put(self._stage(tuple(group), stream)):
                            return
                        group = []
                # A trailing partial group is dropped (class docstring).
                put(_END)
            except BaseException as exc:   # noqa: BLE001 -- re-raised below
                put(exc)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="horovod_tpu_torch-data-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(event)
                    # The side stream's memory is now used on this one.
                    pytree.tree_map(lambda t: t.record_stream(current),
                                    batch)
                yield batch
        finally:
            stop.set()


def epoch_batches(x, y, batch_size: int, *, rank: int, size: int,
                  seed: Optional[int] = None):
    """Per-rank epoch iterator over in-memory arrays -- the
    ``DistributedSampler`` pattern (reference
    ``examples/pytorch_mnist.py:98-103``): optional epoch shuffle
    (identical permutation on every rank via ``seed``), rank-strided
    rows, equal batch counts everywhere (tail dropped).  ``x`` and ``y``
    may be numpy arrays or tensors."""
    n = x.shape[0]
    order = np.arange(n)
    if seed is not None:
        np.random.RandomState(seed).shuffle(order)
    mine = order[rank::size]
    # The batch count comes from the GLOBAL minimum (n // size), not this
    # rank's row count: with n % size != 0 some ranks hold one row more,
    # and a locally derived count would let them run an extra collective
    # step nobody else joins.
    per_rank = (n // size) // batch_size
    for b in range(per_rank):
        idx = mine[b * batch_size:(b + 1) * batch_size]
        if isinstance(x, torch.Tensor):
            idx = torch.from_numpy(idx)
        yield x[idx], y[idx]
