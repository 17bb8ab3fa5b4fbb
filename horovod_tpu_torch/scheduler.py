"""Bucket plan and issue order of the gradient collectives.

Port of ``horovod_tpu/scheduler.py:40-247``: ``overlap_enabled``,
``bucket_bytes_from_env``, ``resolve_algo``, ``plan_tick`` (the eager
plane's per-tick policy), ``pack_buckets``, ``issue_order``, the
backward-overlap bucket planner :class:`PyBucketPlanner` and
:func:`make_bucket_planner`, which prefers the native planner
(:class:`horovod_tpu_torch.cpp_core.NativeBucketPlanner`).  Plans and issue
orders are the JAX package's.

Knobs (shared with the JAX package):

- ``HOROVOD_TPU_OVERLAP``: issue bucket collectives in reverse
  registration order (default off).
- ``HOROVOD_TPU_BUCKET_BYTES``: bucket byte bound (default 67108864).  A
  leaf larger than the bound always rides alone.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024


def overlap_enabled(override: Optional[bool] = None) -> bool:
    """Resolve the overlap switch: explicit argument wins, else the
    ``HOROVOD_TPU_OVERLAP`` knob, else off."""
    if override is not None:
        return bool(override)
    return os.environ.get("HOROVOD_TPU_OVERLAP", "").lower() in (
        "1", "true", "yes", "on")


def bucket_bytes_from_env(override: Optional[int] = None) -> int:
    """Resolve the bucket bound: explicit argument wins, else the
    ``HOROVOD_TPU_BUCKET_BYTES`` knob, else 64 MiB."""
    if override is not None:
        return int(override)
    raw = os.environ.get("HOROVOD_TPU_BUCKET_BYTES", "")
    try:
        v = int(raw)
        return v if v > 0 else DEFAULT_BUCKET_BYTES
    except ValueError:
        return DEFAULT_BUCKET_BYTES


def resolve_algo(pref: str, nbytes: int, num_hosts: int = 1,
                 num_procs: int = 1,
                 crossover_bytes: Optional[int] = None) -> str:
    """Map an algorithm preference to the data-plane algorithm ("" = flat
    ring).  Mirrors ``htpu::ResolveAlgo`` exactly; parity is tested."""
    from horovod_tpu_torch.core import DEFAULT_ALGO_CROSSOVER_BYTES
    if crossover_bytes is None:
        crossover_bytes = DEFAULT_ALGO_CROSSOVER_BYTES
    if pref in ("", "ring"):
        return ""
    if pref != "auto":
        return pref
    if nbytes <= crossover_bytes:
        return "small"
    if 1 < num_hosts < num_procs:
        return "hier"
    return ""


def plan_tick(responses, entry_bytes, entry_dtype, threshold):
    """Full per-tick policy: fusion plus first-ready-first-issued order.

    The input arrives in negotiation-readiness order and fusion's stable
    left-to-right merge preserves it, so the returned list IS the issue
    schedule -- the response cache stores and replays it verbatim.
    """
    from horovod_tpu_torch.core import plan_fusion
    return plan_fusion(responses, entry_bytes, entry_dtype, threshold)


def pack_buckets(sizes: Sequence[int], dtypes: Sequence[str],
                 bucket_bytes: int) -> List[List[int]]:
    """Pack leaves (declaration order) into byte-bounded buckets.

    Consecutive leaves with the same dtype share a bucket while the total
    stays within ``bucket_bytes``.  A leaf larger than ``bucket_bytes``
    rides alone: it opens a fresh bucket that is immediately closed, so
    later leaves can never join past the byte bound.
    """
    buckets: List[List[int]] = []
    open_idx = -1
    open_bytes = 0
    open_dtype = None
    for i, (nbytes, dtype) in enumerate(zip(sizes, dtypes)):
        oversized = nbytes > bucket_bytes
        joins = (open_idx >= 0 and not oversized and dtype == open_dtype
                 and open_bytes + nbytes <= bucket_bytes)
        if not joins:
            buckets.append([])
            open_idx = len(buckets) - 1
            open_bytes = 0
            open_dtype = dtype
        buckets[open_idx].append(i)
        open_bytes += nbytes
        if oversized:
            open_idx = -1
    return buckets


def issue_order(num_buckets: int, overlap: bool) -> List[int]:
    """Issue order of the buckets: reversed registration order under
    overlap (backward materializes the last bucket first), declaration
    order otherwise."""
    order = list(range(num_buckets))
    return order[::-1] if overlap else order


class PyBucketPlanner:
    """Pure-Python backward-overlap bucket planner; same surface and
    semantics as ``htpu::BucketPlanner`` /
    :class:`horovod_tpu_torch.cpp_core.NativeBucketPlanner`.

    Leaves are registered in declaration order and packed by
    :func:`pack_buckets` at :meth:`seal`; :meth:`note_ready` marks a leaf's
    gradient final and queues its bucket once every leaf of it is;
    :meth:`next_issue` pops the queue (first ready, first issued)."""

    def __init__(self, bucket_bytes: int):
        self._bucket_bytes = (int(bucket_bytes) if bucket_bytes > 0
                              else DEFAULT_BUCKET_BYTES)
        self._sealed = False
        self._names: List[str] = []
        self._sizes: List[int] = []
        self._dtypes: List[str] = []
        self._bucket_of: List[int] = []
        self._buckets: List[List[int]] = []
        self._leaf_ready: List[bool] = []
        self._ready_count: List[int] = []
        self._issued: List[bool] = []
        self._complete: List[bool] = []
        self._issue_queue: List[int] = []
        self._issue_head = 0

    def close(self) -> None:
        pass

    def register_leaf(self, name: str, nbytes: int, dtype: str) -> int:
        if self._sealed:
            return -1
        self._names.append(name)
        self._sizes.append(int(nbytes))
        self._dtypes.append(dtype)
        return len(self._names) - 1

    def seal(self) -> int:
        if self._sealed:
            return len(self._buckets)
        self._sealed = True
        self._buckets = pack_buckets(self._sizes, self._dtypes,
                                     self._bucket_bytes)
        self._bucket_of = [-1] * len(self._names)
        for b, leaves in enumerate(self._buckets):
            for leaf in leaves:
                self._bucket_of[leaf] = b
        n = len(self._buckets)
        self._leaf_ready = [False] * len(self._names)
        self._ready_count = [0] * n
        self._issued = [False] * n
        self._complete = [False] * n
        from horovod_tpu_torch.metrics import registry
        registry.inc("overlap.buckets", n)
        return n

    def bucket_of(self, leaf: int) -> int:
        if leaf < 0 or leaf >= len(self._bucket_of):
            return -1
        return self._bucket_of[leaf]

    def bucket_bytes(self, bucket: int) -> int:
        if bucket < 0 or bucket >= len(self._buckets):
            return -1
        return sum(self._sizes[i] for i in self._buckets[bucket])

    def note_ready(self, leaf: int) -> int:
        if not self._sealed or leaf < 0 or leaf >= len(self._names):
            return -1
        if self._leaf_ready[leaf]:
            return -1
        self._leaf_ready[leaf] = True
        b = self._bucket_of[leaf]
        self._ready_count[b] += 1
        if self._ready_count[b] < len(self._buckets[b]):
            return -1
        self._issue_queue.append(b)
        return b

    def next_issue(self) -> int:
        from horovod_tpu_torch import cpp_core
        while self._issue_head < len(self._issue_queue):
            b = self._issue_queue[self._issue_head]
            self._issue_head += 1
            if self._issued[b]:
                continue
            self._issued[b] = True
            cpp_core.flight_record("bucket.issue", "", self.bucket_bytes(b),
                                   b, len(self._buckets[b]))
            return b
        return -1

    def note_complete(self, bucket: int) -> None:
        from horovod_tpu_torch import cpp_core
        if bucket < 0 or bucket >= len(self._buckets):
            return
        if self._complete[bucket]:
            return
        self._complete[bucket] = True
        cpp_core.flight_record("bucket.complete", "",
                               self.bucket_bytes(bucket), bucket,
                               len(self._buckets[bucket]))

    def all_complete(self) -> bool:
        return self._sealed and all(self._complete)

    def reset(self) -> None:
        self._leaf_ready = [False] * len(self._names)
        self._ready_count = [0] * len(self._buckets)
        self._issued = [False] * len(self._buckets)
        self._complete = [False] * len(self._buckets)
        self._issue_queue = []
        self._issue_head = 0


def make_bucket_planner(bucket_bytes: int, prefer_native: bool = True):
    """A bucket planner: the native C++ one when the core library loads,
    else the pure-Python mirror."""
    if prefer_native:
        from horovod_tpu_torch import cpp_core
        try:
            return cpp_core.NativeBucketPlanner(bucket_bytes)
        except (RuntimeError, OSError):
            pass
    return PyBucketPlanner(bucket_bytes)
