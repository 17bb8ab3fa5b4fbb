"""Bucket plan and issue order of the gradient collectives.

Port of ``horovod_tpu/scheduler.py:40-128`` in pure Python:
``overlap_enabled``, ``bucket_bytes_from_env``, ``pack_buckets`` and
``issue_order``.  The bucket plan is byte-for-byte the JAX package's.  The
native planner and the eager plane's per-tick policy are not ported yet.

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
