"""The port's bucket planners against the JAX package's.

``horovod_tpu_torch.scheduler.PyBucketPlanner`` and
``horovod_tpu_torch.cpp_core.NativeBucketPlanner`` (over the port's own
build of ``cpp/htpu``) against ``horovod_tpu.scheduler.PyBucketPlanner``
and ``horovod_tpu.cpp_core.NativeBucketPlanner``: the same leaves (sizes,
dtypes), the same bucket bound (``HOROVOD_TPU_BUCKET_BYTES`` included,
with 0 meaning the 64 MiB default) and the same readiness order give the
same bucket count, assignment, bytes, issue order and ``all_complete``.
No tolerance: every value is an integer or a bool.
"""

import numpy as np
import pytest

from horovod_tpu import cpp_core as jcpp
from horovod_tpu import scheduler as jsched
from horovod_tpu_torch import cpp_core as tcpp
from horovod_tpu_torch import scheduler as tsched

MiB = 1 << 20
# (leaf bytes, dtypes, bucket bound): several leaves a bucket, a leaf
# exactly at the bound, oversized leaves alone (first, middle, last), a
# dtype change closing a bucket, zero-byte leaves, and a 0 bound (the
# default).
CASES = [
    ([240, 140, 76800, 1200], ["float32"] * 4, 1024),
    ([100] * 20, ["float32"] * 20, 1000),
    ([1024, 1, 1023, 1024, 2048], ["float32"] * 5, 1024),
    ([5000, 10, 10, 5000, 10], ["float32"] * 5, 4096),
    ([10, 10, 10, 10], ["float32", "float16", "float16", "float32"], 64),
    ([0, 0, 16, 0], ["float32"] * 4, 16),
    ([MiB] * 70, ["float32"] * 70, 0),
    ([3 * 64 * MiB, MiB, 65 * MiB], ["float32"] * 3, 0),
    ([], [], 1024),
]


def _planners(bucket_bytes):
    return {"jax_py": jsched.PyBucketPlanner(bucket_bytes),
            "jax_native": jcpp.NativeBucketPlanner(bucket_bytes),
            "torch_py": tsched.PyBucketPlanner(bucket_bytes),
            "torch_native": tcpp.NativeBucketPlanner(bucket_bytes)}


def _drive(planner, sizes, dtypes, order):
    """Register, seal, mark ready in ``order`` (issuing after each), then
    complete in issue order; returns everything observable."""
    ids = [planner.register_leaf(f"g.{i}", n, d)
           for i, (n, d) in enumerate(zip(sizes, dtypes))]
    n = planner.seal()
    assert planner.register_leaf("late", 4, "float32") == -1
    assigned = [planner.bucket_of(i) for i in range(len(sizes))]
    nbytes = [planner.bucket_bytes(b) for b in range(n)]
    ready, issued = [], []
    for leaf in order:
        ready.append(planner.note_ready(leaf))
        while (b := planner.next_issue()) >= 0:
            issued.append(b)
    again = planner.note_ready(order[0]) if order else None
    done_before = planner.all_complete()
    for b in issued:
        planner.note_complete(b)
    done = planner.all_complete()
    planner.reset()
    after_reset = planner.all_complete()
    replay = []
    for leaf in order:
        planner.note_ready(leaf)
        while (b := planner.next_issue()) >= 0:
            replay.append(b)
    planner.close()
    return dict(ids=ids, n=n, assigned=assigned, nbytes=nbytes,
                ready=ready, issued=issued, again=again,
                done_before=done_before, done=done,
                after_reset=after_reset, replay=replay)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("order", ["forward", "backward", "shuffled"])
def test_planners_agree_with_the_jax_package(case, order):
    sizes, dtypes, bound = CASES[case]
    leaves = list(range(len(sizes)))
    if order == "backward":
        leaves = leaves[::-1]
    elif order == "shuffled":
        np.random.RandomState(case).shuffle(leaves)
    got = {k: _drive(p, sizes, dtypes, leaves)
           for k, p in _planners(bound).items()}
    want = got.pop("jax_py")
    for k, v in got.items():
        assert v == want, k
    if leaves:
        assert sorted(want["issued"]) == list(range(want["n"]))
        assert want["done"] and not want["after_reset"]
        assert want["replay"] == want["issued"]


def test_bound_from_the_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_BUCKET_BYTES", "300")
    assert tsched.bucket_bytes_from_env() == jsched.bucket_bytes_from_env()
    sizes = [100, 200, 50, 400]
    plans = []
    for planner in (jsched.make_bucket_planner(jsched.bucket_bytes_from_env()),
                    tsched.make_bucket_planner(tsched.bucket_bytes_from_env()),
                    tsched.make_bucket_planner(tsched.bucket_bytes_from_env(),
                                               prefer_native=False)):
        for i, n in enumerate(sizes):
            planner.register_leaf(f"g.{i}", n, "float32")
        planner.seal()
        plans.append([planner.bucket_of(i) for i in range(len(sizes))])
        planner.close()
    assert plans == [[0, 0, 1, 2]] * 3


def test_make_bucket_planner_prefers_the_native_one():
    assert isinstance(tsched.make_bucket_planner(1024),
                      tcpp.NativeBucketPlanner)
    assert isinstance(tsched.make_bucket_planner(1024, prefer_native=False),
                      tsched.PyBucketPlanner)


def test_out_of_range_queries():
    for planner in _planners(64).values():
        assert planner.note_ready(0) == -1           # not sealed yet
        planner.register_leaf("g.0", 8, "float32")
        planner.seal()
        assert planner.bucket_of(5) == -1
        assert planner.bucket_bytes(7) == -1
        assert planner.note_ready(3) == -1
        assert planner.next_issue() == -1
        planner.note_complete(9)                     # ignored
        assert not planner.all_complete()
        planner.close()
