"""The port's eager plane across processes, one rank each, over gloo.

One job of three ranks negotiates over the native TCP control plane
(``HOROVOD_TPU_COORD_ADDR``) and runs, in one spawn, the cases of
``tests/test_eager_ops.py`` and ``tests/test_multiprocess.py`` that one rank
per process can run (``_torch_eager_worker.eager_cases``): fused async
allreduces, mixed average flags, a ragged allgather, a broadcast from each
root, the integer floor average, the wire-compressed ring, response-cache
hits, the coordinated mismatch error, a timeline per rank, and a peer
that dies.  A second job of four ranks on two faked hosts runs without the
control plane (jit-only mode): host discovery over the store gives each
rank its ``local_rank``, an integer metric averages like ``lax.pmean``,
and an eager collective fails fast.  Results are held against numpy, the
JAX package's message table and codec, and ``lax.pmean``.
"""

import json

import numpy as np
import pytest

from _torch_eager_worker import (CACHE_BURSTS, CACHE_TENSORS, EXIT_CRASH,
                                 WIRE_N, cache_cases, eager_cases, free_port,
                                 jit_only_cases, payload, spawn)

N = 3
HOSTS = ("A", "A", "B", "B")
# The launcher's and the eager plane's knobs, unset for the jobs unless
# a job sets them.
KNOBS = ("LOCAL_RANK", "HOST_FINGERPRINT", "WIRE_DTYPE",
         "FUSION_THRESHOLD", "CACHE_CAPACITY", "ALLREDUCE_ALGO", "NO_CPP",
         "FAULT", "TIMELINE", "COORD_ADDR", "INTEGRITY", "TRANSPORT")


def _unset_knobs(mp):
    for knob in KNOBS:
        mp.delenv("HOROVOD_TPU_" + knob, raising=False)


@pytest.fixture(scope="module")
def eager_job(tmp_path_factory):
    from horovod_tpu_torch import cpp_core
    assert cpp_core.available()      # built once, before the workers load it
    trace = tmp_path_factory.mktemp("eager") / "trace.json"
    env = {"HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{free_port()}",
           "HOROVOD_TPU_CONTROL_TIMEOUT_S": "20",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2",
           "HOROVOD_TPU_TIMELINE": str(trace)}
    with pytest.MonkeyPatch.context() as mp:
        _unset_knobs(mp)
        got = spawn(eager_cases, N, env)
    results = {r: {m[0]: m[1:] for m in got[r]} for r in range(N)}
    return results, got["exit"], trace


@pytest.fixture(scope="module")
def cache_job():
    """Two processes on the control plane, as the reference's cache test
    runs them (a 2 ms tick, no timeline)."""
    env = {"HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{free_port()}",
           "HOROVOD_TPU_CONTROL_TIMEOUT_S": "20",
           "HOROVOD_TPU_CYCLE_TIME_MS": "2"}
    with pytest.MonkeyPatch.context() as mp:
        _unset_knobs(mp)
        got = spawn(cache_cases, 2, env)
    return got


@pytest.fixture(scope="module")
def jit_only_job():
    with pytest.MonkeyPatch.context() as mp:
        _unset_knobs(mp)
        got = spawn(jit_only_cases, len(HOSTS),
                    {"HOROVOD_TPU_CONTROL_TIMEOUT_S": "20"},
                    fingerprints=HOSTS)
    assert got["exit"] == [0] * len(HOSTS)
    return {r: got[r][0] for r in range(len(HOSTS))}


@pytest.mark.parametrize("rank", range(N))
def test_layout_from_the_control_plane(eager_job, rank):
    """All ranks share this host, so the discovered local_rank is the
    process index (the reference's test_multiprocess case 8), without
    HOROVOD_TPU_LOCAL_RANK."""
    local_rank, pidx, pcount, threads = eager_job[0][rank]["layout"]
    assert (local_rank, pidx, pcount, threads) == (rank, rank, N, True)


@pytest.mark.parametrize("rank", range(N))
def test_fused_async_allreduce(eager_job, rank):
    (outs,) = eager_job[0][rank]["fused"]
    for i, out in enumerate(outs):
        want = sum(float(r) * (i + 1) for r in range(N))
        np.testing.assert_array_equal(out, np.full(8, want, np.float32))


@pytest.mark.parametrize("rank", range(N))
def test_mixed_average_flags(eager_job, rank):
    (outs,) = eager_job[0][rank]["mixed"]
    for i, out in enumerate(outs):
        total = np.float32(sum(float(r + 1) * (i + 1) for r in range(N)))
        want = total / np.float32(N) if i % 2 else total
        np.testing.assert_array_equal(out, np.full(4, want, np.float32))


@pytest.mark.parametrize("rank", range(N))
def test_ragged_allgather(eager_job, rank):
    (out,) = eager_job[0][rank]["gather"]
    want = np.concatenate([np.full((r + 1, 2), float(r), np.float32)
                           for r in range(N)])
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("rank", range(N))
def test_broadcast_from_each_root(eager_job, rank):
    outs, bf = eager_job[0][rank]["bcast"]
    for root, out in enumerate(outs):
        np.testing.assert_array_equal(out, np.full(3, 10 * root + 1.0))
    np.testing.assert_array_equal(bf, np.full(3, N - 1 + 0.5))


@pytest.mark.parametrize("rank", range(N))
def test_integer_average_floor_divides(eager_job, rank):
    """The executor's integer average (``executor.py:512-520``): the sum
    floor-divided by the ranks, in the input's dtype."""
    out, dtype = eager_job[0][rank]["intavg"]
    total = sum(np.array([r + 1, 2 * r - 7, 5], np.int64) for r in range(N))
    assert dtype == "torch.int64"
    np.testing.assert_array_equal(out, total // N)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_wire_compressed_ring(eager_job, wire):
    """The compressed ring against the raw one and the exact sum on every
    rank: within the JAX package's round trip of the codec (a value
    crosses the wire as a rank's contribution, as partial sums and as the
    full sum), with fewer bytes sent (bf16 <= 0.55x, int8 <= 0.30x)."""
    from horovod_tpu import cpp_core as ref_cpp
    exact = np.sum([payload(r, WIRE_N, 1) for r in range(N)], axis=0,
                   dtype=np.float64)
    raw, raw_sent = eager_job[0][0]["wire"][0][""]
    np.testing.assert_allclose(raw, exact, rtol=1e-5, atol=1e-4)
    rounds = [payload(r, WIRE_N, 1) for r in range(N)] + [
        exact.astype(np.float32)]
    step = max(float(np.max(np.abs(ref_cpp.wire_roundtrip(wire, x)[0] - x)))
               for x in rounds)
    outs = [eager_job[0][r]["wire"][0][wire] for r in range(N)]
    scale = float(np.max(np.abs(exact)))
    for out, sent in outs:
        err = float(np.max(np.abs(out - exact)))
        assert err <= N * step, (wire, err, step)
        assert float(np.max(np.abs(out - raw))) / scale <= 1e-2
        assert sent <= {"bf16": 0.55, "int8": 0.30}[wire] * raw_sent


@pytest.mark.parametrize("rank", range(N))
def test_response_cache_hits(eager_job, rank):
    """The native control plane's cache serves the repeated async
    bursts."""
    counters = eager_job[0][rank]["cache"][0]
    assert counters.get("control.cache_hits", 0) > 0, counters
    assert counters["controller.ops#type=allreduce"] <= \
        CACHE_BURSTS * CACHE_TENSORS + 32


@pytest.mark.parametrize("rank", range(2))
def test_cached_negotiation_bytes_drop(cache_job, rank):
    """As the reference's ``test_cached_negotiation_bytes_drop``, in a job
    of two processes as there: after the first burst's full negotiation,
    the best steady burst's control bytes (a tick of bits out, a
    served-from-cache frame back) are at least 10x fewer, and the
    coordinator counts cache-served ticks.  The best over many bursts:
    where the processes' ticks split a burst differently, it is
    negotiated in full, just as right (so the reference)."""
    counters, per_burst, cached_ticks = cache_job[rank][0]
    assert counters.get("control.cache_hits", 0) > 0, counters
    first, best = per_burst[0], min(per_burst[6:])
    assert first >= 10 * max(1, best), per_burst
    if rank == 0:
        assert cached_ticks > 0


@pytest.mark.parametrize("rank", range(N))
def test_mismatch_error_is_the_reference_text(eager_job, rank):
    """Every rank raises the same coordinator's error, whose text is the
    JAX package's message table's for the same requests.  The text names
    first the dtype of the request that reached the coordinator first,
    which timing decides, so it is one of the reference's texts for an
    order of arrival."""
    import itertools
    from horovod_tpu import core as ref_core
    (text,) = eager_job[0][rank]["mismatch"]
    assert text == eager_job[0][0]["mismatch"][0]
    texts = set()
    for order in itertools.permutations(range(N)):
        table = ref_core.MessageTable(N)
        for r in order:
            table.increment(ref_core.Request(
                request_rank=r, request_type=ref_core.RequestType.ALLREDUCE,
                tensor_name="mp.bad",
                tensor_type="int32" if r == 0 else "float32",
                tensor_shape=(2,), device=-1))
        texts.add(table.construct_response("mp.bad").error_message)
    assert len(texts) == 2 and text in texts, (text, texts)
    (after,) = eager_job[0][rank]["after"]
    np.testing.assert_array_equal(after, np.full(2, float(N)))


def test_peer_crash_fails_collectives_not_hangs(eager_job):
    """A peer dying without the shutdown handshake surfaces as
    HorovodAbortedError on every survivor, which then shuts down
    cleanly (the reference's test_peer_crash_fails_collectives_not_hangs)."""
    results, exits, _ = eager_job
    assert exits == [0, EXIT_CRASH] + [0] * (N - 2)
    for r in (0, 2):
        kind, text = results[r]["crashed"]
        assert kind == "HorovodAbortedError", (kind, text)


@pytest.mark.parametrize("rank", [0, 2])
def test_timeline_per_rank_parses(eager_job, rank):
    """The trace of each rank that shut down (rank 1 died) is valid Chrome
    trace JSON with the reference's spans."""
    from horovod_tpu_torch.timeline import per_rank_trace_path
    path = per_rank_trace_path(str(eager_job[2]), rank, N)
    events = json.loads(open(path).read())
    assert events[0]["name"] == "trace_t0"
    assert events[0]["args"]["rank"] == rank
    pids = {e["args"]["name"]: e["pid"] for e in events
            if e.get("name") == "process_name"}
    names = [e.get("name") for e in events if e.get("pid") == pids["mp.after"]]
    assert any(str(n).startswith("TCP_ALLREDUCE") for n in names), names


@pytest.mark.parametrize("rank", range(len(HOSTS)))
def test_colocated_ranks_get_distinct_local_ranks(jit_only_job, rank):
    """Without HOROVOD_TPU_LOCAL_RANK, the ranks of each faked host take
    0, 1 by rank order (the reference's host grouping,
    ``core.py:1140-1203``) -- not 0 everywhere."""
    local_rank, _, _, _ = jit_only_job[rank]
    assert local_rank == HOSTS[:rank].count(HOSTS[rank])


@pytest.mark.parametrize("rank", range(len(HOSTS)))
def test_integer_metric_mean_equals_pmean(jit_only_job, rank):
    """An int64 correct-count metric through ``make_eval_step`` averages to
    the float mean, as ``lax.pmean`` computes it on the same values."""
    import jax
    import jax.numpy as jnp
    _, mean, dtype, _ = jit_only_job[rank]
    counts = np.stack([np.array([r + 3, 2 * r + 1], np.int64)
                       for r in range(len(HOSTS))])
    want = jax.vmap(lambda x: jax.lax.pmean(x, "i"), axis_name="i")(
        jnp.asarray(counts))[rank]
    assert dtype == "torch." + str(want.dtype)
    np.testing.assert_array_equal(mean, np.asarray(want))


def test_eager_op_without_control_plane_fails_fast(jit_only_job):
    for rank in range(len(HOSTS)):
        err = jit_only_job[rank][3]
        assert err is not None and "jit-only mode" in err, err
        assert "HOROVOD_TPU_COORD_ADDR" in err
