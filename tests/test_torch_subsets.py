"""Rank subsets (``hvd.init(ranks=)``) of the port against the JAX
package's ``horovod_tpu.topology.resolve(ranks)``.

* The rank map and the four error texts: for several subsets and every
  launched rank of a job of 8, the port's ``topology.resolve(ranks)``
  (launched rank from ``HOROVOD_TPU_RANK``) against the JAX package's on
  the conftest's 8 CPU devices (launched rank = device id), text for text.
* A 4-process gloo job (``_torch_injit_worker.subset_worker``) with
  ``ranks=[3, 1, 2]``: launched rank 0 raises before any rendezvous; the
  three members have size 3 and ranks 3 -> 0, 1 -> 1, 2 -> 2, reduce and
  broadcast (``injit.broadcast``, both modes) equal to numpy, train a
  linear model through ``make_train_step`` to numpy's trajectory, see
  ``HOROVOD_TPU_PROCESS_SETS`` in the subset's rank space, and their eager
  collectives raise (no control plane).
* Under a coordinator (``python -m horovod_tpu_torch.run``, and
  ``elastic.init``) a subset is refused with the reference's text.
* ``hvd.ranks_mesh()``, ``devices()`` and ``local_devices()`` raise
  before ``init``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import horovod_tpu_torch as hvd
from _torch_injit_worker import subset_worker
from _torch_spmd_worker import once, run_group
from horovod_tpu import topology as jtopo
from horovod_tpu_torch import elastic, topology

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBSETS = ([3, 1, 2], list(range(8)), [7, 0], [5], [2, 4, 6, 0],
           (6, 5, 4, 3, 2, 1, 0))
BAD = ([1, 1, 2], [0, 8], [-1, 2], [3, 3, 9], [])
SUBSET = [3, 1, 2]
LR, STEPS = 0.05, 4


@pytest.fixture
def launched(monkeypatch):
    """Set this process's launch: rank ``r`` of 8, no control plane."""
    for knob in ("COORD_ADDR", "PROCESS_COUNT", "PROCESS_INDEX", "STANDBY",
                 "ELASTIC", "LOCAL_RANK", "LOCAL_SIZE"):
        monkeypatch.delenv("HOROVOD_TPU_" + knob, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_SIZE", "8")

    def at(r):
        monkeypatch.setenv("HOROVOD_TPU_RANK", str(r))
    return at


def _jax(ranks):
    """(rank map, None) or (None, (error type, text)) of the reference."""
    try:
        t = jtopo.resolve(ranks)
    except (ValueError, RuntimeError) as e:
        return None, (type(e).__name__, str(e))
    return {d.id: i for i, d in enumerate(t.devices)}, None


def _port(ranks, launched):
    """The port's rank map over the 8 launched ranks, and the errors of
    the launched ranks outside the subset."""
    got, errors = {}, set()
    for r in range(8):
        launched(r)
        try:
            t = topology.resolve(ranks)
        except (ValueError, RuntimeError) as e:
            errors.add((type(e).__name__, str(e)))
            continue
        assert t.size == len(ranks) and t.launched_rank == r
        got[r] = t.rank
    return got, errors


@pytest.mark.parametrize("ranks", SUBSETS, ids=str)
def test_rank_map_matches_the_reference(ranks, launched):
    want, err = _jax(ranks)
    assert err is None
    got, errors = _port(ranks, launched)
    assert got == want
    assert [r for r, _ in sorted(got.items(), key=lambda kv: kv[1])] == \
        list(ranks)
    if len(ranks) < 8:
        # Outside the subset: the reference's text for a process that owns
        # none of its devices.
        _, empty = _jax([])
        assert errors == {empty}
    else:
        assert not errors


@pytest.mark.parametrize("ranks", BAD, ids=str)
def test_errors_match_the_reference(ranks, launched):
    _, want = _jax(ranks)
    assert want is not None
    _, errors = _port(ranks, launched)
    assert errors == {want}


def test_all_four_texts_are_covered(launched, monkeypatch):
    texts = {_jax(r)[1][1] for r in BAD}
    assert texts == {
        "duplicate ranks in subset",
        "rank subset [0, 8] out of range for 8 devices",
        "rank subset [-1, 2] out of range for 8 devices",
        "this process owns no devices in the requested rank subset"}
    launched(0)
    monkeypatch.setenv("HOROVOD_TPU_COORD_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("HOROVOD_TPU_PROCESS_COUNT", "2")
    with pytest.raises(ValueError) as want:
        jtopo.resolve([0])
    with pytest.raises(ValueError) as got:
        topology.resolve([0])
    assert str(got.value) == str(want.value) == (
        "rank subsets are not supported in multi-process mode")
    # Without a subset the coordinator's job resolves as before.
    assert topology.resolve().size == 8


def test_elastic_init_refuses_a_subset_under_a_coordinator(launched,
                                                           monkeypatch):
    launched(1)
    monkeypatch.setenv("HOROVOD_TPU_COORD_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("HOROVOD_TPU_PROCESS_COUNT", "8")
    monkeypatch.setenv("HOROVOD_TPU_ELASTIC", "1")
    hvd.shutdown()
    with pytest.raises(ValueError, match="^rank subsets are not supported "
                                         "in multi-process mode$"):
        elastic.init([0, 1], device="cpu")
    assert not hvd.is_initialized()


def test_queries_raise_before_init():
    hvd.shutdown()
    for query in (hvd.ranks_mesh, hvd.devices, hvd.local_devices):
        with pytest.raises(hvd.NotInitializedError):
            query()


def test_one_process_subset_of_itself(launched):
    """A member alone in its subset is a job of one rank on its device."""
    launched(5)
    hvd.shutdown()
    try:
        hvd.init([5], device="cpu")
        assert (hvd.size(), hvd.rank()) == (1, 0)
        assert hvd.devices() == hvd.local_devices() == (
            hvd.basics._state.device,)
        mesh = hvd.ranks_mesh()
        assert (mesh.shape, mesh.axis_names, mesh.coords) == (
            (1,), ("ranks",), (0,))
        assert hvd.get_topology().launched_rank == 5
    finally:
        hvd.shutdown()


def _data():
    rng = np.random.RandomState(11)
    x = rng.randn(12, 3).astype(np.float32)
    y = (x @ rng.randn(3, 1)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def job(request, tmp_path_factory):
    return once(request, tmp_path_factory, "subset_job", lambda: run_group(
        subset_worker, 4, SUBSET, "pair:0,1", LR, STEPS, _data(),
        init=False))


def test_excluded_rank_raises_before_any_rendezvous(job):
    assert job[0] == {
        "error": "this process owns no devices in the requested rank subset",
        "initialized": False, "dist": False}


def test_members_take_their_subset_ranks(job):
    for launched_rank in SUBSET:
        got = job[launched_rank]
        assert got["size"] == 3
        assert got["rank"] == SUBSET.index(launched_rank)
        assert got["world"] == (3, got["rank"])
        assert got["mesh"] == ((3,), ("ranks",), (got["rank"],))
        assert got["devices"] == got["local_devices"] == ["cpu"]
        # Host discovery ranks a host's members by their launched ranks,
        # never by their subset ranks.
        assert got["local_rank"] == sorted(SUBSET).index(launched_rank)


def test_member_keeps_the_local_rank_of_its_launch(launched, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_LOCAL_RANK", "3")
    launched(3)
    t = topology.resolve(SUBSET)
    assert (t.rank, t.size, t.local_rank, t.launched_rank) == (0, 3, 3, 3)
    assert topology.resolve().launched_rank is None


def test_members_reduce_and_broadcast_as_numpy(job):
    values = {r: np.full(4, r * 10 + 1, np.float32) for r in SUBSET}
    for r in SUBSET:
        np.testing.assert_array_equal(job[r]["sum"], sum(values.values()))
        for got in job[r]["bcast"]:
            # Subset rank 2 is launched rank 2.
            np.testing.assert_array_equal(got, values[SUBSET[2]])


def test_process_sets_name_subset_ranks(job):
    """``pair:0,1`` is subset ranks 0 and 1: launched ranks 3 and 1."""
    for r in SUBSET:
        assert job[r]["pair"] == ([0, 1], r in (3, 1))
    assert job[3]["pair_sum"] == job[1]["pair_sum"] == 3.0 + 1.0
    assert "pair_sum" not in job[2]


def test_members_train_as_numpy(job):
    """SGD on the mean of the three members' gradients, each member on its
    own rows (subset rank order), written out in float64."""
    x, y = _data()
    blocks = np.array_split(np.arange(len(x)), 3)
    w = np.zeros((1, 3))
    losses = []
    for _ in range(STEPS):
        per = []
        grads = []
        for rows in blocks:
            err = x[rows] @ w.T - y[rows]
            per.append(float(np.mean(err ** 2)))
            grads.append(2 * err.T @ x[rows] / len(rows))
        losses.append(np.mean(per))
        w = w - LR * np.mean(grads, axis=0)
    for r in SUBSET:
        np.testing.assert_allclose(job[r]["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(job[r]["weight"], w, rtol=1e-5)
        np.testing.assert_array_equal(job[r]["weight"], job[3]["weight"])
    assert losses[-1] < losses[0]


def test_eager_collectives_need_a_control_plane(job):
    for r in SUBSET:
        assert job[r]["eager"].startswith("CollectiveError: ")
        assert "needs the TCP control plane" in job[r]["eager"]


def test_launcher_job_refuses_a_subset():
    """Every child of ``python -m horovod_tpu_torch.run`` has a
    coordinator: ``init(ranks=)`` raises the reference's text there."""
    child = ("import sys, horovod_tpu_torch as hvd\n"
             "try:\n    hvd.init([0], device='cpu')\n"
             "except ValueError as e:\n"
             "    print('REFUSED', hvd.is_initialized(), e, flush=True)\n"
             "    sys.exit(0)\n"
             "sys.exit(1)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_TPU_", "MASTER_", "TORCHELASTIC_"))}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
         sys.executable, "-c", child], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr
    lines = [l for l in proc.stdout.splitlines() if l.startswith("REFUSED")]
    assert lines == ["REFUSED False rank subsets are not supported in "
                     "multi-process mode"] * 2
