"""The ``DistributedOptimizer`` surface: gradients averaged across ranks
before every update, optionally over the int8 wire with error feedback.

Port of ``horovod_tpu/jax/__init__.py``: ``DistributedOptimizer``
(:68-173), ``allreduce_gradients`` (:180-337) with both of its branches and
``_overlapped_allreduce`` (:383-515), ``allreduce_`` (:563),
``broadcast_parameters`` (:519) and ``broadcast_optimizer_state`` (:537).
The JAX package wraps an optax transformation; here
:func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer``, one
process per GPU.

Two branches, as in the reference.  The reference picks one by whether a
mesh axis is bound when the update is traced; a PyTorch loop is never
traced, so the caller names it:

* **SPMD branch** (default, :228-276): every leaf is reduced over a
  ``torch.distributed`` process group (``group=None``: the world group).
  Without a process group, or in a group of one, the reduction is the
  identity, as on a one-device mesh.  An int8-eligible leaf under
  ``Compression.int8`` (:func:`.ops.quantized_collectives.int8_eligible`)
  rides its own int8 ring (one leaf per ring, so that its block grid is
  the reference's); every other leaf is averaged raw, cast to the wire
  dtype of a cast compressor around the collective.
* **Eager branch** (``eager=True``, :277-337): every leaf goes through the
  negotiated plane's ``allreduce_async`` (:mod:`.ops.eager`), named
  ``f"{name_prefix}.{i}"`` in leaf order, and the results are synchronized
  in submission order.  float32 leaves hand ``compression`` to the wire
  (the host ring quantizes per hop; NCCL moves CUDA tensors raw, as the
  reference's mesh path does); other dtypes are cast by
  ``compression.compress`` around the collective.  With overlap
  (``overlap=True`` or ``HOROVOD_TPU_OVERLAP``) the float32 leaves are
  packed into the bucket planner's buckets (``HOROVOD_TPU_BUCKET_BYTES``),
  and each bucket -- its leaves concatenated -- is issued as one
  ``allreduce_async`` named ``f"{name_prefix}.bucket{b}"`` as soon as its
  last gradient is final; the ``overlap.*`` metrics and
  :func:`.observe.note_step` record each such step.

Sparse gradients (a sparse COO tensor, as ``nn.Embedding(sparse=True)``
gives, or an :class:`.sparse.IndexedSlices`) take the allgather route on
both branches (:mod:`.sparse`) unless ``sparse_as_dense=True`` densifies
them first.  With ``error_feedback=True`` each lossy leaf (int8-eligible
under int8) adds its residual before the reduction (carry-in) and stores
``g - Q(g)`` after it (carry-out), ``Q`` the local int8 snap, on both
branches.  The residual is f32 and lives in the wrapped optimizer's
``state[p]["residual"]``, so ``state_dict()`` carries it.

``compression="auto"`` (with ``HOROVOD_TPU_PRECISION=auto``) hands the
wire to the precision autopilot (:mod:`.precision`), as
``jax/__init__.py:204-232, 259-273, 333-368`` do.  On the SPMD branch each
leaf is reduced on the rung the process-local mirror names for its
bucket, read when the leaf is reduced: ``f"{name_prefix}{keystr}"``, the
keystr of the leaf's path in the tree handed to
:func:`allreduce_gradients`, or for :func:`DistributedOptimizer` of the
flax path of its parameter name (``named_parameters``; by position,
``[i]``, without them; :func:`.spmd.flax_keystr`).  On the eager branch
requests go out raw (``wire_dtype=""``); after each step the measured
int8-grid residual ``||g - Q(g)|| / ||g||`` of every reduced f32 leaf
that is int8-eligible (of every bucket under overlap, with the size floor
only) is queued for the next request frame, named as the request
(``f"{name_prefix}.{i}"``, ``f"{name_prefix}.bucket{b}"``), and the
coordinator's stamped wire dtype applies on the host ring (NCCL moves
CUDA tensors raw).  ``error_feedback`` is a no-op under ``"auto"``: no
residual is kept.  The wire-plan metrics are not ported yet.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from horovod_tpu_torch import basics
from horovod_tpu_torch import observe as _observe
from horovod_tpu_torch import precision as _precision
from horovod_tpu_torch import scheduler as _sched
from horovod_tpu_torch import sparse as _sparse
from horovod_tpu_torch.compression import NoneCompressor, compressor_for_wire
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops import injit as _injit
from horovod_tpu_torch.ops import quantized_collectives as _qc
from horovod_tpu_torch.spmd import _check_compression as _resolve
from horovod_tpu_torch.spmd import flax_keystr

DEFAULT_NAME_PREFIX = "DistributedOptimizer.grads"


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _global_rank(rank: int, group) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _lossy(compression, g) -> bool:
    """Leaves the wire quantizes: the only ones with a residual."""
    return (isinstance(g, torch.Tensor) and not g.is_sparse
            and _qc.is_int8(compression)
            and _qc.int8_eligible(g.shape, g.dtype))


def _as_leaf(g, sparse_as_dense: bool):
    """A gradient leaf as the reduction takes it: a sparse COO tensor
    becomes :class:`.sparse.IndexedSlices` (or dense under
    ``sparse_as_dense``), slices stay slices."""
    if isinstance(g, _sparse.IndexedSlices):
        return g.to_dense() if sparse_as_dense else g
    if g.is_sparse:
        return g.to_dense() if sparse_as_dense else \
            _sparse.IndexedSlices.from_sparse(g)
    return g


def _reduce_leaf(g, compression, *, average: bool, group,
                 name: str = ""):
    """One leaf of ``allreduce_gradients``' SPMD branch; under ``"auto"``
    on the rung the autopilot's mirror names for bucket ``name``."""
    if isinstance(g, _sparse.IndexedSlices):
        return _sparse.allreduce(g, average=average, group=group)
    if _qc.is_auto(compression):
        compression = compressor_for_wire(
            _precision.get_autopilot().wire_dtype_for(name))
    if _lossy(compression, g):
        return _qc.quantized_ring_allreduce(g, average=average, group=group)
    leaf_comp = NoneCompressor if _qc.is_int8(compression) else compression
    c, ctx = leaf_comp.compress(g)
    if _world(group) > 1:
        c = _injit.allreduce(c, average=average, group=group)
    return leaf_comp.decompress(c, ctx)


def _note_auto_residual(name: str, reduced, flat_ok: bool = False) -> None:
    """Feed the precision autopilot one measured residual: the relative
    norm of the error the int8 grid (the ladder's most aggressive rung)
    would introduce on this reduced gradient (reference
    ``jax/__init__.py:340-368``).  Only f32 leaves that are int8-eligible
    -- with ``flat_ok`` (an overlap bucket, already a bulk 1-D payload)
    the size floor only.  Reduced gradients are identical on every rank,
    so every process reports the same value.  No-op unless
    ``HOROVOD_TPU_PRECISION=auto``."""
    pilot = _precision.get_autopilot()
    if not pilot.enabled or reduced.dtype != torch.float32:
        return
    if flat_ok:
        if reduced.numel() * 4 < _qc.int8_floor_bytes():
            return
    elif not _qc.int8_eligible(reduced.shape, reduced.dtype):
        return
    g = reduced.reshape(-1)
    denom = float(torch.linalg.vector_norm(g))
    if denom <= 0.0:
        pilot.note_residual(name, 0.0)
        return
    r = g - _qc.snap_to_grid(g)
    pilot.note_residual(name, float(torch.linalg.vector_norm(r)) / denom)


class _EagerReduction:
    """One call (one optimizer step) of the eager branch: leaves are
    submitted to the negotiated plane as they become final, in any order,
    and :meth:`wait` returns the reduced leaves in leaf order.

    With ``bucketed`` (the positions of the float32 dense leaves, in leaf
    order) the step is ``_overlapped_allreduce``: those leaves are
    registered with a new bucket planner, and each bucket is issued as
    soon as its last leaf is submitted.  Every other leaf is submitted on
    its own."""

    def __init__(self, *, average: bool, compression, name_prefix: str,
                 bucketed=None):
        self.average = average
        # Under "auto" requests go out raw: the coordinator's response
        # carries the wire dtype, and wait() reports the residuals.
        self.auto = _qc.is_auto(compression)
        self.compression = NoneCompressor if self.auto else compression
        self.name_prefix = name_prefix
        self.submitted: set = set()
        self.bucketed: set = set()
        self._handles: dict = {}      # leaf -> (kind, handle(s), ctx)
        self._buckets: dict = {}      # bucket -> (handle, its leaves)
        self._issue_seq: list = []
        self._t_entry = time.perf_counter()
        self._t_last = self._t_entry
        self._planner = None
        if bucketed is None:
            return
        planner = _sched.make_bucket_planner(_sched.bucket_bytes_from_env())
        self._slot = {}
        for j, (i, nbytes) in enumerate(bucketed):
            planner.register_leaf(f"{name_prefix}.{i}", nbytes, "float32")
            self._slot[i] = j
        self.bucketed = set(self._slot)
        self._bucket_leaves = [[] for _ in range(planner.seal())]
        for i, j in self._slot.items():
            self._bucket_leaves[planner.bucket_of(j)].append(i)
        self._planner = planner
        self._grads: dict = {}        # leaf -> gradient, shape once issued
        self._t_first_issue = None

    def submit(self, i: int, g) -> None:
        """Hand leaf ``i`` (a dense tensor or IndexedSlices) to the plane."""
        self._t_last = time.perf_counter()
        self.submitted.add(i)
        name = f"{self.name_prefix}.{i}"
        if isinstance(g, _sparse.IndexedSlices):
            self._handles[i] = ("sparse", (
                _eager.allgather_async(g.values, name=f"{name}.values"),
                _eager.allgather_async(g.indices, name=f"{name}.indices")),
                g.dense_shape)
        elif i in self.bucketed:
            if g.dtype != torch.float32:
                raise ValueError(
                    f"{name}: a bucketed leaf must stay float32, got "
                    f"{g.dtype}")
            self._grads[i] = g
            self._planner.note_ready(self._slot[i])
            self._drain()
        elif g.dtype == torch.float32:
            self._handles[i] = ("dense", _eager.allreduce_async(
                g, average=self.average, name=name,
                compression=self.compression), None)
        else:
            c, ctx = self.compression.compress(g)
            self._handles[i] = ("dense", _eager.allreduce_async(
                c, average=self.average, name=name), ctx)

    def _drain(self) -> None:
        """Issue every bucket whose leaves are all submitted: the
        concatenation of its leaves on their device, on the current
        stream (which is the one that made the gradients)."""
        while True:
            b = self._planner.next_issue()
            if b < 0:
                return
            if self._t_first_issue is None:
                self._t_first_issue = time.perf_counter()
            leaves = self._bucket_leaves[b]
            flat = (torch.cat([self._grads[i].reshape(-1) for i in leaves])
                    if len(leaves) > 1
                    else self._grads[leaves[0]].reshape(-1))
            for i in leaves:           # the bucket holds the values now
                self._grads[i] = self._grads[i].shape
            self._buckets[b] = (_eager.allreduce_async(
                flat, average=self.average,
                name=f"{self.name_prefix}.bucket{b}",
                compression=self.compression), leaves)
            self._issue_seq.append(b)

    def wait(self, n: int) -> list:
        """Synchronize every submission (buckets in issue order, then the
        other leaves in submission order); the ``n`` reduced leaves in
        leaf order, sparse ones as IndexedSlices."""
        outs = [None] * n
        if self._planner is not None:
            self._wait_buckets(outs)
        for i, (kind, h, extra) in self._handles.items():
            if kind == "sparse":
                values = _eager.synchronize(h[0])
                if self.average:
                    values = values / basics.size()
                outs[i] = _sparse.IndexedSlices(
                    values, _eager.synchronize(h[1]), extra)
            else:
                outs[i] = self.compression.decompress(
                    _eager.synchronize(h), extra)
        if self.auto:
            for i in sorted(self._handles):
                if self._handles[i][0] == "dense":
                    _note_auto_residual(f"{self.name_prefix}.{i}", outs[i])
        return outs

    def _wait_buckets(self, outs: list) -> None:
        t_backward_done = self._t_last
        for b in self._issue_seq:
            h, leaves = self._buckets[b]
            red = _eager.synchronize(h)
            self._planner.note_complete(b)
            if self.auto:
                # The negotiated name under overlap is the bucket's, so the
                # residual report is per bucket too.
                _note_auto_residual(f"{self.name_prefix}.bucket{b}", red,
                                    flat_ok=True)
            off = 0
            for i in leaves:
                shape = self._grads[i]
                n = math.prod(shape)
                outs[i] = self.compression.decompress(
                    red[off:off + n].view(shape), None)
                off += n
        t_comm_done = time.perf_counter()
        self._planner.close()
        if not self._issue_seq:
            return
        comm_span = max(0.0, t_comm_done - self._t_first_issue)
        exposed = max(0.0, t_comm_done - t_backward_done)
        hidden = max(0.0, comm_span - exposed)
        _metrics.inc("overlap.steps")
        _metrics.observe("overlap.hidden_seconds", hidden)
        _metrics.observe("overlap.exposed_seconds", exposed)
        if comm_span > 0:
            _metrics.observe("overlap.hidden_fraction", hidden / comm_span)
        # The span from entry to backward done is compute (communication
        # hides under it), the tail after it is exposed communication,
        # and what neither accounts for is stall.
        step_s = max(0.0, t_comm_done - self._t_entry)
        compute_s = max(0.0, t_backward_done - self._t_entry)
        stall_s = max(0.0, step_s - compute_s - exposed)
        _observe.note_step(step_s, compute_s, hidden, exposed, stall_s)

    def discard(self) -> None:
        """Drop every submission unwaited: the step failed (a membership
        change completed them RETRYABLE, or the job aborted), and the
        controller has already dropped their entries."""
        hm = basics.controller().handle_manager
        for b in self._issue_seq:
            hm.abandon(self._buckets[b][0])
        for kind, h, _ in self._handles.values():
            for one in (h if kind == "sparse" else (h,)):
                hm.abandon(one)
        if self._planner is not None:
            self._planner.close()

    def abandon(self) -> None:
        """Wait out what was submitted and drop it (``zero_grad`` before
        ``step``), so that the names are free for the next step."""
        for b in self._issue_seq:
            _eager.synchronize(self._buckets[b][0])
        for kind, h, _ in self._handles.values():
            for one in (h if kind == "sparse" else (h,)):
                _eager.synchronize(one)
        if self._planner is not None:
            self._planner.close()


def _bucketed(leaves) -> list:
    """(position, bytes) of the leaves the overlapped branch buckets: the
    dense float32 ones."""
    return [(i, g.numel() * 4) for i, g in enumerate(leaves)
            if isinstance(g, torch.Tensor) and g.dtype == torch.float32]


def _restore_form(out, like):
    """A reduced sparse leaf in the form it came in: a sparse COO tensor
    stays one."""
    if isinstance(out, _sparse.IndexedSlices) and \
            isinstance(like, torch.Tensor):
        return out.to_sparse()
    return out


def allreduce_gradients(grads, *, average: bool = True,
                        compression=NoneCompressor,
                        sparse_as_dense: bool = False, group=None,
                        eager: bool = False, overlap: Optional[bool] = None,
                        name_prefix: str = DEFAULT_NAME_PREFIX):
    """Average (or sum) a tree of per-rank tensors (a tensor, or lists,
    tuples and dicts of them) across ranks, leaf by leaf, with the routing
    of :func:`DistributedOptimizer` (no error feedback).

    ``eager=False`` (default): the SPMD branch over ``group``.
    ``eager=True``: the negotiated plane over the world of ``hvd.init()``
    (``group`` must be None), with the overlapped bucketing under
    ``overlap`` (default: ``HOROVOD_TPU_OVERLAP``); every leaf is final at
    the call, so buckets issue in their order.  Sparse leaves (sparse COO
    tensors or :class:`.sparse.IndexedSlices`) come back gathered, in the
    form they came in, unless ``sparse_as_dense``.  ``compression`` takes
    a Compressor class or a wire name; ``HOROVOD_TPU_INJIT_WIRE_DTYPE``
    fills in the default; ``"auto"`` keys each leaf's bucket as
    ``f"{name_prefix}{keystr}"`` of its path in ``grads`` on the SPMD
    branch (``torch.utils._pytree.keystr``, which writes paths as
    ``jax.tree_util.keystr`` does)."""
    compression = _resolve(compression)
    paths, spec = pytree.tree_flatten_with_path(grads)
    given = [g for _, g in paths]
    leaves = [_as_leaf(g, sparse_as_dense) for g in given]
    if not eager:
        out = [_reduce_leaf(g, compression, average=average, group=group,
                            name=name_prefix + pytree.keystr(path))
               for (path, _), g in zip(paths, leaves)]
    else:
        if group is not None:
            raise ValueError(
                "eager=True reduces over the world of hvd.init(); group= "
                "belongs to the SPMD branch")
        red = _EagerReduction(
            average=average, compression=compression,
            name_prefix=name_prefix,
            bucketed=(_bucketed(leaves) if _sched.overlap_enabled(overlap)
                      else None))
        for i, g in enumerate(leaves):
            red.submit(i, g)
        out = red.wait(len(leaves))
    out = [_restore_form(o, g) for o, g in zip(out, given)]
    return pytree.tree_unflatten(out, spec)


def allreduce_(tree, *, average: bool = True, group=None,
               eager: bool = False, name_prefix: str = "allreduce"):
    """Allreduce of an arbitrary tree of tensors (metric averaging)."""
    return allreduce_gradients(tree, average=average, group=group,
                               eager=eager, name_prefix=name_prefix)


class _DistributedOptimizer:
    """The methods :func:`DistributedOptimizer` mixes into the wrapped
    optimizer's class."""

    def _setup(self, *, average, compression, sparse_as_dense,
               error_feedback, overlap, group, eager,
               named_parameters) -> None:
        if eager and group is not None:
            raise ValueError(
                "eager=True reduces over the world of hvd.init(); group= "
                "belongs to the SPMD branch")
        self.average = average
        self.compression = _resolve(compression)
        self.sparse_as_dense = sparse_as_dense
        self.error_feedback = error_feedback
        self.overlap = _sched.overlap_enabled(overlap)
        self.group = group
        self.eager = eager
        self._done: set = set()
        # The eager branch: the step's reduction in flight, and, once the
        # first step has shown which gradients are sparse, the (position,
        # bytes) of the leaves the overlapped step buckets.
        self._reduction: Optional[_EagerReduction] = None
        self._bucket_plan: Optional[list] = None
        self._sparse_ids: set = set()
        self._position = {id(p): i for i, p in enumerate(self._params())}
        # The autopilot's bucket keys of the SPMD branch: the flax path of
        # each named parameter, the position of the others.
        names = {id(p): n for n, p in (named_parameters or ())}
        self._bucket = {
            id(p): DEFAULT_NAME_PREFIX + (flax_keystr(names[id(p)])
                                          if id(p) in names else f"[{i}]")
            for i, p in enumerate(self._params())}
        for p in self._params():
            if error_feedback and _lossy(self.compression, p):
                self.state[p]["residual"] = torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device)
            if self.overlap:
                p.register_post_accumulate_grad_hook(self._hook)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]
                if p.requires_grad]

    def _hook(self, p: torch.Tensor) -> None:
        if id(p) in self._done:
            raise RuntimeError(
                "DistributedOptimizer: a gradient was accumulated twice "
                "before step(); call step() or zero_grad() between backward "
                "passes")
        if not self.eager:
            self._reduce_param(p)
        elif self._bucket_plan is not None:
            # The first step has no plan yet: step() submits everything.
            self._submit(self._eager_reduction(), self._position[id(p)], p)
        self._done.add(id(p))

    def _carried_in(self, p: torch.Tensor, g):
        """The leaf ``p`` contributes, with its residual added when the
        wire quantizes it, and the residual's carry-out stored."""
        if not (self.error_feedback and _lossy(self.compression, g)):
            return g
        state = self.state[p]
        r = state.get("residual")
        if r is None:
            r = torch.zeros_like(g, dtype=torch.float32)
        g = g + r.to(g.dtype)
        g32 = g.to(torch.float32)
        state["residual"] = g32 - _qc.snap_to_grid(g32)
        return g

    def _grad(self, p: torch.Tensor):
        """``p``'s gradient as a leaf of the reduction: zeros when it has
        none (an empty slice set where the first step found it sparse),
        so that every rank issues the same collectives."""
        g = p.grad
        if g is not None and g.is_sparse:
            self._sparse_ids.add(id(p))
        if g is None:
            if id(p) in self._sparse_ids:
                return _sparse.IndexedSlices(
                    torch.zeros((0,) + tuple(p.shape[1:]), dtype=p.dtype,
                                device=p.device),
                    torch.zeros(0, dtype=torch.int64, device=p.device),
                    tuple(p.shape))
            g = torch.zeros_like(p)
        return _as_leaf(g, self.sparse_as_dense)

    def _reduce_param(self, p: torch.Tensor) -> None:
        """The SPMD branch, one parameter."""
        g = self._carried_in(p, self._grad(p))
        red = _reduce_leaf(g, self.compression, average=self.average,
                           group=self.group, name=self._bucket[id(p)])
        p.grad = (red.to_dense() if isinstance(red, _sparse.IndexedSlices)
                  else red)
        self._done.add(id(p))

    def _eager_reduction(self) -> _EagerReduction:
        if self._reduction is None:
            self._reduction = _EagerReduction(
                average=self.average, compression=self.compression,
                name_prefix=DEFAULT_NAME_PREFIX,
                bucketed=self._bucket_plan if self.overlap else None)
        return self._reduction

    def _submit(self, red: _EagerReduction, i: int,
                p: torch.Tensor) -> None:
        g = self._carried_in(p, self._grad(p))
        if isinstance(g, _sparse.IndexedSlices) and i in red.bucketed:
            raise RuntimeError(
                f"DistributedOptimizer: the gradient of parameter {i} is "
                f"sparse, but it was dense in the first step, which fixed "
                f"the overlap buckets")
        red.submit(i, g)

    def synchronize(self) -> None:
        """Reduce every gradient that no hook has reduced yet, in
        parameter order (eager: submit them, then wait for the whole
        step's reduction)."""
        params = self._params()
        self._position = {id(p): i for i, p in enumerate(params)}
        if not self.eager:
            for p in params:
                if id(p) not in self._done:
                    self._reduce_param(p)
            self._done.clear()
            return
        if self.overlap and self._bucket_plan is None:
            self._bucket_plan = _bucketed([self._grad(p) for p in params])
        red = self._eager_reduction()
        try:
            for i, p in enumerate(params):
                if i not in red.submitted:
                    self._submit(red, i, p)
            outs = red.wait(len(params))
        except BaseException:
            # A failed step (HorovodRetryableError after a membership
            # change, an abort) leaves nothing for the next one to wait on.
            red.discard()
            self._done.clear()
            raise
        finally:
            self._reduction = None
        for p, g in zip(params, outs):
            p.grad = (g.to_dense() if isinstance(g, _sparse.IndexedSlices)
                      else g)
        self._done.clear()

    def step(self, closure=None):
        """Run ``closure`` (forward and backward) if given, reduce the
        gradients, and apply the wrapped optimizer's update.  The residuals
        are held out of the state while that update runs, so that an
        optimizer which initializes an empty state (Adam, ...) sees it
        empty on its first step."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.synchronize()
        held = {}
        for p in self._params():
            if p in self.state and "residual" in self.state[p]:
                held[p] = self.state[p].pop("residual")
                if not self.state[p]:
                    del self.state[p]
        try:
            super().step()
        finally:
            for p, r in held.items():
                self.state[p]["residual"] = r
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self._reduction is not None:
            self._reduction.abandon()
            self._reduction = None
        self._done.clear()
        super().zero_grad(set_to_none)

    def load_state_dict(self, state_dict) -> None:
        """The wrapped optimizer's ``load_state_dict``, except that the
        residuals stay f32: the base class would cast them to their
        parameters' dtype."""
        saved = state_dict["state"]
        residuals = {k: s["residual"] for k, s in saved.items()
                     if "residual" in s}
        super().load_state_dict({**state_dict, "state": {
            k: {n: v for n, v in s.items() if n != "residual"}
            for k, s in saved.items()}})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            if i in residuals:
                self.state[p]["residual"] = residuals[i].to(
                    device=p.device, dtype=torch.float32)


def DistributedOptimizer(optimizer: torch.optim.Optimizer, *,
                         average: bool = True, compression=NoneCompressor,
                         sparse_as_dense: bool = False,
                         error_feedback: bool = False,
                         overlap: Optional[bool] = None, group=None,
                         eager: bool = False, named_parameters=None):
    """Wrap ``optimizer`` so that its updates consume rank-averaged
    gradients.

    Returns an instance of a subclass of ``optimizer``'s class that takes
    over its parameter groups, state and hooks: an ``Optimizer`` (an LR
    scheduler accepts it) to use in place of ``optimizer``, as
    ``zero_grad()``, ``loss.backward()``, ``step()``.  ``step()`` reduces
    every gradient (see the module docstring), then runs the wrapped
    class's step.  ``eager=True`` takes the negotiated eager branch
    (module docstring) instead of the SPMD branch over ``group``.

    ``overlap`` (default: the ``HOROVOD_TPU_OVERLAP`` knob) registers a
    post-accumulate-grad hook on each parameter, so that a leaf's carry-in
    and reduction start as soon as its gradient is final during backward;
    ``step()`` then reduces what the hooks did not and waits.  On the SPMD
    branch reductions are per leaf; on the eager branch a hook marks its
    leaf ready in the bucket planner and issues every bucket that became
    complete.  The eager branch learns from its first step which
    gradients are sparse; that step issues its buckets from ``step()``.
    Overlap changes when a reduction starts, not what it computes.  A
    parameter without a gradient contributes zeros (an empty slice set if
    its gradient was sparse), submitted by ``step()`` in parameter order,
    so that every rank issues the same collectives.  Drive it with a
    plain loop, not through ``spmd.make_train_step``, which reduces the
    gradients itself.

    ``compression`` is read once, here (class, wire name, the
    ``HOROVOD_TPU_INJIT_WIRE_DTYPE`` fill-in, or ``"auto"``: the module
    docstring).  ``named_parameters`` (``model.named_parameters()``, as
    Horovod's PyTorch optimizer takes it) names the SPMD branch's
    autopilot buckets as the JAX package names the same leaves of a flax
    parameter tree.  Without it a parameter is keyed by its position,
    ``DistributedOptimizer.grads[i]``, a name the JAX package never gives
    a leaf of such a tree: a ladder warmed on its names leaves these
    parameters on fp32.
    """
    base = type(optimizer)
    cls = type(f"Distributed{base.__name__}", (_DistributedOptimizer, base),
               {})
    wrapped = cls.__new__(cls)
    wrapped.__dict__.update(optimizer.__dict__)
    wrapped._setup(average=average, compression=compression,
                   sparse_as_dense=sparse_as_dense,
                   error_feedback=error_feedback, overlap=overlap,
                   group=group, eager=eager,
                   named_parameters=(None if named_parameters is None
                                     else list(named_parameters)))
    return wrapped


def broadcast_parameters(params, root_rank: int = 0, *, group=None):
    """Broadcast parameters from ``root_rank`` to every rank of ``group``,
    in place: a module (its ``state_dict()``), a ``state_dict``, an iterable
    of ``(name, tensor)`` pairs or of tensors.  Returns ``params``."""
    if isinstance(params, torch.nn.Module):
        tensors = list(params.state_dict().values())
    elif isinstance(params, dict):
        tensors = list(params.values())
    else:
        params = list(params)
        tensors = [t[1] if isinstance(t, tuple) else t for t in params]
    if _world(group) > 1:
        src = _global_rank(root_rank, group)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=src, group=group)
    return params


class _Slot:
    """A ``state_dict`` leaf as the root rank describes it to the others:
    a tensor by shape, dtype and device type, a Python int or float by its
    type, anything else by its value."""

    def __init__(self, value):
        self.value = None
        if isinstance(value, torch.Tensor):
            self.kind = "tensor"
            self.shape = tuple(value.shape)
            self.dtype = value.dtype
            self.device = value.device.type
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            self.kind = type(value).__name__
        else:
            self.kind = "other"
            self.value = value


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_optimizer_state(optimizer, root_rank: int = 0, *, group=None):
    """Broadcast ``optimizer.state_dict()`` from ``root_rank`` and load it
    on every rank of ``group``.

    The root first sends the structure of its state (a rank whose state is
    still empty, before its first step, takes it over).  Then every tensor
    is broadcast, and every Python int and float is wrapped in a tensor,
    broadcast and restored to its type, as the JAX package does."""
    if _world(group) == 1:
        return
    src = _global_rank(root_rank, group)
    root = dist.get_rank() == src
    comm = _comm_device(group)
    state = optimizer.state_dict()
    mine, _ = pytree.tree_flatten(state)
    box = [pytree.tree_map(_Slot, state) if root else None]
    dist.broadcast_object_list(box, src=src, group=group)
    slots, spec = pytree.tree_flatten(box[0])
    out = []
    for i, slot in enumerate(slots):
        if slot.kind == "tensor":
            if root:
                buf = mine[i].detach().to(comm).clone()
            else:
                buf = torch.empty(slot.shape, dtype=slot.dtype, device=comm)
            dist.broadcast(buf, src=src, group=group)
            out.append(buf.to("cpu") if slot.device == "cpu" else buf)
        elif slot.kind in ("int", "float"):
            dtype = torch.int64 if slot.kind == "int" else torch.float64
            buf = torch.tensor(mine[i] if root else 0, dtype=dtype,
                               device=comm)
            dist.broadcast(buf, src=src, group=group)
            out.append(int(buf.item()) if slot.kind == "int"
                       else float(buf.item()))
        else:
            out.append(slot.value)
    optimizer.load_state_dict(pytree.tree_unflatten(out, spec))
