"""The ``DistributedOptimizer`` surface: gradients averaged across ranks
before every update, optionally over the int8 wire with error feedback.

Port of ``horovod_tpu/jax/__init__.py``: ``DistributedOptimizer``
(:68-173) with the semantics of the SPMD branch of ``allreduce_gradients``
(:228-276), that branch as :func:`allreduce_gradients`, ``allreduce_``
(:563), ``broadcast_parameters`` (:519) and ``broadcast_optimizer_state``
(:537).  The JAX package wraps an optax transformation and reduces over a
mesh axis; here :func:`DistributedOptimizer` wraps a
``torch.optim.Optimizer`` and reduces over a ``torch.distributed`` process
group (``group=None``: the world group), one process per GPU.  Without a
process group, or in a group of one, every reduction is the identity, as on
a one-device mesh.

Per gradient, as in the reference:

* an int8-eligible leaf under ``Compression.int8``
  (:func:`.ops.quantized_collectives.int8_eligible`) rides its own int8 ring
  (:func:`.ops.quantized_collectives.quantized_ring_allreduce`), one leaf
  per ring, so that its block grid is the reference's;
* every other leaf is averaged raw, cast to the wire dtype of a cast
  compressor around the collective;
* with ``error_feedback=True`` each lossy leaf (int8-eligible under int8)
  adds its residual before the reduction (carry-in) and stores
  ``g - Q(g)`` after it (carry-out), ``Q`` the local int8 snap.  The
  residual is f32 and lives in the wrapped optimizer's
  ``state[p]["residual"]``, so ``state_dict()`` carries it.

Not ported yet: the negotiated eager path and its bucketed overlap
(``allreduce_gradients`` :277-337, ``_overlapped_allreduce`` :383),
``callbacks.py``, the sparse allgather route (a sparse gradient raises
unless ``sparse_as_dense=True``) and the wire-plan metrics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from horovod_tpu_torch import scheduler as _sched
from horovod_tpu_torch.compression import NoneCompressor
from horovod_tpu_torch.ops import injit as _injit
from horovod_tpu_torch.ops import quantized_collectives as _qc
from horovod_tpu_torch.spmd import _check_compression as _resolve


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _global_rank(rank: int, group) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _lossy(compression, g) -> bool:
    """Leaves the wire quantizes: the only ones with a residual."""
    return _qc.is_int8(compression) and _qc.int8_eligible(g.shape, g.dtype)


def _densify(g: torch.Tensor, sparse_as_dense: bool) -> torch.Tensor:
    if not g.is_sparse:
        return g
    if not sparse_as_dense:
        raise NotImplementedError(
            "sparse gradients ride the sparse allgather path, which is not "
            "ported; pass sparse_as_dense=True")
    return g.to_dense()


def _reduce_leaf(g: torch.Tensor, compression, *, average: bool,
                 group) -> torch.Tensor:
    """One leaf of ``allreduce_gradients``' SPMD branch."""
    if _lossy(compression, g):
        return _qc.quantized_ring_allreduce(g, average=average, group=group)
    leaf_comp = NoneCompressor if _qc.is_int8(compression) else compression
    c, ctx = leaf_comp.compress(g)
    if _world(group) > 1:
        c = _injit.allreduce(c, average=average, group=group)
    return leaf_comp.decompress(c, ctx)


def allreduce_gradients(grads, *, average: bool = True,
                        compression=NoneCompressor,
                        sparse_as_dense: bool = False, group=None):
    """Average (or sum) a tree of per-rank tensors (a tensor, or lists,
    tuples and dicts of them) across ``group``, leaf by leaf, with the
    routing of :func:`DistributedOptimizer` (no error feedback).
    ``compression`` takes a Compressor class or a wire name;
    ``HOROVOD_TPU_INJIT_WIRE_DTYPE`` fills in the default."""
    compression = _resolve(compression)
    leaves, spec = pytree.tree_flatten(grads)
    out = [_reduce_leaf(_densify(g, sparse_as_dense), compression,
                        average=average, group=group) for g in leaves]
    return pytree.tree_unflatten(out, spec)


def allreduce_(tree, *, average: bool = True, group=None):
    """Allreduce of an arbitrary tree of tensors (metric averaging)."""
    return allreduce_gradients(tree, average=average, group=group)


class _DistributedOptimizer:
    """The methods :func:`DistributedOptimizer` mixes into the wrapped
    optimizer's class."""

    def _setup(self, *, average, compression, sparse_as_dense,
               error_feedback, overlap, group) -> None:
        self.average = average
        self.compression = _resolve(compression)
        self.sparse_as_dense = sparse_as_dense
        self.error_feedback = error_feedback
        self.overlap = _sched.overlap_enabled(overlap)
        self.group = group
        self._done: set = set()
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
        self._reduce_param(p)

    def _reduce_param(self, p: torch.Tensor) -> None:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = _densify(g, self.sparse_as_dense)
        lossy = self.error_feedback and _lossy(self.compression, g)
        if lossy:
            state = self.state[p]
            r = state.get("residual")
            if r is None:
                r = torch.zeros_like(g, dtype=torch.float32)
            g = g + r.to(g.dtype)
        red = _reduce_leaf(g, self.compression, average=self.average,
                           group=self.group)
        if lossy:
            g32 = g.to(torch.float32)
            state["residual"] = g32 - _qc.snap_to_grid(g32)
        p.grad = red
        self._done.add(id(p))

    def synchronize(self) -> None:
        """Reduce every gradient that no hook has reduced yet, in
        parameter order."""
        for p in self._params():
            if id(p) not in self._done:
                self._reduce_param(p)
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
                         overlap: Optional[bool] = None, group=None):
    """Wrap ``optimizer`` so that its updates consume rank-averaged
    gradients.

    Returns an instance of a subclass of ``optimizer``'s class that takes
    over its parameter groups, state and hooks: an ``Optimizer`` (an LR
    scheduler accepts it) to use in place of ``optimizer``, as
    ``zero_grad()``, ``loss.backward()``, ``step()``.  ``step()`` reduces
    every gradient (see the module docstring), then runs the wrapped
    class's step.  ``overlap`` (default: the ``HOROVOD_TPU_OVERLAP`` knob)
    registers a post-accumulate-grad hook on each parameter, so that a
    leaf's carry-in and reduction start as soon as its gradient is final
    during backward; ``step()`` then reduces only what the hooks did not.
    Reductions are per leaf, so overlap on and off give bit-identical
    results.  A parameter without a gradient contributes zeros, so that
    every rank issues the same collectives.  Drive it with a plain loop,
    not through ``spmd.make_train_step``, which reduces the gradients
    itself.

    ``compression`` is read once, here (class, wire name, or the
    ``HOROVOD_TPU_INJIT_WIRE_DTYPE`` fill-in); ``"auto"`` raises
    ``NotImplementedError``.
    """
    base = type(optimizer)
    cls = type(f"Distributed{base.__name__}", (_DistributedOptimizer, base),
               {})
    wrapped = cls.__new__(cls)
    wrapped.__dict__.update(optimizer.__dict__)
    wrapped._setup(average=average, compression=compression,
                   sparse_as_dense=sparse_as_dense,
                   error_feedback=error_feedback, overlap=overlap,
                   group=group)
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
