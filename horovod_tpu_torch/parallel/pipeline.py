"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Port of ``horovod_tpu/parallel/pipeline.py``: ``stage_params_init``
(:37), ``pipeline_apply`` (:48), ``microbatch`` (:104) and
``unmicrobatch`` (:113).  Layers are split into S stages, one per rank of
the ``pp`` axis, and a batch into M microbatches that stream through
them over ``M + S - 1`` ticks.  On every tick every stage computes, the
garbage ticks at the ends of the schedule included, as in the JAX
package's ``lax.scan``; activations go down a non-wrapping
:func:`.collectives.ppermute` chain, and the last stage's outputs are
replicated by a masked :func:`.collectives.psum`.

The JAX package differentiates the whole scan; in PyTorch a collective
inside the autograd graph runs only where its output reaches the loss,
which differs from stage to stage (a garbage tick's output reaches
nothing), so a per-tick ``ppermute`` in the graph would leave one stage
waiting for a send another never posts.  :func:`pipeline_apply` is
therefore one autograd Function: its forward runs the schedule, keeping
each tick's graph from its input to its output, and its backward runs the
transposed schedule, tick by tick in reverse: each stage takes the
cotangent of its tick's output (the collected microbatch's, on the last
stage, plus what the next stage sends back), differentiates that tick
and sends its input's cotangent to the stage before.  Every stage posts
the same exchanges in the same order, forward and backward, and every
tick is differentiated, as JAX transposes every tick of the scan.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn as nn
from torch.utils._pytree import tree_leaves

from horovod_tpu_torch.parallel.collectives import _all_reduce, _exchange
from horovod_tpu_torch.parallel.mesh import AxisGroup, fold_in, resolve

PP_AXIS = "pp"


def stage_params_init(init_fn: Callable[[int], Any], seed: int, *,
                      axis=PP_AXIS, mesh=None):
    """``init_fn(stage_seed)`` with the stage's index along ``axis``
    folded into ``seed`` (:func:`.mesh.fold_in`), so that each stage
    draws distinct parameters: e.g. ``lambda s: BlockStack(...,
    seed=s)``."""
    return init_fn(fold_in(seed, resolve(mesh, axis).index))


def _param_leaves(stage_params):
    if isinstance(stage_params, nn.Module):
        return [p for p in stage_params.parameters() if p.requires_grad]
    return [p for p in tree_leaves(stage_params)
            if isinstance(p, torch.Tensor) and p.requires_grad]


def _schedule(stage_fn, stage_params, ax: AxisGroup, x, keep: bool):
    """The forward schedule: the replicated outputs, and with ``keep``
    each tick's (input, output) graph."""
    S, stage = ax.size, ax.index
    M = x.shape[0]
    fwd = [(i, i + 1) for i in range(S - 1)]         # no wrap
    state = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    ticks = []
    for t in range(M + S - 1):
        # Stage 0 feeds from the input queue, later stages from the wire.
        feed = x[min(t, M - 1)] if stage == 0 else state
        if keep:
            inp = feed.detach().requires_grad_(x.requires_grad or stage > 0)
            with torch.enable_grad():
                out = stage_fn(stage_params, inp)
            ticks.append((inp, out))
            out = out.detach()
        else:
            out = stage_fn(stage_params, feed)
        # The last stage finished microbatch t - (S - 1) this tick.
        if stage == S - 1 and t >= S - 1:
            outputs[t - (S - 1)] = out
        state = _exchange((out,), ax, fwd)[0]
    # Replicate the last stage's outputs on every stage.
    return (_all_reduce(outputs, ax) if S > 1 else outputs), ticks


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, stage_params, ax: AxisGroup, x, *params):
        outputs, ticks = _schedule(stage_fn, stage_params, ax, x, True)
        ctx.args = (ax, params, ticks, x.requires_grad)
        return outputs

    @staticmethod
    def backward(ctx, ct_outputs):
        ax, params, ticks, x_grad = ctx.args
        S, stage = ax.size, ax.index
        M = ct_outputs.shape[0]
        back = [(i + 1, i) for i in range(S - 1)]
        grads = [torch.zeros_like(p) for p in params]
        ct_x = torch.zeros_like(ct_outputs)
        ct_next = torch.zeros_like(ct_outputs[0])    # from stage + 1
        for t in reversed(range(M + S - 1)):
            inp, out = ticks[t]
            # Stage s + 1 sends back the cotangent of what it received at
            # tick t + 1, which is this stage's output of tick t.
            ct_out = _exchange((ct_next,), ax, back)[0]
            if stage == S - 1 and t >= S - 1:
                ct_out = ct_out + ct_outputs[t - (S - 1)]
            wrt = ([inp] if inp.requires_grad else []) + list(params)
            got = torch.autograd.grad(out, wrt, ct_out, allow_unused=True)
            if inp.requires_grad:
                ct_inp, got = got[0], got[1:]
            else:
                ct_inp = torch.zeros_like(inp)
            for g, d in zip(grads, got):
                if d is not None:
                    g += d
            if stage == 0 and x_grad:
                ct_x[min(t, M - 1)] += ct_inp
            ct_next = ct_inp
        ctx.args = None
        # x is replicated over the axis: its cotangent is the sum of every
        # stage's (only stage 0 reads it).
        if x_grad and S > 1:
            ct_x = _all_reduce(ct_x, ax)
        return (None, None, None, ct_x if x_grad else None, *grads)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches, *,
                   axis=PP_AXIS, mesh=None):
    """Run ``x_microbatches`` through ``S`` pipelined stages along
    ``axis`` of ``mesh``.

    ``stage_fn(stage_params, activation) -> activation`` is ONE stage's
    computation (all stages share the activation shape);
    ``stage_params`` is this rank's stage: a module (its parameters get
    gradients) or a tree of tensors.  ``x_microbatches``: ``(M,
    microbatch, ...)``, the same on every stage.  Returns the ``(M,
    microbatch, ...)`` outputs, replicated on every stage; their
    gradient flows to every stage's parameters and, summed over the
    stages, to ``x_microbatches``."""
    ax = resolve(mesh, axis)
    if not torch.is_grad_enabled():
        return _schedule(stage_fn, stage_params, ax, x_microbatches,
                         False)[0]
    params = _param_leaves(stage_params)
    return _Pipeline.apply(stage_fn, stage_params, ax, x_microbatches,
                           *params)


def microbatch(x, num_microbatches: int):
    """(B, ...) -> (M, B/M, ...) for :func:`pipeline_apply`."""
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(
            f"batch {B} not divisible by num_microbatches={num_microbatches}")
    return x.reshape((num_microbatches, B // num_microbatches)
                     + tuple(x.shape[1:]))


def unmicrobatch(x):
    """Inverse of :func:`microbatch`."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
