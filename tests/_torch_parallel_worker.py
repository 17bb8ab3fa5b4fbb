"""Torch-only workers of the parallelism-library tests
(``test_torch_{ring_attention,ulysses,tensor_parallel,pipeline,moe,
transformer}.py``): each runs in every process of one gloo group
(``_torch_spmd_worker.run_group``) and returns numpy arrays.  Kept apart
from the test files so that a spawned worker imports PyTorch and the
port, not JAX."""

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import weights
from horovod_tpu_torch.parallel import collectives as C
from horovod_tpu_torch.parallel.mesh import build_mesh


def _mesh(shape, names):
    return build_mesh(hvd.get_topology(), shape, names)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().numpy().copy()


def _shard(a, dim, ax):
    """This rank's contiguous block of numpy ``a`` along ``dim``."""
    return np.split(np.asarray(a), ax.size, axis=dim)[ax.index]


# ------------------------------------------------ ring attention, 4 ranks


def ring_worker(rank, cases, coll):
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    mesh = _mesh((4,), ("sp",))
    ax = mesh.axis("sp")
    out = {"coords": (ax.size, ax.index, ax.ranks)}
    for key, (q, k, v, g, causal, layout) in cases.items():
        q, k, v = (_t(_shard(a, 1, ax), True) for a in (q, k, v))
        o = ring_attention(q, k, v, axis_name="sp", causal=causal,
                           layout=layout, mesh=mesh)
        (o * _t(_shard(g, 1, ax))).sum().backward()
        out[key] = (_np(o), _np(q.grad), _np(k.grad), _np(v.grad))
    out["collectives"] = _collectives(mesh, ax, coll)
    return out


def _collectives(mesh, ax, coll):
    """Each collective's value and its input's gradient under the loss
    sum(f(x) * g), on this rank's blocks of ``coll``'s arrays."""
    res = {}
    x = _t(coll["x"][ax.index], True)          # (8, 6) this rank's
    g_rep = _t(coll["g_rep"])                  # replicated cotangent
    g = _t(coll["g"][ax.index])

    def run(name, fn, cot):
        xx = x.detach().clone().requires_grad_(True)
        y = fn(xx)
        (y * cot).sum().backward()
        res[name] = (_np(y), _np(xx.grad))

    run("psum", lambda t: C.psum(t, "sp", mesh=mesh), g_rep)
    run("ppermute", lambda t: C.ppermute(
        t, "sp", [(0, 2), (2, 1), (1, 3)], mesh=mesh), g)
    run("all_to_all", lambda t: C.all_to_all(t, "sp", 0, 1, mesh=mesh),
        _t(coll["g_a2a"][ax.index]))
    run("psum_scatter", lambda t: C.psum_scatter(t, "sp", 0, mesh=mesh),
        _t(coll["g_ps"][ax.index]))
    # pvary: a replicated value times a sharded one.
    w = _t(coll["w"], True)
    (C.pvary(w, "sp", mesh=mesh) * x.detach() * g).sum().backward()
    res["pvary"] = _np(w.grad)
    # The naive all-reduce's backward all-reduces the replicated
    # cotangent once more: the gradient comes out n times too large.
    import torch.distributed.nn.functional as dnn
    xx = x.detach().clone().requires_grad_(True)
    (dnn.all_reduce(xx, group=ax.group) * g_rep).sum().backward()
    res["naive_psum_grad"] = _np(xx.grad)
    return res


# ------------------------------------------------------- Ulysses, 2 ranks


def ulysses_worker(rank, q, k, v, g, x):
    from horovod_tpu_torch.ops.flash_attention import flash_attention_auto
    from horovod_tpu_torch.parallel.ulysses import (
        heads_to_seq, seq_to_heads, ulysses_attention)
    mesh = _mesh((2,), ("sp",))
    ax = mesh.axis("sp")
    xs = _t(_shard(x, 1, ax))
    out = {"seq_to_heads": _np(seq_to_heads(xs, axis_name="sp",
                                            mesh=mesh))}
    h = seq_to_heads(xs, axis_name="sp", mesh=mesh)
    out["round_trip"] = _np(heads_to_seq(h, axis_name="sp", mesh=mesh))
    for name, fn in (("full", None), ("flash", flash_attention_auto)):
        for causal in (True, False):
            qs, ks, vs = (_t(_shard(a, 1, ax), True) for a in (q, k, v))
            o = ulysses_attention(qs, ks, vs, axis_name="sp", causal=causal,
                                  attn_fn=fn, mesh=mesh)
            (o * _t(_shard(g, 1, ax))).sum().backward()
            out[(name, causal)] = (_np(o), _np(qs.grad), _np(ks.grad),
                                   _np(vs.grad))
    return out


# ------------------------------------------- tensor parallel, dp 2 x tp 2


def _tp_layer(kind, mesh, dim_in):
    from horovod_tpu_torch.parallel import tensor_parallel as tp
    kw = dict(dtype=torch.float32, mesh=mesh, device="cpu")
    if kind == "col":
        return tp.ColumnParallelDense(dim_in, 16, "tp", **kw)
    if kind in ("row", "row_scatter"):
        return tp.RowParallelDense(dim_in // 2, 5, "tp",
                                   scatter_output=kind == "row_scatter",
                                   **kw)
    if kind == "mlp":
        return tp.TPMlp(dim_in, 8, 8, "tp", **kw)
    return tp.TPSelfAttention(dim_in, 4, "tp", **kw)


def tp_worker(rank, cases, mrs):
    from horovod_tpu_torch.parallel import tensor_parallel as tp
    mesh = _mesh((2, 2), ("dp", "tp"))
    dp, tpx = mesh.axis("dp"), mesh.axis("tp")
    out = {"coords": (mesh.coords, dp.index, tpx.index, dp.ranks,
                      tpx.ranks, mesh.axis(("tp", "dp")).index)}
    for kind, (params, x) in cases.items():
        layer = _tp_layer(kind, mesh, x.shape[-1])
        # A lone Column/Row layer's tree has no parent name to classify
        # it by: give it one.
        wrap = {"col": "col", "row": "row", "row_scatter": "row"}.get(kind)
        tree = weights.tp_shard_tree({wrap: params} if wrap else params,
                                     tpx.index, 2)
        weights.load_flax_params(layer, tree[wrap] if wrap else tree)
        xs = _shard(x, 0, dp)
        if kind.startswith("row"):
            xs = _shard(xs, xs.ndim - 1, tpx)
        xs = _t(xs)

        def loss_fn(m, kind=kind, xs=xs):
            y = m(xs)
            out[(kind, "y")] = _np(y)
            loss = (y ** 2).mean()
            if kind in ("col", "row_scatter"):
                # The value varies over tp: its psum is the replicated
                # loss.
                loss = C.psum(loss, "tp", mesh=mesh)
            return loss

        loss, grads = tp.tp_value_and_grad(loss_fn, layer, ("dp",),
                                           mesh=mesh)
        out[(kind, "loss")] = float(loss)
        out[(kind, "grads")] = {n: _np(g) for n, g in grads.items()}
        if kind == "row":
            out["row_naive"] = _naive_row(layer, xs, mesh)
    # matmul_reducescatter against psum_scatter of the full product.
    xk, kern = (np.asarray(a) for a in mrs)
    xs = _t(_shard(_shard(xk, 0, dp), 2, tpx))
    ks = _t(_shard(kern, 0, tpx))
    out["mrs"] = _np(tp.matmul_reducescatter(xs, ks, "tp", mesh=mesh))
    out["mrs_psum"] = _np(C.psum_scatter(xs @ ks, "tp", 1, mesh=mesh))
    return out


def _naive_row(layer, xs, mesh):
    """The row layer's kernel gradient with
    ``torch.distributed.nn.functional.all_reduce`` in place of
    ``collectives.psum``, reduced over dp as ``tp_value_and_grad`` does."""
    import torch.distributed.nn.functional as dnn
    y = dnn.all_reduce(xs @ layer.kernel, group=mesh.axis("tp").group)
    loss = ((y + layer.bias) ** 2).mean() / 2
    (g,) = torch.autograd.grad(loss, [layer.kernel])
    torch.distributed.all_reduce(g, group=mesh.axis("dp").group)
    return _np(g)


# ------------------------------------------------------ pipeline, 4 ranks


def pipeline_worker(rank, stages, ends, x, tgt, cfg, M):
    from horovod_tpu_torch.models import BlockStack
    from horovod_tpu_torch.parallel.pipeline import (
        microbatch, pipeline_apply, stage_params_init, unmicrobatch)
    mesh = _mesh((4,), ("pp",))
    ax = mesh.axis("pp")
    seeds = []
    stage = stage_params_init(
        lambda s: seeds.append(s) or BlockStack(
            cfg["dim"], cfg["heads"], cfg["depth"], attn=cfg["attn"],
            dtype=torch.float32, device="cpu", seed=s), 7, axis="pp",
        mesh=mesh)
    out = {"seed": seeds[0]}
    weights.load_flax_stage_params(stage, stages, ax.index)
    xt = _t(x, True)
    w = _t(ends, True)
    h = xt @ w                                     # a replicated input
    y = unmicrobatch(pipeline_apply(lambda m, a: m(a), stage,
                                    microbatch(h, M), mesh=mesh))
    loss = ((y - _t(tgt)) ** 2).mean()
    loss.backward()
    out["y"] = _np(y)
    out["loss"] = float(loss)
    out["grads"] = {n: _np(p.grad) for n, p in stage.named_parameters()}
    out["x_grad"] = _np(xt.grad)
    out["w_grad"] = _np(w.grad)
    with torch.no_grad():
        out["y_no_grad"] = _np(unmicrobatch(pipeline_apply(
            lambda m, a: m(a), stage, microbatch(h, M), mesh=mesh)))
    return out


# ----------------------------------------------------------- MoE, 4 ranks


def moe_worker(rank, cases):
    from horovod_tpu_torch.parallel.moe import MoELayer
    mesh = _mesh((4,), ("ep",))
    ax = mesh.axis("ep")
    out = {}
    for key, (params, x, g, kw) in cases.items():
        layer = MoELayer(x.shape[-1], params["w1"].shape[-1], axis="ep",
                         dtype=torch.float32, mesh=mesh, device="cpu", **kw)
        weights.load_flax_expert_params(layer, params, ax.index)
        xs = _t(_shard(x, 0, ax), True)
        y, aux = layer(xs)
        ((y * _t(_shard(g, 0, ax))).sum() + aux).backward()
        out[key] = {"y": _np(y), "aux": float(aux),
                    "balance": float(layer.aux_load_balance),
                    "z": float(layer.aux_router_z),
                    "dropped": float(layer.dropped),
                    "capacity": layer.capacity(xs.shape[0]),
                    "x_grad": _np(xs.grad),
                    "grads": {n: _np(p.grad)
                              for n, p in layer.named_parameters()}}
    return out


# ---------------------------------------------------- TransformerLM, 4 ranks


def _lm_loss(model, tokens, labels):
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1))


def transformer_worker(rank, sp, dpsp, tpc):
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.parallel import tensor_parallel as tp
    from horovod_tpu_torch.spmd import make_train_step, shard_batch
    out = {}
    # The four sequence-parallel modes on sp 4: loss and the gradients
    # averaged over the ranks (make_train_step's reduction).
    mesh = _mesh((4,), ("sp",))
    for attn, (cfg, params, tokens, labels) in sp.items():
        model = TransformerLM(**cfg, attn=attn, dtype=torch.float32,
                              sp_axis="sp", mesh=mesh, device="cpu")
        weights.load_flax_params(model, params)
        toks, labs = shard_batch(
            (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()),
            (None, "sp"), mesh=mesh)
        loss = _lm_loss(model, toks, labs)
        loss.backward()
        grads = {}
        for n, p in model.named_parameters():
            g = p.grad.clone()
            torch.distributed.all_reduce(g)
            grads[n] = _np(g / 4)
        mean = loss.detach().clone()
        torch.distributed.all_reduce(mean)
        out[("sp", attn)] = (float(mean) / 4, grads)
    # dp 2 x sp 2 with ring attention through make_train_step and Adam.
    cfg, params, steps = dpsp
    mesh = _mesh((2, 2), ("dp", "sp"))
    model = TransformerLM(**cfg, attn="ring", dtype=torch.float32,
                          sp_axis="sp", mesh=mesh, device="cpu")
    weights.load_flax_params(model, params)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(
        model, lambda m, b: _lm_loss(m, *b), opt)
    losses = []
    for tokens, labels in steps:
        batch = shard_batch((torch.from_numpy(tokens).long(),
                             torch.from_numpy(labels).long()),
                            ("dp", "sp"), mesh=mesh)
        losses.append(float(step(batch)))
    out["dpsp"] = (losses, {n: _np(p) for n, p in
                            model.named_parameters()})
    # dp 2 x tp 2: TransformerLM(tp_axis) through tp_value_and_grad.
    cfg, params, tokens, labels = tpc
    mesh = _mesh((2, 2), ("dp", "tp"))
    tpx = mesh.axis("tp")
    model = TransformerLM(**cfg, attn="full", tp_axis="tp",
                          dtype=torch.float32, mesh=mesh, device="cpu")
    weights.load_flax_tp_params(model, params, tpx.index, tpx.size)
    toks, labs = shard_batch((torch.from_numpy(tokens).long(),
                              torch.from_numpy(labels).long()),
                             ("dp",), mesh=mesh)
    loss, grads = tp.tp_value_and_grad(
        lambda m: _lm_loss(m, toks, labs), model, ("dp",), mesh=mesh)
    out["tp"] = (float(loss), {n: _np(g) for n, g in grads.items()})
    return out
