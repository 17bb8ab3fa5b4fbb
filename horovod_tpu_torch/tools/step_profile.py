"""Profile the headline train step (or ResNet-50's) on the card and
aggregate its device work by kernel, the port's twin of
``tools/step_profile.py``.

The transformer leg is ``bench.py``'s TransformerLM at its widths (d 2048,
12 layers, 16 heads, vocab 32768, seq 2048, batch 8, bf16), under the
same knobs: ``BENCH_TLM_ATTN`` (default ``flash``), ``BENCH_TLM_LN_DTYPE``
(``bf16`` or ``f32``) and ``BENCH_TLM_FUSED_XENT`` (``1``, the default:
``ops.losses.fused_softmax_xent`` on the head kernel).  It trains with SGD,
momentum 0.9, through ``spmd.make_train_step(sync_aux_state=False)``.
The argument ``resnet`` profiles the ResNet-50 leg instead: batch 128 of
224², bf16, ``sync_aux_state=True``.  Parameters are filled as
``bench.synth_variables`` fills them (:func:`synth_parameters`).

After 2 warm-up steps, 2 steps are captured with ``profiling.capture``.
The header line gives the device span a step (``device_time_ms(per=2)``)
and the kernel time a step; the rows are the kernels and copies grouped by
``profiling.kernel_stem``, the top 40 by time, each with its time and
launch count a step.  Only device events count: the annotation ranges
(``nccl:*``, ``Optimizer.step``) span kernels and are never rows.

Usage:  python -m horovod_tpu_torch.tools.step_profile [resnet]
"""

import os
import shutil
import sys
import tempfile

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import profiling
from horovod_tpu_torch.ops import _cuda
from horovod_tpu_torch.spmd import make_train_step
from horovod_tpu_torch.tools import require_device

STEPS = 2     # captured steps; the rows are per step


@torch.no_grad()
def synth_parameters(model: torch.nn.Module, seed: int) -> None:
    """``bench.synth_variables``' rule over the model's parameters and
    buffers (the flax names): ones for ``scale`` and ``var``, zeros for
    ``bias`` and ``mean`` and every non-float tensor, N(0, 0.02) for every
    other float (weights), from ``seed``."""
    tensors = list(model.named_parameters()) + list(model.named_buffers())
    gen = None
    for name, t in tensors:
        path = name.lower()
        if not t.is_floating_point():
            t.zero_()
        elif "scale" in path or "var" in path:
            t.fill_(1.0)
        elif "bias" in path or "mean" in path:
            t.zero_()
        else:
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                dtype=torch.float32) * 0.02)


def aggregate(log_dir: str, steps: int = STEPS):
    """(rows, kernel ms, span ms) a step of a captured trace: rows
    ``profiling.kernel_table(per=steps)``, the kernel time their sum, the
    span ``device_time_ms(per=steps)`` (None without device events)."""
    rows = profiling.kernel_table(log_dir, per=steps)
    return (rows, sum(ms for _, ms, _ in rows),
            profiling.device_time_ms(log_dir, per=steps))


def profile_and_dump(run, label: str, topn: int = 40) -> dict:
    """Two warm-up calls of ``run``, then ``STEPS`` captured ones; print
    the header and the top rows.  Returns the step span, the kernel time
    and the rows (a step each) and the port's kernel launches a step."""
    run()
    run()
    _cuda.reset_launches()
    log_dir = profiling.capture(run, warmup=0, iters=STEPS,
                                log_dir=tempfile.mkdtemp(prefix="stepprof"))
    launches = {n: c / STEPS for n, c in _cuda.LAUNCHES.items() if c}
    rows, total, span = aggregate(log_dir)
    shutil.rmtree(log_dir, ignore_errors=True)
    step = f"{span:.2f} ms" if span is not None else "not measured"
    print(f"== {label}: step {step}, kernels total {total:.2f} ms ==")
    for n, d, c in rows[:topn]:
        print(f"{d:9.3f} ms  x{c:4g}  {n[:100]}", flush=True)
    if not rows:
        print("-- no device events (no CUDA activity was traced) --")
    return {"label": label, "step_ms": span, "kernel_ms": total,
            "rows": rows, "launches": launches}


def transformer(device) -> dict:
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    dim, depth, heads, vocab, seq, bpc = 2048, 12, 16, 32768, 2048, 8
    attn = os.environ.get("BENCH_TLM_ATTN", "flash")
    ln_dtype = (torch.float32
                if os.environ.get("BENCH_TLM_LN_DTYPE", "bf16") == "f32"
                else torch.bfloat16)
    model = TransformerLM(vocab=vocab, dim=dim, depth=depth,
                          num_heads=heads, max_len=seq, attn=attn,
                          dtype=torch.bfloat16, head_dtype=torch.bfloat16,
                          ln_dtype=ln_dtype, device=device)
    synth_parameters(model, seed=1)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, vocab, (bpc, seq + 1), generator=gen,
                           device=device)
    fused_head = os.environ.get("BENCH_TLM_FUSED_XENT", "1") == "1"

    def loss_fn(model, batch):
        if fused_head:
            h = model(batch[:, :-1], return_hidden=True)
            return fused_softmax_xent(h.reshape(-1, dim), model.head.kernel,
                                      batch[:, 1:].reshape(-1)).mean()
        logits = model(batch[:, :-1])
        return F.cross_entropy(logits.float().reshape(-1, vocab),
                               batch[:, 1:].reshape(-1))

    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt, sync_aux_state=False)
    losses = []
    out = profile_and_dump(lambda: losses.append(float(step(tokens))),
                           f"transformer step attn={attn}")
    return dict(out, losses=losses)


def resnet(device) -> dict:
    from horovod_tpu_torch.models import ResNet50
    bpc, size = 128, 224
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device=device)
    synth_parameters(model, seed=42)
    gen = torch.Generator(device=device).manual_seed(42)
    images = torch.randn((bpc, size, size, 3), generator=gen, device=device,
                         dtype=torch.float32).to(torch.bfloat16)
    labels = torch.zeros((bpc,), dtype=torch.int64, device=device)

    def loss_fn(model, batch):
        imgs, lbls = batch
        return F.cross_entropy(model(imgs).float(), lbls)

    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt, sync_aux_state=True,
                           steps_per_call=1)
    losses = []
    out = profile_and_dump(
        lambda: losses.append(float(step((images, labels)))),
        f"resnet50 step bpc={bpc}")
    return dict(out, losses=losses)


def main(argv=None, device: str = "cuda") -> dict:
    """Profile the leg ``argv`` names (``resnet``, else the transformer);
    returns its results, the losses of every step included."""
    args = sys.argv[1:] if argv is None else argv
    dev = require_device(device)
    hvd.init(device=device)
    return resnet(dev) if "resnet" in args else transformer(dev)


if __name__ == "__main__":
    main()
