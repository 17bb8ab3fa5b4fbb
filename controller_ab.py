"""Does the eager plane's controller thread move a training step?  The
full-width ResNet-50 step of ``chip_smoke.py`` (batch 128, 224 x 224,
bf16) profiled with no controller thread and with the thread ticking
every ``HOROVOD_TPU_CYCLE_TIME_MS`` (1 ms by default), in alternating
order, each under a fresh ``hvd.init()``, then five unprofiled steps
timed on the host clock in each mode.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 controller_ab.py

A job of one process starts its controller thread at its first eager
collective (``core.Controller.start``), so "no thread" is a fresh init
and "ticking" is a fresh init plus one 4-byte ``hvd.allreduce``.  Prints
each profiled step's wall and kernel time and busy share, the median of
each mode, and the card's name and power limit.
"""

import statistics
import time

import torch

import chip_smoke as c

MODES = ("none", "ticking", "ticking", "none", "none", "ticking",
         "ticking", "none")
TIMED = 5


def _enter(hvd, mode: str) -> None:
    hvd.init()
    if mode == "ticking":
        hvd.allreduce(torch.ones(1, device="cuda"), name="ab.start")
    running = hvd.controller()._thread is not None
    c._check(running == (mode == "ticking"),
             f"{mode}: controller thread running {running}")


def main() -> None:
    if not torch.cuda.is_available():
        c._fail("torch.cuda.is_available() is false: this needs a CUDA GPU")
    print(c._gpu_line())
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.spmd import make_train_step
    hvd.init()
    model = ResNet50(num_classes=1000, seed=c.SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 4)
    images = torch.randn(c.RESNET_BATCH, c.RESNET_SIZE, c.RESNET_SIZE, 3,
                         generator=gen, device="cuda", dtype=torch.bfloat16)
    labels = torch.zeros(c.RESNET_BATCH, dtype=torch.long, device="cuda")
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, c._resnet_loss, opt, sync_aux_state=True)
    for _ in range(3):
        step((images, labels))
    torch.cuda.synchronize()
    hvd.shutdown()
    busy = {"none": [], "ticking": []}
    walls = {"none": [], "ticking": []}
    for mode in MODES:
        _enter(hvd, mode)
        print(f"=== controller thread: {mode}")
        wall_ms, kernel_ms = c._profile_step(step, (images, labels),
                                             c._resnet_category)
        busy[mode].append(kernel_ms / wall_ms)
        hvd.shutdown()
    for mode in MODES[:2]:
        _enter(hvd, mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            step((images, labels))
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3 / TIMED)
        hvd.shutdown()
    for mode in MODES[:2]:
        print(f"controller thread {mode}: profiled busy shares "
              + ", ".join(f"{b:.3f}" for b in busy[mode])
              + f" (median {statistics.median(busy[mode]):.3f}); "
              f"{walls[mode][0]:.2f} ms a step over {TIMED} steps "
              "unprofiled")


if __name__ == "__main__":
    main()
