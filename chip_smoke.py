"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without a CUDA device or outside
the checkout.  Phases, in order; any failure ends the run:

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``horovod_tpu_torch/csrc`` (timed), with ptxas'
   registers and spills for each kernel of the ``kernels`` line and for
   each of the 24 instantiations of G1-G3 and 21 of W1-W3 (none may
   spill).
2. Kernels: each Hopper flash kernel (forward P1, dk/dv P2, dq P3) at the
   training shape (B 8, H 16, T 2048, D 128, bf16, causal, q/k/v read
   from one (B, T, 3C) projection) and on four small cases (non-causal
   T 512; a ragged ``seq_len`` at D 64; D 80, which the kernels pad to 128
   columns; T 192 with ``seq_len`` 130, a ragged edge inside a 128-row
   tile and across a 64-row one), held against its plain PyTorch version
   on the same inputs; P1, P2 and P3 launched twice on the training shape
   must give bit-identical results.  Then timed (CUDA events around 10
   launches, median of 20 such batches) beside its plain version, its
   bound at the H100 SXM peaks and ``scaled_dot_product_attention`` as a
   yardstick.  One line ``{"kernels": [...]}`` carries the numbers.
3. One-pass backward: P6 (``flash_bwd_fused``) on the same five cases,
   held against its plain version and against P2 + P3 on the same inputs,
   then timed at the training shape beside its plain version and the
   ``scaled_dot_product_attention`` backward.
4. General family: G1-G3 (``flash_general.cu``, the inputs P1-P3 do not
   take) against the plain versions in f32 at the training shape and on
   the small cases, at D 1, 8, 12, 13, 129 (two dk/dv column halves),
   200 and 256, T 1 and seq_len 1, in fp16 at D 12 and 64 and in bf16 at
   D 8, 13 and 256 (each staging copy width: 16 bytes, 4, one element),
   with TF32 off so that the f32 reference is full f32; G1-G3 launched
   twice on the training shape must give the same bits; timed at the
   training shape in f32 beside the plain versions, both bounds (FFMA,
   and the three TF32 products G1-G3 run) and f32
   ``scaled_dot_product_attention``, whose kernels are named from the
   profiler (G2 + G3 beside its backward).  Then the wide route W1-W3
   (``flash_wide.cu``, head sizes above 256) against the plain versions
   in f32 at D 264, 384 and 1000 (B 1, H 2, T 512, causal; 1e-5), at
   ``WIDE_MAX_D`` (T 16), at ``WIDE_FULL_CASE`` (B 4, H 8, T 2048, D
   384) and in bf16 at D 320 with a ragged seq_len; W1-W3 launched twice
   give the same bits; timed at D 384 at both ``WIDE_CASE`` and
   ``WIDE_FULL_CASE`` beside f32 ``scaled_dot_product_attention``, whose
   kernels (the backend PyTorch picked) are named, with W1-W3's products
   against the least and the registers and spills of each of their 21
   instantiations.
5. f32 models: the reference's own checks
   (``tests/test_flash_attention.py``): ``TransformerLM(dim=256,
   num_heads=2, attn="flash", dtype=float32)`` (D 128 through
   ``flash_qkv_proj``), dim 32 with 4 heads (D 8 through
   ``flash_attention_auto``) and dim 768 with 2 heads (D 384) against
   ``attn="full"`` on the card, logits within 1e-4; G1-G3 run (W1-W3 at
   D 384), P1-P3 do not (counters zeroed just before).
6. Reference: a small bf16 TransformerLM step through the kernels against
   the same model on the oracle attention, same parameters, on the
   card.
7. Train: the full-width TransformerLM (d 2048, 16 heads, vocab 32768,
   seq 2048, batch 8, bf16) through ``make_train_step`` with the fused
   cross-entropy and SGD with momentum, 2 warm-up and 5 timed steps.  The
   kernels' launch counters are zeroed just before and read just after;
   each flash kernel must equal depth x steps.  Losses must be finite and
   fall.  One more step runs under torch.profiler for the device time by
   kernel.
8. Train, one-pass: phase 7 again (model rebuilt from the same seed) under
   ``HOROVOD_TPU_FLASH_BWD=fullunroll``: P6 must launch depth x steps times
   and P2/P3 never; the first loss equals phase 7's bit for bit (the
   forward is the same) and every loss stays within ``TOL_ONE_PASS`` of
   phase 7's.  The knob is unset afterwards.
9. Routing: ``flash_attention(bwd_impl="pallas_fused")`` at B 2, H 16,
   D 128 runs P6 at T 8192 (T * D * 4 bytes = 4 MiB, the JAX package's
   limit) and P2 + P3 at T 16384; at T 8192 its gradients agree with the
   split pair's, and ``bwd_impl="xla"`` (plain PyTorch, chunked) agrees
   with the split pair's at T 2048.
10. Codec: the int8 kernels (quantize P4, dequantize P5) against their
   plain versions on the card, bit for bit, on edge blocks (all zero, tiny,
   subnormal, near 1e38, randn * exp(U(-6, 6))), a 1025-element tail
   through ``snap_to_grid`` and the timing shape (n = 67,108,864, the
   ``head`` leaf); then timed beside their plain versions and their bound,
   and dequantize beside ``torch.mul(q, scales)`` as a yardstick.
11. Ring: the int8 ring of 4 ranks driven in lockstep on the card, 16,777,216
   elements each: bit-identical to the same ring on the plain codec and
   within 5% (relative Frobenius) of the f32 mean.
12. Train, int8: the model of phase 7 (freed and rebuilt from the same
   seed) through ``hvd.DistributedOptimizer(SGD momentum,
   Compression.int8, error_feedback=True)``, 2 warm-up and 5 timed steps,
   counters zeroed just before and read just after: each codec kernel
   launches once per int8-eligible leaf per step (51 leaves at depth 12),
   each flash kernel depth x steps.  Losses finite and falling, the first
   equal to phase 7's first to 1e-5 relative, every one within 1e-4.  One
   more step runs under torch.profiler.  Then one wrapper step of the
   ``head`` leaf is replayed from the trained state on the kernels and on
   the plain codec: bit-identical, the residual bit for bit ``g - Q(g)``,
   momentum and parameter within a bf16 step of the step written out.
13. NCCL ring: two processes, one card each, only with two or more cards;
   otherwise a line says it did not run.
14. ResNet steps_per_call: a small ResNet (stages [1, 1], 8 filters, bf16)
   on the card, one call with ``steps_per_call=3`` against three
   single-step calls on the same batches: the call's loss equals the
   mean of theirs within 1e-5 relative.
15. ResNet-50 against the CPU: the full-width model with the last
   BatchNorm scale of every block drawn from U(0.05, 0.15) (zero at init,
   which leaves the blocks' convolutions without a gradient), one
   train-mode forward and backward of 4 random 224 x 224 images with
   random labels on the card and on the CPU from the same state: in f32
   (TF32 off) the loss and logits within 1e-4 relative, all gradients
   together within 1e-2, every gradient and buffer within 5e-2; in bf16
   the loss and the logits within 2e-2.  The CPU pass on inputs moved by
   1e-6 prints how far the problem amplifies such a change (the floor the
   limits sit a few times above).
16. ResNet-50 (the bench's judged leg, ``bench.py:150-256``):
   ``ResNet50(num_classes=1000)`` in bf16, batch 128 of 224 x 224 NHWC
   images from a seeded generator, zero labels, SGD lr 0.01 momentum 0.9
   through ``make_train_step(sync_aux_state=True)``.  After its first
   step ``bn_init``'s running mean must equal 0.1 x the f32 batch mean of
   ``conv_init``'s output computed directly, and its running var 0.9 +
   0.1 x the biased variance (1e-3 relative).  Then 1 warm-up call and 3
   timed calls with ``steps_per_call=5``: images/s per GPU, ms per step,
   MFU by ``bench.py:270-281``'s formula (3 x 4.1e9 x images / 989
   TFLOP/s; 4.1e9 counts multiply-accumulates), peak memory, clocks.
   Losses finite and falling, no port kernel launched (the leg runs
   cuDNN convolutions and PyTorch elementwise ops, as the JAX package
   runs XLA's), an eval step's logits finite; one profiled step by
   category (convolution, BatchNorm and elementwise, other).
17. Hierarchical NCCL: four processes, one card each, on two fake hosts
   (``HOROVOD_TPU_HOST_FINGERPRINT`` A, A, B, B), only with four or more
   cards; otherwise a line says it did not run.  The two-tier allreduce
   of integer-valued f32 equals the flat ``all_reduce`` bit for bit;
   ``reduce_gradients(compression="int8", mesh=)`` launches P4 and P5,
   equals the plain codec's snap reduced over the mesh bit for bit and
   the flat sum of that snap within 1e-2; two small-ResNet steps on
   ``hierarchical_mesh()`` match the flat steps within 1e-5 relative.
18. Eager plane, one card: ``hvd.allreduce`` (sum and average),
   ``allgather`` and ``broadcast`` of CUDA f32, bf16 and int64 tensors,
   async with ``poll`` and ``synchronize``, equal to what one rank gives;
   the latency of one 4 KiB allreduce; a burst of 64 async 1 MiB f32
   allreduces three times, fused into 64 MiB responses and served from
   the response cache from the second burst on (``hvd.metrics()``), timed
   beside one ``dist.all_reduce`` of the same 64 MiB on a one-rank NCCL
   group.  The controller's background thread ticks beside every phase
   above (``hvd.init()`` starts it).
19. Eager plane, NCCL: four processes, one card each, launched without
   ``HOROVOD_TPU_LOCAL_RANK``, only with four or more cards; otherwise a
   line says it did not run.  Host discovery must give four distinct
   GPUs; each fused eager allreduce (f32, bf16, int64) equals
   ``dist.all_reduce`` of the same fused buffer bit for bit; the integer
   average floor-divides; a ragged allgather and a broadcast are exact; a
   dtype mismatch raises the coordinator's error on every rank; then the
   phase-18 latency and burst on four cards.
20. Train, eager: phase 7's model (rebuilt from the same seed) through a
   plain loop with ``hvd.DistributedOptimizer(SGD momentum, eager=True)``
   fed by ``hvd.ShardedLoader`` (host tokens copied on its side stream),
   three times: overlap off, overlap on, and int8 with error feedback
   under overlap; 2 warm-up and 5 timed steps each, counters zeroed just
   before and read just after: each flash kernel launches depth x steps
   times, P4/P5 51 times a step under int8 (none otherwise).  The losses
   equal phase 7's (phase 12's for int8) bit for bit or within
   ``TOL_EAGER`` (int8: phase 12's tolerances against phase 7).  Printed:
   step ms and tokens/s beside phase 7's, peak memory, eager responses,
   cache hits and buckets a step, the ``overlap.*`` series, one profiled
   step; ``hvd.observe()`` must show the steps.
21. Train, eager, NCCL: four processes, one card each, only with four or
   more cards; otherwise a line says it did not run.  Each rank trains
   the full-width model on its own seeded batch for 2 + 3 steps through
   ``make_train_step``, ``eager=True`` and ``eager=True`` with overlap:
   losses within 1e-5 relative of ``make_train_step``'s.  Integer-valued
   f32 gradients of the model's leaf shapes through the eager branch
   (overlap off and on) equal ``dist.all_reduce`` bit for bit, and a
   sparse ``nn.Embedding(32768, 2048)`` gradient with ragged rows per
   rank equals the dense mean.
22. Parallel, one card (phases 22-26 run right after phase 4, while this
   process holds little on card 0, which rank 0 of the four-card group
   shares): on a world of one at small widths (d 256, 2 heads, D 128, 2
   layers, T 256) in f32 with TF32 off, ``ring``, ``ring_zigzag`` and
   ``ulysses`` give ``attn="full"``'s loss and gradients and
   ``ulysses_flash`` ``attn="flash"``'s (1e-5 relative);
   ``ulysses_flash`` in bf16 launches P1-P3 once a layer.  Then P1-P3
   against their plain versions at every shape the four-card phases give
   them: a pipeline stage's (B 1, H 16, T 2048), ``ulysses_flash``'s at
   batch 1 (B 1, H 4, T 8192) and at batch 8 (B 8, H 4, T 8192, D 128),
   the last timed beside their bound and
   ``scaled_dot_product_attention``.
23. Sequence parallel, NCCL: four processes, one card each, only with
   four or more cards (phases 23-26 share one group; otherwise a line
   says each did not run).  ``TransformerLM(attn="ulysses_flash")`` at
   the headline widths over an ``("sp",)`` mesh: global seq 8192, 2048
   a card, batch 8, 2 warm-up and 5 timed steps through
   ``make_train_step``: step ms, tokens/s/GPU, MFU by ``bench.py:425-427``
   with seq the global 8192, peak memory, one profiled step on rank 0.
   P1, P2 and P3 each launch depth x steps times; the first loss is
   within ``TOL_SP_FIRST`` of one card's ``attn="flash"`` forward over
   all 8192 tokens with the same weights.  Then ``ulysses_flash``,
   ``ring``, ``ring_zigzag`` (tokens permuted by ``zigzag_indices``) and
   ``ulysses`` at batch 1, 3 steps each: losses within ``TOL_SP_MODES``
   of each other, and each mode's first update within ``UPDATE_FLOORS``
   times the problem's own floor of a one-card ``attn="flash"`` twin's.
24. Tensor parallel, NCCL: (dp 2, tp 2), ``TransformerLM(tp_axis="tp")``
   at the headline widths, T 2048, batch 2 a dp shard, SGD momentum
   through ``tp_value_and_grad``, weights carried from the one-card
   ``attn="full"`` twin (``weights.dense_to_tp_state``): the first loss
   within ``TOL_TP_LOSS`` of the twin's on the whole batch, the first
   update over the gathered slices within ``UPDATE_FLOORS`` times the
   problem's own floor (the twin's bf16 update against its f32 one,
   printed beside); then ``matmul_reducescatter`` against
   ``psum_scatter`` at the MLP's row shape (``TOL_MRS``), timed.
25. Pipeline, NCCL: 4 stages of ``BlockStack(depth 3, attn="flash")``,
   8 microbatches of 1 x 2048, embeddings and head replicated: P1
   launches 3 x (8 + 4 - 1) = 33 times a forward on every rank (and P1-P3
   99 times in 3 steps); the first loss within ``TOL_PP_FIRST`` of the
   12-block model's one-card forward with the same weights, each rank's
   first update (the ends and its stage) within ``UPDATE_FLOORS`` times
   the floor of that model's; losses and step ms.
26. Experts, NCCL: ``MoELayer`` (E 4, d 2048, hidden 8192, top-2,
   capacity factor 1.25, 4,096 tokens a card, bf16): output, aux
   components and gradients (tokens, experts, router) within ``TOL_MOE``
   of the same function written out on rank 0 with every expert gathered
   (routing by ``torch.topk``, the capacity rule written out), whose
   capacity and dropped shares must equal the layer's; dropped share and
   forward + backward ms.

27. Checkpoint and resume (one card; phases 27-28 run right after phase
   26, while this process holds little on card 0): the headline model
   (phase 7's, SGD momentum 0.9 through ``hvd.DistributedOptimizer``)
   trains 3 steps, ``hvd.save_model`` commits epoch 3 as a chain base
   (spec included), 2 more steps give run A; a fresh model with zeroed
   parameters and ``hvd.load_model`` from the directory alone (optimizer
   rebuilt from its spec) train the same 2 batches (run B): losses,
   parameters and momentum bit-identical.  Then
   ``AsyncCheckpointer(snapshot_every_steps=1, full_every=2)`` over 4
   steps: each committed epoch's leaves against fingerprints of the live
   state taken right after its snapshot (before the next in-place step),
   and the restored tip against the live state, bit for bit.  Printed:
   the state's bytes, save and load seconds, each snapshot's
   device->host ms, each commit's epoch, kind, bytes and seconds,
   restore seconds, step ms with the stream on and off, peak host RSS,
   free disk.  The directory is removed at the end.
28. Elastic, NCCL: ``python -m horovod_tpu_torch.run -np 3 --elastic
   --num-standby 1 --snapshot-every-steps 2 -- python3 chip_smoke.py
   --elastic-worker`` on four cards (only with four or more; otherwise a
   line says it did not run), ``HOROVOD_TPU_FAULT=rejoin:rank=0:tick=1``:
   each rank trains the headline model on its own batch through
   ``elastic.run_elastic`` and ``DistributedOptimizer(eager=True)``; rank
   2 kills itself with SIGKILL at step 5, the survivors shrink to 2
   (generation 1, the NCCL world group aborted and rebuilt), the standby
   parks and is admitted back to 3 (generation 2), and the job finishes
   its 10 steps.  No rank aborts; at every re-entry each rank's restored
   state equals the committed tip read from disk (fingerprints of every
   leaf); the final states are bit-identical across the ranks.  Printed:
   ``elastic.downtime_seconds``, ``elastic.resume_seconds``, the NCCL
   rebuild (``elastic.rebuild_seconds``), rank 0's step ms before and
   after.
29. InceptionV3 against the CPU (after phase 16): the full-width model
   with every BatchNorm scale drawn from U(0.05, 0.15) and 4 random 299 x
   299 images.  In train mode the whole model is chaotic at this batch
   (the CPU against itself on inputs moved by 1e-6 moves its f32
   gradients by 5e-2), so each of its 17 units (stem ConvBN with the
   pools, blocks, the head with the mean) runs one train-mode forward and
   backward on the CPU's own input to it under a seeded cotangent, on the
   card and on the CPU from the same state, at phase 15's limits: in f32
   (TF32 off) each output within 1e-4 relative, all gradients together
   within 1e-2, every gradient, input gradient and new buffer within
   5e-2; in bf16 each output within 2e-2; the floor from inputs moved by
   1e-6 printed.  The whole model's eval-mode logits (BatchNorm scales
   from U(0.5, 1.5)) within 1e-4 (f32) and 2e-2 (bf16); its train-mode
   loss and logits printed.
30. InceptionV3 and VGG16 training at full width (``ZOO``, after
   ``bench.py:159-210``): bf16, batch 32 of 299 x 299 and batch 64 of
   224 x 224, zero labels, SGD lr 0.01 momentum 0.9,
   ``make_train_step(steps_per_call=5)``, ``sync_aux_state`` for
   InceptionV3 only.  Every module's 4-D output stays in channels_last
   (forward hooks on the card); for InceptionV3 ``ConvBN_0``'s running
   mean and var after the first step against 0.1 x the f32 batch mean
   (and 0.9 + 0.1 x the biased variance) of its convolution's output,
   1e-3 relative; 1 warm-up and 3 timed calls; losses finite and
   falling, an eval step's logits finite, no port kernel launched.
   Printed: images/s per GPU, ms per step, MFU from ``FlopCounterMode``'s
   FLOPs of one step (2 a multiply-add, against 989 TFLOP/s; phase 16
   counts multiply-adds), peak memory, clocks, one profiled step by
   category and its layout-conversion kernels.  Between the two models,
   VGG16 against the CPU as in phase 29 on 2 images of 224 x 224
   (``fc1``'s flatten order at the real width).
31. CE schedules (after phase 8): phase 7's model, rebuilt from the same
   seed, 2 warm-up and 5 timed steps under ``HOROVOD_TPU_XENT_MODE=
   recompute`` and under ``save2``: every loss within ``TOL_XENT`` (1e-5)
   relative of phase 7's, P1, P2 and P3 each launched depth x steps
   times; step ms and peak memory beside phase 7's.  The knob is unset
   after each.
32. Profiler: ``profiling.capture`` of two headline steps after
   two warm-up and three event-timed ones: ``device_time_ms(per=2)``
   between the kernel time a step and 1.2 x the event-timed step, the
   span of both never above the capture's wall time; the top rows of
   ``per_op_rooflines``, whose cuBLAS rows report FLOPs.  Then
   ``python -m horovod_tpu_torch.examples.mnist --epochs 1`` on the card
   (test accuracy above 0.9) and ``synthetic_benchmark --num-iters 2
   --num-batches-per-iter 2`` (its throughput lines).  Every profiled
   step of the script reads its kernel rows through
   ``horovod_tpu_torch.profiling``.  Phases 29-32 print their seconds.
33. Precision autopilot, one card (after phase 32): phase 7's model,
   rebuilt from the same seed, through ``make_train_step(compression=
   "auto")`` under ``HOROVOD_TPU_PRECISION=auto`` and
   ``HOROVOD_TPU_PRECISION_TICKS=2``, counters zeroed just before.  After
   the first step the ladder is warmed as ``bench.py:_injit_auto_leg``
   does: 4 reports of each eligible f32 leaf's int8-grid residual of its
   gradient, measured by the port's ``optimizer._note_auto_residual``
   (one P4 and one P5 launch through ``snap_to_grid``, held against the
   plain codec on the same leaf, bit for bit, outside the counts).  Then
   6 more steps.  At world size 1 ``make_train_step`` reduces nothing,
   so this phase holds the ladder, the route and its rebuilds, not the
   reduction (phase 34 does): every leaf's rung equals that of a
   ``policy.FleetPolicy`` twin fed the plain codec's residuals, no leaf
   stands at bf16 for the timed steps, the losses equal phase 7's bit
   for bit (the route adds no work on one card), the step rebuilt its
   route twice and P1-P3 launched depth x steps.  Then one residual
   spike (0.9) demotes its leaf to fp32 on that report and the next call
   rebuilds.  Printed: buckets by wire, promotions, demotions, rebuilds,
   ``plan_version``, P4/P5 launches a measurement, step ms and peak
   memory beside phase 7's.
34. Precision autopilot, NCCL (runs right after phase 28): four
   processes, one card each, only with four or more cards (otherwise a
   line says it did not run), under
   ``HOROVOD_TPU_PRECISION=auto``.  Each rank trains the headline model on
   its own batch through ``make_train_step`` with the static fp32, bf16
   and int8 wires (error feedback off) and with ``"auto"``, 2 + 3 steps
   each: step ms, tokens/s per GPU, MFU (``bench.py:425-427``) and
   ``auto_vs_best_static`` (printed, not gated).  Before the auto leg a
   twin takes the same first step with each leaf reduced by the route its
   rung names (``quantized_ring_allreduce`` on the leaf alone; the raw
   leaves, and the bf16 casts, each rung's in one flat
   ``dist.all_reduce``, as the step packs them into one scheduler
   bucket), its reduced gradients warming the ladder first (measured by
   ``optimizer._note_auto_residual``); the auto leg's first update must
   equal the twin's bit for bit, its first loss the fp32 leg's, and
   every rank hold one plan.  The auto leg's P4/P5 launches are the
   kernels line's ``launches_auto``.  Then its reduction alone, timed on
   the last step's gradients: the per-leaf int8 rings, the same leaves
   through the static int8 leg's bucketed rings, and the fused rest.
   Then ``DistributedOptimizer(eager=True, overlap=True)`` raw and with
   ``compression="auto"``, 5 steps each: the residual reports ride the
   request frames, every rank sees the same ``wire_dtype`` on each
   response (counted by wire dtype), and, NCCL moving the buckets raw,
   the auto losses equal the raw ones bit for bit.
35. Straggler eviction, NCCL (phases 35-37 run right after phase 34,
   only with four or more cards; otherwise a line says each did not
   run): phase 28's job and worker (``CHIP_SMOKE_ELASTIC_MODE=evict``),
   ``-np 3 --num-standby 1 --elastic-min-ranks 3``, the fleet policy
   armed (``HOROVOD_TPU_EVICT_THRESHOLD=0.02``, ``EVICT_TICKS=5``,
   ``EVICT_MAX=1``).  Rank 0 commits epoch 0 before the first step, and
   the standby parks only ``FLEET_STEPS`` steps later; process 1 alone
   slows each of its ticks by ``EVICT_MS`` from tick
   ``EVICT_ONSET_TICK`` (``HOROVOD_TPU_FAULT`` set in that process
   only).  With the floor at the full world the policy waits for the
   parked standby, then demotes process 1, and only it: it prints the
   native eviction text and exits 3, and the launcher relaunches it as a
   standby; the parked
   standby is admitted in the same reconfigure (generation 1, 3 ranks,
   the NCCL group rebuilt), every re-entry restores the committed tip,
   the final states are bit-identical, ``policy.evictions`` is 1, and in
   each generation P1-P3 launch depth x its steps on every rank, each
   process in the NCCL seat of its rank and on its own card.  Printed:
   the onset tick, the tick of epoch 0's commit and of the demotion, the
   victim's EWMA, ``elastic.downtime_seconds``,
   ``elastic.rebuild_seconds``, rank 0's step ms before and after.
36. Scripted autoscaling, NCCL: the same job of four processes
   (``CHIP_SMOKE_ELASTIC_MODE=autoscale``) with
   ``HOROVOD_TPU_AUTOSCALE_FILE``, the file seam of ``--autoscale-script``
   (a script counts ticks, which the card's steps do not fix): rank 0
   writes 2 after ``AUTOSCALE_STEPS`` steps and a committed snapshot,
   processes 2 and 3 leave with the shrink's eviction text and are
   relaunched as standbys on the cards they freed; after as many steps
   at size 2, rank 0 writes 4 once both have parked, and the grow admits
   them.  Each generation of 4 or 2 trains its steps (P1-P3 depth x
   steps), every re-entry restores the committed tip, the final states
   are bit-identical and ``policy.rescales`` is at least 2.  Printed:
   the step and tick of each target and rescale, downtime and rebuild
   seconds, rank 0's step ms at size 4 and at size 2.
37. Hierarchical control topology, NCCL: four processes on fake hosts A,
   A, B, B (``HIER_HOSTS``) train the headline model from one seed, each
   on its own batch, ``TOPO_STEPS`` steps through
   ``DistributedOptimizer(eager=True, overlap=True)`` (one NCCL call a
   scheduler bucket: ``HOROVOD_TPU_FUSION_THRESHOLD=0``), once under
   ``HOROVOD_TPU_CONTROL_TOPO=flat`` and once under ``hier``: losses and
   every leaf of the final states bit-identical on every rank (if not, a
   second ``flat`` run, and ``hier`` held to the difference between the
   two), ``control.agg_depth`` 1.0 and 2.0, frames merged under ``hier``
   only, P1-P3 depth x steps.  Printed: step ms, the tick-seconds
   histogram's median bucket.
38. Process sets and the publish plane, NCCL (right after phase 37, four
   cards; otherwise a line says it did not run): two jobs of four
   processes through ``python -m horovod_tpu_torch.run``.  (a) Under
   ``HOROVOD_TPU_PROCESS_SETS="tenantA:0,1;tenantB:2,3"`` both tenants
   run, at once and under the same tensor names, allreduce (sum, average,
   an int32 average), a ragged allgather and a broadcast on CUDA tensors
   over their sets' NCCL groups: each result equals the reference's
   ``execute_host`` semantics computed in numpy from the same seeded
   contributions, bit for bit, and each process's
   ``control.set_requests#process_set=`` counts its own tenant only; then
   a 4 MiB set allreduce is timed.  (b) Publish while training, under
   ``"serve:2,3"``: the headline model trains ``PUBLISH_STEPS`` steps
   through ``make_train_step`` on the world group twice from one seed and
   the same batches; in the second leg rank 0 commits the parameters
   every ``PUBLISH_EVERY`` steps through ``ckpt_stream.AsyncCheckpointer``
   (each commit a base; a snapshot waits for the commit before it) and
   ranks 2 and 3 poll a ``ParameterPublisher(dir, "serve")`` between
   steps.  Every published state equals ``checkpoint.read_chain_state``
   of its epoch leaf by leaf, bit for bit (read after the leg); the legs'
   losses are bit-identical; P1-P3 launch depth x steps a leg on every
   rank.  Printed: publishes, bytes, mean publish latency and staleness,
   both legs' step ms and their difference, each rank's peak device
   memory and host RSS.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL_O = 2e-2                 # bf16 output max abs error
TOL_LSE = 1e-3               # f32 lse max abs error
TOL_GRAD = 1e-2              # relative Frobenius error of dq/dk/dv
SEED = 0

# Training shape of the headline leg (bench.py:332-356).
VOCAB, DIM, DEPTH, HEADS, SEQ, BATCH = 32768, 2048, 12, 16, 2048, 8
WARMUP, TIMED = 2, 5
FLASH = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
FUSED = "flash_bwd_fused"
CODEC_N = VOCAB * DIM              # the head leaf: 67,108,864 elements
RING_RANKS, RING_N = 4, 16_777_216
TOL_RING = 5e-2                    # ring vs f32 mean, relative Frobenius
TOL_FIRST_LOSS = 1e-5              # int8 phase vs plain phase, relative
# Every int8 loss against the plain phase's, relative: about 8x the
# 1.21e-5 measured on an H100 80GB HBM3 at 700 W (PERF.md, PR 2).
TOL_LOSS_TRACK = 1e-4
# Every loss of the one-pass phase against the split phase's, relative.
# P6 sums dq with atomics in another order than P3, and dk and dv in
# another order than P2, so the gradients differ in their last bits and
# the losses drift apart a little: about 7x the 1.51e-5 measured on an
# H100 80GB HBM3 at 700 W (PERF.md).
TOL_ONE_PASS = 1e-4
WIDE = ("flash_fwd_wide", "flash_bwd_dkdv_wide", "flash_bwd_dq_wide")
GENERAL = ("flash_fwd_general", "flash_bwd_dkdv_general",
           "flash_bwd_dq_general")
# The general family in f32 against the plain versions in f32 with TF32
# off: G1-G3 split each f32 operand into two TF32 halves (three products
# a term, the lo.lo term dropped); at the training shape 1.8e-6 (G2's dk)
# and 1.5e-6 (G3's dq) relative, at most 2.7e-6 over the phase's f32
# cases, measured on an H100 80GB HBM3 at 700 W (PERF.md), so 1e-5 leaves
# room.  lse reaches ~10, so 1e-4 absolute is the same margin.
TOL_F32 = 1e-5
TOL_F32_LSE = 1e-4
# f32 models against attn="full": the reference's own tolerance
# (tests/test_flash_attention.py:274-300, rtol = atol = 1e-4).
TOL_MODEL = 1e-4
# The ptxas entry of each kernel of the kernels line (the instantiation
# the training shape runs: D 128, or f32 at D 128 for the general family;
# W1-W3: f32 at WIDE_FULL_CASE, 192, 128 and 192 columns a warp).
PTXAS_NAMES = {
    "flash_fwd": "flash_fwd_kernelILi128E",
    "flash_bwd_dkdv": "flash_bwd_dkdv_kernelILi128E",
    "flash_bwd_dq": "flash_bwd_dq_kernelILi128E",
    "flash_bwd_fused": "flash_bwd_fused_kernelILi128E",
    "int8_quantize": "int8_quantize_kernel",
    "int8_dequantize": "int8_dequantize_kernel",
    "flash_fwd_general": "flash_fwd_general_kernelIfLi16EE",
    "flash_bwd_dkdv_general": "flash_bwd_dkdv_general_kernelIfLi16EE",
    "flash_bwd_dq_general": "flash_bwd_dq_general_kernelIfLi16EE",
    "flash_fwd_wide": "flash_fwd_wide_kernelIfLi24EE",
    "flash_bwd_dkdv_wide": "flash_bwd_dkdv_wide_kernelIfLi16EE",
    "flash_bwd_dq_wide": "flash_bwd_dq_wide_kernelIfLi24EE",
}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _clocks() -> str:
    """The card's SM clock, power draw and temperature right now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, runs: int = 20, warmup: int = 3, reps: int = 10) -> float:
    """Median over ``runs`` of the CUDA-event time of ``reps`` back-to-back
    calls of ``fn()``, per call.  Events around a single call would also
    count the host's launch overhead (tens of microseconds for a wrapper
    that encodes tensor maps) whenever that exceeds the device's time
    queued ahead; a batch keeps the device busy from the first call on."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_fro(a, b) -> float:
    d = torch.linalg.vector_norm(a.float() - b.float()).item()
    return d / max(torch.linalg.vector_norm(b.float()).item(), 1e-30)


def _free() -> None:
    """Release what the last phase left on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _visible_pairs(T: int, causal: bool, seq_len) -> int:
    n = T if seq_len is None else seq_len
    return n * (n + 1) // 2 if causal else n * n


def phase_device():
    import horovod_tpu_torch
    from horovod_tpu_torch.ops import _cuda
    here = Path(__file__).resolve().parent
    _check(Path(horovod_tpu_torch.__file__).resolve().parents[1] == here,
           f"horovod_tpu_torch was imported from {horovod_tpu_torch.__file__}"
           f", not from this checkout ({here})")
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    libs, seconds, log = _cuda.build()
    print(f"kernels built in {seconds:.1f} s: "
          + ", ".join(p.name for p in libs.values()))
    from horovod_tpu_torch import cpp_core
    t0 = time.perf_counter()
    _check(cpp_core.available(), "the native core (cpp/) did not build")
    print(f"native core {cpp_core._LIB_PATH} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    # ptxas' registers and spills for the kernels of the kernels line, and
    # any ptxas warning (a setmaxnreg that ptxas ignored, or wgmma
    # instructions it serialized, shows there).
    lines = log.splitlines()
    usage = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            for name, key in PTXAS_NAMES.items():
                if key not in line:
                    continue
                text = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", text)
                usage[name] = {
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                    if spill else None)}
        elif "warning" in line.lower():
            print(f"  {line.strip()}")
    for name in PTXAS_NAMES:
        _check(name in usage, f"no ptxas entry for {name}")
        print(f"  {name}: {usage[name]['registers']} registers, "
              f"{usage[name]['spill_bytes']} bytes spilled")
    # Every instantiation of G1-G3 that general_plan can pick, and of
    # W1-W3 that wide_plan can pick: element type and the columns of o
    # (G1, W1), dk and dv (G2, W2) or dq (G3, W3) a warp holds; none may
    # spill.  W1-W3's are printed by the wide phase.
    types = {"f": "f32", "6__half": "fp16", "13__nv_bfloat16": "bf16"}
    found = {"general": 0, "wide": 0}
    usage["wide"] = []
    for i, line in enumerate(lines):
        m = re.search(r"(flash_fwd_general|flash_bwd_dkdv_general|"
                      r"flash_bwd_dq_general|flash_fwd_wide|"
                      r"flash_bwd_dkdv_wide|flash_bwd_dq_wide)_kernelI"
                      r"(f|6__half|13__nv_bfloat16)Li(\d+)E",
                      line)
        if "Compiling entry function" not in line or not m:
            continue
        text = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", text)
        _check(spill is not None, f"no spill line for {m.group(0)}")
        spilled = int(spill.group(1)) + int(spill.group(2))
        label = (f"{m.group(1)} {types[m.group(2)]} "
                 f"{8 * int(m.group(3))} columns")
        family = "wide" if m.group(1).endswith("wide") else "general"
        if family == "wide":
            usage["wide"].append(
                (label, regs.group(1) if regs else "?", spilled))
        else:
            print(f"  {label}: {regs.group(1) if regs else '?'} registers, "
                  f"{spilled} bytes spilled")
        _check(spilled == 0, f"{m.group(0)} spills")
        found[family] += 1
    _check(found == {"general": 24, "wide": 21},
           f"{found} G1-G3 and W1-W3 instantiations in ptxas' log, expected "
           f"24 and 21")
    return usage


def _case(B, H, T, D, causal, seq_len, gen, dtype=torch.bfloat16):
    """q/k/v as column regions of one (B, T, 3C) projection, dO."""
    C = H * D
    qkv = torch.randn((B, T, 3 * C), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    do = torch.randn((B, T, C), generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    return dict(q=q, k=k, v=v, do=do, H=H, D=D, T=T, B=B, causal=causal,
                seq_len=seq_len, scale=1.0 / math.sqrt(D), dtype=dtype)


def _run_case(c, label, timing=False):
    """Hold the three kernels against their plain versions on one case;
    with ``timing``, also time kernel, plain and library call."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dk_ref, dv_ref = fa._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, H,
                                              **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    dq_ref = fa._flash_bwd_dq_plain(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    errs = {
        "o": _max_abs(o, o_ref), "lse": _max_abs(lse, lse_ref),
        "dk": _rel_fro(dk, dk_ref), "dv": _rel_fro(dv, dv_ref),
        "dq": _rel_fro(dq, dq_ref),
        "dq_abs": _max_abs(dq, dq_ref),
        "dkdv_abs": max(_max_abs(dk, dk_ref), _max_abs(dv, dv_ref)),
    }
    print(f"  {label}: o max abs {errs['o']:.3e}, lse max abs "
          f"{errs['lse']:.3e}, rel fro dq {errs['dq']:.3e} dk "
          f"{errs['dk']:.3e} dv {errs['dv']:.3e}")
    for name in ("o", "lse", "dq", "dk", "dv"):
        _check(math.isfinite(errs[name]), f"{label}: {name} not finite")
    _check(errs["o"] <= TOL_O, f"{label}: o error {errs['o']} > {TOL_O}")
    _check(errs["lse"] <= TOL_LSE,
           f"{label}: lse error {errs['lse']} > {TOL_LSE}")
    for name in ("dq", "dk", "dv"):
        _check(errs[name] <= TOL_GRAD,
               f"{label}: {name} rel error {errs[name]} > {TOL_GRAD}")
    if not timing:
        return errs, None
    del o_ref, lse_ref, dk_ref, dv_ref, dq_ref
    times = {
        "fwd": _median_ms(lambda: _cuda.flash_fwd(q, k, v, H, **kw)),
        "dkdv": _median_ms(lambda: _cuda.flash_bwd_dkdv(
            q, k, v, do, lse, delta, H, **kw)),
        "dq": _median_ms(lambda: _cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, H, **kw)),
        "fwd_plain": _median_ms(lambda: fa._flash_fwd_plain(
            q, k, v, H, **kw), runs=3, warmup=1, reps=1),
        "dkdv_plain": _median_ms(lambda: fa._flash_bwd_dkdv_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
        "dq_plain": _median_ms(lambda: fa._flash_bwd_dq_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
    }
    # Yardstick only: PyTorch's own fused attention on the same data in
    # its (B, H, T, D) layout.  The port never calls it.
    B, T, D = c["B"], c["T"], c["D"]
    F = torch.nn.functional

    def bhtd(x):
        return x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()

    qs, ks, vs = (bhtd(x).requires_grad_() for x in (q, k, v))
    dos = bhtd(do)
    times["sdpa_fwd"] = _median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=c["causal"]))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=c["causal"])
    times["sdpa_bwd"] = _median_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True))
    del out, qs, ks, vs, dos
    return errs, times


def _kernel_row(name, replaces, source, launches, err, ms, plain_ms,
                flops, nbytes, library_ms, library_call, usage,
                peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "library_call": library_call,
        "flops": flops, "bytes": nbytes, **usage,
    }


def phase_kernels():
    """Returns the timing case's numbers; the launch counts are filled in
    by the train phase."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("kernels vs plain versions (bf16):")
    _run_case(_case(2, 2, 512, 128, False, None, gen), "non-causal T=512")
    _run_case(_case(2, 3, 200, 64, True, 150, gen),
              "ragged T=200 seq_len=150 D=64")
    _run_case(_case(2, 3, 200, 80, True, 150, gen),
              "padded head T=200 seq_len=150 D=80")
    _run_case(_case(2, 2, 192, 128, True, 130, gen),
              "ragged T=192 seq_len=130 D=128")
    main = _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen)
    errs, times = _run_case(main, "main B=8 H=16 T=2048 D=128 causal",
                            timing=True)
    _check_deterministic(main)
    B, H, T, D = BATCH, HEADS, SEQ, DIM // HEADS
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 2          # one (B, T, C) bf16 tensor
    rows = B * H * T * 4                # one (B, H, T) f32 tensor
    work = {
        "flash_fwd": (4 * D * pairs, 4 * tensor + rows),
        "flash_bwd_dkdv": (8 * D * pairs, 6 * tensor + 2 * rows),
        "flash_bwd_dq": (6 * D * pairs, 5 * tensor + 2 * rows),
        # Five products per pair; q, k, v, dO read, dq, dk, dv written,
        # lse and delta read.
        FUSED: (10 * D * pairs, 7 * tensor + 2 * rows),
    }
    for name, key, lib in (("flash_fwd", "fwd", "sdpa_fwd"),
                           ("flash_bwd_dkdv", "dkdv", "sdpa_bwd"),
                           ("flash_bwd_dq", "dq", "sdpa_bwd")):
        flops = work[name][0]
        bound = flops / PEAK_BF16_FLOPS * 1e3
        print(f"  main: {name} {times[key]:.4f} ms, "
              f"{flops / times[key] / 1e9:.1f} TFLOP/s, "
              f"{bound / times[key]:.3f} of its bound ({bound:.4f} ms); "
              f"{times[key] / times[lib]:.2f}x the "
              f"scaled_dot_product_attention "
              f"{'forward' if lib == 'sdpa_fwd' else 'backward'} "
              f"({times[lib]:.4f} ms)")
    return {"errs": errs, "times": times, "work": work}


def _check_deterministic(c) -> None:
    """P1, P2 and P3 launched twice on the same inputs give the same bits
    (no atomics, a fixed order); P6 is not deterministic (its dq)."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o2, lse2 = _cuda.flash_fwd(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dk2, dv2 = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    dq2 = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    same = {"o": _bits_equal(o, o2), "lse": _bits_equal(lse, lse2),
            "dk": _bits_equal(dk, dk2), "dv": _bits_equal(dv, dv2),
            "dq": _bits_equal(dq, dq2)}
    print("  main: P1, P2 and P3 launched twice: " + ", ".join(
        f"{n} {'bit-identical' if ok else 'DIFFERENT'}"
        for n, ok in same.items()))
    _check(all(same.values()), f"P1/P2/P3 are not deterministic: {same}")


def _fused_case(c, label, timing=False):
    """Hold P6 against its plain version and against P2 + P3 on one case;
    with ``timing``, also time P6 and its plain version.  dk and dv are
    held to P2's tolerance; dq too, though P6 sums it in f32 with TMA
    adds whose order varies from run to run (a few ulps of f32 before the
    bf16 rounding that dominates)."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    got = _cuda.flash_bwd_fused(q, k, v, do, lse, delta, H, **kw)
    ref = fa._flash_bwd_fused_plain(q, k, v, do, lse, delta, H, **kw)
    dk2, dv2 = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dq2 = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    errs = {n: _rel_fro(g, r) for n, g, r in zip(names, got, ref)}
    split = {n: _rel_fro(g, r) for n, g, r in zip(names, got, (dq2, dk2,
                                                                dv2))}
    errs["abs"] = max(_max_abs(g, r) for g, r in zip(got, ref))
    same = [n for n, g, r in zip(names, got, (dq2, dk2, dv2))
            if torch.equal(g, r)]
    print(f"  {label}: rel fro vs plain dq {errs['dq']:.3e} dk "
          f"{errs['dk']:.3e} dv {errs['dv']:.3e}; vs P2 + P3 dq "
          f"{split['dq']:.3e} dk {split['dk']:.3e} dv {split['dv']:.3e} "
          f"(bit-identical: {', '.join(same) or 'none'})")
    for n in names:
        _check(math.isfinite(errs[n]) and errs[n] <= TOL_GRAD,
               f"{label}: P6 {n} rel error vs plain {errs[n]} > {TOL_GRAD}")
        _check(math.isfinite(split[n]) and split[n] <= TOL_GRAD,
               f"{label}: P6 {n} rel error vs P2 + P3 {split[n]} > "
               f"{TOL_GRAD}")
    if not timing:
        return errs, None
    del ref, dk2, dv2, dq2
    times = {
        FUSED: _median_ms(lambda: _cuda.flash_bwd_fused(
            q, k, v, do, lse, delta, H, **kw)),
        FUSED + "_plain": _median_ms(lambda: fa._flash_bwd_fused_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
    }
    return errs, times


def phase_fused_kernel(k):
    """P6 against its plain version and P2 + P3; adds its numbers to the
    kernel phase's ``k``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    print("one-pass backward P6 vs its plain version and P2 + P3 (bf16):")
    _fused_case(_case(2, 2, 512, 128, False, None, gen), "non-causal T=512")
    _fused_case(_case(2, 3, 200, 64, True, 150, gen),
                "ragged T=200 seq_len=150 D=64")
    _fused_case(_case(2, 3, 200, 80, True, 150, gen),
                "padded head T=200 seq_len=150 D=80")
    _fused_case(_case(2, 2, 192, 128, True, 130, gen),
                "ragged T=192 seq_len=130 D=128")
    errs, times = _fused_case(
        _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen),
        "main B=8 H=16 T=2048 D=128 causal", timing=True)
    t = k["times"]
    print(f"  main: P6 {times[FUSED]:.3f} ms (plain "
          f"{times[FUSED + '_plain']:.2f}) against P2 + P3 "
          f"{t['dkdv'] + t['dq']:.3f} ms and the scaled_dot_product_attention "
          f"backward {t['sdpa_bwd']:.3f} ms; bound "
          f"{k['work'][FUSED][0] / PEAK_BF16_FLOPS * 1e3:.3f} ms")
    k["errs"][FUSED] = errs["abs"]
    t.update(times)


def _device_kernels(fn) -> list:
    """The device kernels ``fn()`` launches, by name, with their device
    ms, longest first (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda k: -k[1])


def _run_general(c, label, timing=False, one_key=False, family="general"):
    """G1-G3 (W1-W3 with ``family="wide"``) against the plain versions on
    one case (the wrappers must route it to that family); with ``timing``,
    also time kernels,
    plain versions and f32 ``scaled_dot_product_attention``, and name the
    kernels that ran the latter.  ``one_key``: every row sees at most one
    key (T 1, or seq_len 1), so the softmax has no gradient and the exact
    dq and dk are 0; both versions' dq and dk are rounding noise, held to
    the same tolerance relative to dv's norm, the gradient scale of the
    case, instead of their own."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    names = GENERAL if family == "general" else WIDE
    _check(_cuda.flash_family(q.dtype, c["D"], q.stride(), q.data_ptr())
           == family, f"{label}: not routed to the {family} family")
    plan = _cuda.general_plan if family == "general" else _cuda.wide_plan
    copy = plan(f"flash_bwd_dkdv_{family}", c["B"], H, c["T"], c["D"],
                q.dtype, [(x.stride(), x.data_ptr())
                          for x in (q, k, v, do)]).copy_bytes
    _cuda.reset_launches()
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, H, **kw)
    delta = fa._delta(do, o_ref, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, H, **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse_ref, delta, H, **kw)
    ref = fa._flash_bwd_fused_plain(q, k, v, do, lse_ref, delta, H, **kw)
    torch.cuda.synchronize()
    launches = {n: _cuda.LAUNCHES[n] for n in FLASH + GENERAL + WIDE}
    _check(launches == {n: int(n in names) for n in launches},
           f"{label}: launches {launches}")
    errs = {"o": _rel_fro(o, o_ref), "lse": _max_abs(lse, lse_ref),
            "dq": _rel_fro(dq, ref[0]), "dk": _rel_fro(dk, ref[1]),
            "dv": _rel_fro(dv, ref[2]), "o_abs": _max_abs(o, o_ref),
            "grad_abs": max(_max_abs(g, r) for g, r in zip((dq, dk, dv),
                                                            ref))}
    if one_key:
        norm = max(torch.linalg.vector_norm(ref[2].float()).item(), 1e-30)
        for name, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1])):
            errs[name] = torch.linalg.vector_norm(
                got.float() - want.float()).item() / norm
    print(f"  {label} ({copy}-byte copies): rel fro o {errs['o']:.3e} dq "
          f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e}, lse "
          f"max abs {errs['lse']:.3e}"
          + (" (dq, dk against dv's norm)" if one_key else ""))
    f32 = c["dtype"] == torch.float32
    tol, tol_lse = (TOL_F32, TOL_F32_LSE) if f32 else (TOL_GRAD, TOL_LSE)
    for name in ("o", "dq", "dk", "dv"):
        _check(math.isfinite(errs[name]) and errs[name] <= tol,
               f"{label}: {name} rel error {errs[name]} > {tol}")
    _check(errs["lse"] <= tol_lse,
           f"{label}: lse error {errs['lse']} > {tol_lse}")
    if not timing:
        return errs, None
    del o_ref, ref
    slow = dict(runs=3, warmup=1, reps=2)
    times = {
        names[0]: _median_ms(lambda: _cuda.flash_fwd(
            q, k, v, H, **kw), runs=10, reps=5),
        names[1]: _median_ms(lambda: _cuda.flash_bwd_dkdv(
            q, k, v, do, lse, delta, H, **kw), runs=10, reps=5),
        names[2]: _median_ms(lambda: _cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, H, **kw), runs=10, reps=5),
        "fwd_plain": _median_ms(lambda: fa._flash_fwd_plain(
            q, k, v, H, **kw), runs=3, warmup=1, reps=1),
        "dkdv_plain": _median_ms(lambda: fa._flash_bwd_dkdv_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
        "dq_plain": _median_ms(lambda: fa._flash_bwd_dq_plain(
            q, k, v, do, lse, delta, H, **kw), runs=3, warmup=1, reps=1),
    }
    # Yardstick only, as in _run_case, here in f32.
    D = c["D"]

    def bhtd(x):
        return x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()

    F = torch.nn.functional
    qs, ks, vs = (bhtd(x).requires_grad_() for x in (q, k, v))
    dos = bhtd(do)
    times["sdpa_fwd"] = _median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=c["causal"]), **slow)
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=c["causal"])
    times["sdpa_bwd"] = _median_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True), **slow)
    times["sdpa_fwd_kernels"] = _device_kernels(
        lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                               is_causal=c["causal"]))
    times["sdpa_bwd_kernels"] = _device_kernels(
        lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                    retain_graph=True))
    del out, qs, ks, vs, dos
    return errs, times


def _check_general_deterministic(c, label="main f32: G1-G3") -> None:
    """G1, G2 and G3 (or W1-W3) launched twice on the same inputs give the
    same bits (no atomics, a fixed order of every sum)."""
    from horovod_tpu_torch.ops import _cuda
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    from horovod_tpu_torch.ops import flash_attention as fa
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    o2, lse2 = _cuda.flash_fwd(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    dk, dv = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dk2, dv2 = _cuda.flash_bwd_dkdv(q, k, v, do, lse, delta, H, **kw)
    dq = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    dq2 = _cuda.flash_bwd_dq(q, k, v, do, lse, delta, H, **kw)
    torch.cuda.synchronize()
    same = {"o": _bits_equal(o, o2), "lse": _bits_equal(lse, lse2),
            "dk": _bits_equal(dk, dk2), "dv": _bits_equal(dv, dv2),
            "dq": _bits_equal(dq, dq2)}
    print(f"  {label} launched twice: " + ", ".join(
        f"{n} {'bit-identical' if ok else 'DIFFERENT'}"
        for n, ok in same.items()))
    _check(all(same.values()), f"{label} are not deterministic: {same}")


def phase_general():
    """G1-G3 against the plain versions: f32 at the training shape, on
    the small cases, at head sizes P1-P3 do not take and at the edges of
    the tiles (D 1, 129 and 256, T 1, seq_len 1, each copy width), fp16,
    bf16; G1-G3 deterministic.  Returns the
    training shape's numbers."""
    from horovod_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 reference
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    print("general family G1-G3 vs plain versions (f32 unless named; "
          f"tolerance f32 {TOL_F32} rel fro, fp16/bf16 {TOL_GRAD}):")
    for B, H, T, D, causal, sl, dt, label in (
            (2, 2, 512, 128, False, None, f32, "non-causal T=512"),
            (2, 3, 200, 64, True, 150, f32, "ragged T=200 seq_len=150 D=64"),
            (2, 3, 200, 80, True, 150, f32, "T=200 seq_len=150 D=80"),
            (2, 2, 192, 128, True, 130, f32, "ragged T=192 seq_len=130"),
            (2, 4, 256, 8, True, None, f32, "D=8"),
            (2, 3, 256, 12, True, 200, f32, "D=12 seq_len=200"),
            (2, 2, 256, 200, True, None, f32, "D=200"),
            (2, 2, 256, 64, True, 230, f16, "fp16 D=64 seq_len=230"),
            (2, 4, 256, 8, True, None, bf16, "bf16 D=8"),
            (2, 3, 100, 1, True, None, f32, "D=1"),
            (2, 2, 200, 129, True, None, f32, "D=129 (two dk/dv halves)"),
            (2, 2, 256, 256, True, 250, f32, "D=256 seq_len=250"),
            (2, 2, 192, 256, False, None, bf16, "bf16 D=256 non-causal"),
            (2, 3, 150, 13, False, None, f32, "D=13 non-causal"),
            (2, 3, 150, 12, True, None, f16, "fp16 D=12"),
            (2, 3, 150, 13, True, None, bf16, "bf16 D=13")):
        _run_general(_case(B, H, T, D, causal, sl, gen, dt), label)
    for B, H, T, D, sl, label in ((2, 3, 1, 64, None, "T=1"),
                                  (2, 3, 200, 64, 1, "seq_len=1")):
        _run_general(_case(B, H, T, D, True, sl, gen, f32), label,
                     one_key=True)
    main = _case(BATCH, HEADS, SEQ, DIM // HEADS, True, None, gen, f32)
    errs, times = _run_general(main, "main f32 B=8 H=16 T=2048 D=128 causal",
                               timing=True)
    _check_general_deterministic(main)
    B, H, T, D = BATCH, HEADS, SEQ, DIM // HEADS
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 4          # one (B, T, C) f32 tensor
    rows = B * H * T * 4
    work = {"flash_fwd_general": (4 * D * pairs, 4 * tensor + rows),
            "flash_bwd_dkdv_general": (8 * D * pairs,
                                       6 * tensor + 2 * rows),
            "flash_bwd_dq_general": (6 * D * pairs, 5 * tensor + 2 * rows)}
    # G1-G3 run three TF32 products a term on the tensor cores: that
    # bound, beside the FFMA bound of the same sums.
    bounds = {name: {"ffma": flops / PEAK_F32_FLOPS * 1e3,
                     "tf32x3": 3 * flops / PEAK_TF32_FLOPS * 1e3}
              for name, (flops, _) in work.items()}
    for name in GENERAL:
        b = bounds[name]
        print(f"  main f32: {name} {times[name]:.3f} ms; bounds: FFMA at 67 "
              f"TFLOP/s {b['ffma']:.3f} ms, three TF32 products at 495 "
              f"TFLOP/s {b['tf32x3']:.3f} ms")
    for key in ("fwd", "bwd"):
        top = times[f"sdpa_{key}_kernels"]
        print(f"  main f32: scaled_dot_product_attention {key} "
              f"{times['sdpa_' + key]:.3f} ms ran "
              + "; ".join(f"{n[:100]} {ms:.3f} ms" for n, ms in top[:3]))
    pair = times["flash_bwd_dkdv_general"] + times["flash_bwd_dq_general"]
    print(f"  main f32: G2 + G3 {pair:.3f} ms, "
          f"{pair / times['sdpa_bwd']:.3f}x the scaled_dot_product_attention "
          f"backward ({times['sdpa_bwd']:.3f} ms, dq, dk and dv)")
    return {"errs": errs, "times": times, "work": work, "bounds": bounds}


# The wide route's timing cases: head size 384, where G1-G3 cannot stage
# their tiles; WIDE_CASE too small to fill the card (16 row blocks of 64),
# WIDE_FULL_CASE at a size that does (1024 row blocks; each (B, T, H*D)
# f32 tensor 100.7 MB).
WIDE_CASE = dict(B=1, H=2, T=512, D=384, causal=True)
WIDE_FULL_CASE = dict(B=4, H=8, T=2048, D=384, causal=True)


def _wide_work(w) -> dict:
    """FLOPs (the least: 4 D a visible pair for W1, 8 D for W2, 6 D for
    W3) and bytes (each input read once, each output written once) of
    W1-W3 on case ``w`` in f32."""
    B, H, T, D = w["B"], w["H"], w["T"], w["D"]
    pairs = B * H * _visible_pairs(T, w["causal"], None)
    tensor = B * T * H * D * 4
    rows = B * H * T * 4
    return {"flash_fwd_wide": (4 * D * pairs, 4 * tensor + rows),
            "flash_bwd_dkdv_wide": (8 * D * pairs, 6 * tensor + 2 * rows),
            "flash_bwd_dq_wide": (6 * D * pairs, 5 * tensor + 2 * rows)}


def _wide_device_ms(c) -> dict:
    """Device time of one call of W1, W2 and W3 on case ``c``: the
    profiler's time of every kernel a call launches.  Where the kernels
    take less than the wrappers' host time, as at ``WIDE_CASE``, CUDA
    events around back-to-back calls time the host instead."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, H = c["q"], c["k"], c["v"], c["do"], c["H"]
    kw = dict(scale=c["scale"], causal=c["causal"], seq_len=c["seq_len"])
    o, lse = _cuda.flash_fwd(q, k, v, H, **kw)
    delta = fa._delta(do, o, H)
    calls = {"flash_fwd_wide": lambda: _cuda.flash_fwd(q, k, v, H, **kw),
             "flash_bwd_dkdv_wide": lambda: _cuda.flash_bwd_dkdv(
                 q, k, v, do, lse, delta, H, **kw),
             "flash_bwd_dq_wide": lambda: _cuda.flash_bwd_dq(
                 q, k, v, do, lse, delta, H, **kw)}
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    return {n: sum(ms for _, ms in _device_kernels(call))
            for n, call in calls.items()}


def phase_wide(usage):
    """W1-W3 (``flash_wide.cu``, head sizes above 256) against the plain
    versions in f32 at D 264, 384 and 1000 (B 1, H 2, T 512, causal) and
    at ``WIDE_FULL_CASE``, within 1e-5 relative with TF32 off, at the
    route's largest head size ``WIDE_MAX_D`` (T 16), plus bf16 at D 320
    with a ragged seq_len; launched twice at both timing cases, the same
    bits; timed (and their device time a call taken from the profiler) at
    ``WIDE_CASE`` and ``WIDE_FULL_CASE`` beside the plain
    versions and f32 ``scaled_dot_product_attention``, whose kernels (the
    backend PyTorch picked) are named from the profiler, with the
    products W1-W3 do against the least (``wide_plan``) and the registers
    and spills of every W1-W3 instantiation (``usage``)."""
    from horovod_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    w = WIDE_CASE
    print("wide route W1-W3 vs plain versions (f32: tolerance "
          f"{TOL_F32} rel fro; bf16 {TOL_GRAD}):")
    for name, regs, spilled in usage["wide"]:
        print(f"  {name}: {regs} registers, {spilled} bytes spilled")
    for D in (264, 1000):
        _run_general(_case(w["B"], w["H"], w["T"], D, True, None, gen,
                           torch.float32), f"f32 D={D}", family="wide")
    _run_general(_case(1, 1, 16, _cuda.WIDE_MAX_D, True, None, gen,
                       torch.float32), f"f32 D={_cuda.WIDE_MAX_D} T=16",
                 family="wide")
    _run_general(_case(2, 3, 200, 320, True, 150, gen, torch.bfloat16),
                 "bf16 D=320 T=200 seq_len=150", family="wide")
    out = {}
    for key, c in (("small", WIDE_CASE), ("full", WIDE_FULL_CASE)):
        B, H, T, D = c["B"], c["H"], c["T"], c["D"]
        label = f"f32 B={B} H={H} T={T} D={D}"
        main = _case(B, H, T, D, True, None, gen, torch.float32)
        errs, times = _run_general(main, label, timing=True, family="wide")
        _check_general_deterministic(main, f"{label}: W1-W3")
        device = _wide_device_ms(main)
        print(f"  {label}: device time a call (profiler): "
              + ", ".join(f"{n} {ms:.4f} ms" for n, ms in device.items()))
        del main
        work = _wide_work(c)
        for name in WIDE:
            flops, _ = work[name]
            line = (f"  {label}: {name} {times[name]:.4f} ms; bound (3xTF32 "
                    f"at 495/3 TFLOP/s) "
                    f"{3 * flops / PEAK_TF32_FLOPS * 1e3:.4f} ms, FFMA (67 "
                    f"TFLOP/s) {flops / PEAK_F32_FLOPS * 1e3:.4f} ms")
            plan = _cuda.wide_plan(name, B, H, T, D)
            line += (f"; products {plan.products:.3f}x the least "
                     f"({plan.n_ochunks} column chunks of {plan.ocols}, "
                     f"{plan.grid[0] * H * B} blocks)")
            print(line)
        for k in ("fwd", "bwd"):
            top = times[f"sdpa_{k}_kernels"]
            print(f"  {label}: scaled_dot_product_attention {k} "
                  f"{times['sdpa_' + k]:.4f} ms ran "
                  + "; ".join(f"{n[:100]} {ms:.3f} ms" for n, ms in top[:3]))
        print(f"  {label}: W1 {times['flash_fwd_wide'] / times['sdpa_fwd']:.3f}x"
              f" the scaled_dot_product_attention forward")
        pair = times["flash_bwd_dkdv_wide"] + times["flash_bwd_dq_wide"]
        print(f"  {label}: W2 + W3 {pair:.4f} ms, "
              f"{pair / times['sdpa_bwd']:.3f}x the "
              f"scaled_dot_product_attention backward")
        out[key] = {"errs": errs, "times": times, "work": work,
                    "device": device}
        _free()
    return out


def phase_models_f32():
    """The reference's f32 model checks on the card: the flash model's
    logits equal the attn="full" model's elementwise within ``TOL_MODEL``
    (relative and absolute), through the general family, and so do its
    gradients (relative Frobenius: the same f32 sums in another order).
    Counters are zeroed before each flash model's forward and backward and
    read after: G1-G3 run once per layer, P1-P3 never.  Returns the
    launches of both flash models."""
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops import _cuda
    f32 = torch.float32
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    for vocab, dim, depth, heads in ((64, 256, 1, 2), (64, 32, 2, 4),
                                     (64, 768, 1, 2)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        tokens = torch.randint(0, vocab, (2, 32), generator=gen,
                               device="cuda")
        cot = torch.randn((2, 32, vocab), generator=gen, device="cuda")
        logits, grads = {}, {}
        for attn in ("full", "flash"):
            model = TransformerLM(vocab=vocab, dim=dim, depth=depth,
                                  num_heads=heads, max_len=32, attn=attn,
                                  dtype=f32, head_dtype=f32, ln_dtype=f32,
                                  seed=SEED, device="cuda")
            _cuda.reset_launches()
            logits[attn] = model(tokens)
            (logits[attn] * cot).sum().backward()
            torch.cuda.synchronize()
            ran = dict(_cuda.LAUNCHES)
            grads[attn] = torch.cat([p.grad.flatten()
                                     for p in model.parameters()])
        a, b = logits["flash"].detach(), logits["full"].detach()
        bad = int(((a - b).abs() > TOL_MODEL + TOL_MODEL * b.abs()).sum())
        rel = _rel_fro(grads["flash"], grads["full"])
        print(f"f32 model dim {dim} heads {heads} (D {dim // heads}): "
              f"logits flash vs full max abs {_max_abs(a, b):.3e}, "
              f"{bad} outside rtol = atol = {TOL_MODEL}; gradients rel fro "
              f"{rel:.3e}; launches { {n: c for n, c in ran.items() if c} }")
        _check(bad == 0, f"f32 model dim {dim}: {bad} logits differ")
        _check(rel <= TOL_MODEL, f"f32 model dim {dim}: grads rel {rel}")
        names = WIDE if dim // heads > 256 else GENERAL
        want = {n: depth if n in names else 0
                for n in FLASH + GENERAL + WIDE}
        _check({n: ran[n] for n in want} == want,
               f"f32 model dim {dim}: launches {ran}")
        for n, c in ran.items():
            launches[n] += c
    return launches


def phase_reference():
    """A small model through the kernels against the oracle attention."""
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    bf16 = torch.bfloat16
    results = {}
    for attn in ("flash", "full"):
        model = TransformerLM(vocab=512, dim=256, depth=2, num_heads=2,
                              max_len=128, attn=attn, dtype=bf16,
                              head_dtype=bf16, ln_dtype=bf16, seed=SEED,
                              device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        tokens = torch.randint(0, 512, (4, 129), generator=gen,
                               device="cuda")
        h = model(tokens[:, :-1], return_hidden=True)
        loss = fused_softmax_xent(h.reshape(-1, 256), model.head.kernel,
                                  tokens[:, 1:].reshape(-1)).mean()
        loss.backward()
        grads = torch.cat([p.grad.flatten() for p in model.parameters()])
        results[attn] = (loss.item(), grads)
    (lf, gf), (lr, gr) = results["flash"], results["full"]
    rel = _rel_fro(gf, gr)
    print(f"reference: small model loss flash {lf:.6f} oracle {lr:.6f}, "
          f"grad rel fro {rel:.3e}")
    _check(math.isfinite(lf) and abs(lf - lr) <= 2e-2 * abs(lr),
           f"small-model loss {lf} vs oracle {lr}")
    _check(rel <= 5e-2, f"small-model grads rel error {rel}")


def _lm(attn, depth, max_len, device, dtype=torch.bfloat16, **kw):
    """The full-width TransformerLM, random weights from ``SEED``."""
    from horovod_tpu_torch.models import TransformerLM
    return TransformerLM(vocab=VOCAB, dim=DIM, depth=depth, num_heads=HEADS,
                         max_len=max_len, attn=attn, dtype=dtype,
                         head_dtype=dtype, ln_dtype=dtype, seed=SEED,
                         device=device, **kw)


def _lm_loss(model, batch):
    """The headline loss: fused CE of the final hidden states on the head
    kernel, over an (inputs, labels) pair or a (B, T + 1) token tensor."""
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    inp, lab = ((batch[:, :-1], batch[:, 1:]) if torch.is_tensor(batch)
                else batch)
    h = model(inp, return_hidden=True)
    return fused_softmax_xent(h.reshape(-1, h.shape[-1]), model.head.kernel,
                              lab.reshape(-1)).mean()


def _train_setup(depth: int):
    """The headline leg's model, one batch of tokens and its loss."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                           device="cuda")
    return _lm("flash", depth, SEQ, "cuda"), tokens, _lm_loss


@contextlib.contextmanager
def _xent_mode(mode):
    """Within the block, ``HOROVOD_TPU_XENT_MODE=mode`` when ``mode`` is
    given: the fused CE then runs that schedule."""
    if mode:
        os.environ.update(HOROVOD_TPU_XENT_MODE=mode)
    try:
        yield
    finally:
        if mode:
            os.environ.pop("HOROVOD_TPU_XENT_MODE", None)


@contextlib.contextmanager
def _one_pass(on: bool):
    """Within the block, ``HOROVOD_TPU_FLASH_BWD=fullunroll`` when ``on``:
    the backward of every layer is then P6."""
    if on:
        os.environ.update(HOROVOD_TPU_FLASH_BWD="fullunroll")
    try:
        yield
    finally:
        if on:
            os.environ.pop("HOROVOD_TPU_FLASH_BWD", None)


def _model_flops(depth: int) -> int:
    """Model FLOPs of one step, as bench.py counts them: 6 x matmul
    parameters + 12 x depth x seq x dim per token."""
    n_matmul = 12 * depth * DIM * DIM + VOCAB * DIM
    return (6 * n_matmul + 12 * depth * SEQ * DIM) * (BATCH * SEQ)


def phase_train(depth: int, one_pass: bool = False, xent=None):
    """The headline step; with ``one_pass``, under
    ``HOROVOD_TPU_FLASH_BWD=fullunroll``; with ``xent``, under
    ``HOROVOD_TPU_XENT_MODE=xent``."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.spmd import make_train_step
    label = ("train one-pass" if one_pass
             else f"train {xent}" if xent else "train")
    torch.cuda.reset_peak_memory_stats()
    model, tokens, loss_fn = _train_setup(depth)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt)
    torch.cuda.synchronize()
    with _one_pass(one_pass), _xent_mode(xent):
        _cuda.reset_launches()
        losses, times = [], []
        for i in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            loss = step(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
        launches = dict(_cuda.LAUNCHES)
    steps = WARMUP + TIMED
    step_s = statistics.median(times[WARMUP:])
    tokens_per_s = BATCH * SEQ / step_s
    mfu = _model_flops(depth) / step_s / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: depth {depth} of {DEPTH}, losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"{label}: step {step_s * 1e3:.1f} ms (median of {TIMED}; all "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms), "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.3f} at 989 TFLOP/s, "
          f"peak memory {peak_gb:.2f} GiB, launches {launches}")
    print(f"{label}: after the timed steps, SM clock, power, temperature: "
          f"{_clocks()}")
    _check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    _check(losses[-1] < losses[0],
           f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    bwd = (FUSED,) if one_pass else FLASH[1:]
    for name in FLASH + (FUSED,) + GENERAL:
        want = depth * steps if name == "flash_fwd" or name in bwd else 0
        _check(launches[name] == want,
               f"{label}: {name} launched {launches[name]} times, expected "
               f"{want}")
    with _one_pass(one_pass), _xent_mode(xent):
        _profile_step(step, tokens)
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "peak_gb": peak_gb}


def check_one_pass(one: dict, plain: dict) -> None:
    """The one-pass phase's losses against the split phase's: the first
    bit for bit (the forward is the same), every one within
    ``TOL_ONE_PASS``."""
    track = max(abs(a - b) / abs(b) for a, b in zip(one["losses"],
                                                     plain["losses"]))
    print(f"train one-pass: step {one['step_s'] * 1e3:.1f} ms against "
          f"{plain['step_s'] * 1e3:.1f} ms split; first loss "
          f"{'bit-identical' if one['losses'][0] == plain['losses'][0] else 'DIFFERENT'}"
          f", every loss vs split {track:.2e} relative at most")
    _check(one["losses"][0] == plain["losses"][0],
           f"one-pass first loss {one['losses'][0]} differs from the split "
           f"phase's {plain['losses'][0]}")
    _check(track <= TOL_ONE_PASS,
           f"one-pass losses {one['losses']} stray from the split phase's "
           f"{plain['losses']}")


# Phase 31: every loss under the recompute and save2 schedules against
# phase 7's (unroll2), relative.  The forward is the same; one cuBLAS
# product over N rows may round differently from two over N/2, and save2's
# backward reads bf16 logits, whose rounding moves the softmax by ~2e-3
# relative against a gradient the one-hot term dominates.  Measured
# 5.81e-6 (recompute) and 7.63e-6 (save2) on an H100 80GB HBM3 at 700 W,
# in two runs alike (PERF.md).
TOL_XENT = 1e-5
XENT_MODES = ("recompute", "save2")


def phase_xent(depth: int, plain: dict) -> dict:
    """Phase 31: the headline step under each of ``XENT_MODES`` (model
    rebuilt from the same seed, 2 warm-up and 5 timed steps): P1, P2 and
    P3 each launch depth x steps times (``phase_train`` checks it), every
    loss within ``TOL_XENT`` of phase 7's; step ms and peak memory beside
    phase 7's.  The knob is unset after each."""
    out = {}
    for mode in XENT_MODES:
        t0 = time.perf_counter()
        run = phase_train(depth, xent=mode)
        _check("HOROVOD_TPU_XENT_MODE" not in os.environ,
               "HOROVOD_TPU_XENT_MODE left set")
        track = max(abs(a - b) / abs(b)
                    for a, b in zip(run["losses"], plain["losses"]))
        print(f"train {mode}: step {run['step_s'] * 1e3:.1f} ms, peak "
              f"memory {run['peak_gb']:.2f} GiB against "
              f"{plain['step_s'] * 1e3:.1f} ms and "
              f"{plain['peak_gb']:.2f} GiB under unroll2 (phase 7); every "
              f"loss vs phase 7's {track:.2e} relative at most; phase "
              f"{time.perf_counter() - t0:.1f} s")
        _check(track <= TOL_XENT,
               f"train {mode}: losses {run['losses']} stray from phase "
               f"7's {plain['losses']} by {track} > {TOL_XENT}")
        out[mode] = run
        _free()
    return out


def phase_routing():
    """``bwd_impl`` picks the backward on the card as the JAX package
    does: P6 while T * D * 4 bytes <= 4 MiB, else P2 + P3; ``"xla"`` is
    plain PyTorch and agrees with the split pair."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, H, D = 2, HEADS, DIM // HEADS

    def inputs(T):
        ins = [torch.randn((B, T, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3)]
        g = torch.randn((B, T, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        return ins, g

    def run(T, impl, ins, g):
        _cuda.reset_launches()
        grads = torch.autograd.grad(flash_attention(*ins, bwd_impl=impl),
                                    ins, g)
        torch.cuda.synchronize()
        return grads, {n: _cuda.LAUNCHES[n] for n in FLASH[1:] + (FUSED,)}

    def routed(T, impl, ins, g, want):
        grads, launches = run(T, impl, ins, g)
        print(f"routing: T={T} bwd_impl={impl!r}, T*D*4 = "
              f"{T * D * 4 / 2 ** 20:g} MiB: backward launches {launches}")
        _check(tuple(launches.values()) == want,
               f"routing: T={T} {impl}: launches {launches}, expected "
               f"{dict(zip(launches, want))}")
        return grads

    ins, g = inputs(8192)
    fused = routed(8192, "pallas_fused", ins, g, (0, 0, 1))
    split = routed(8192, "pallas", ins, g, (1, 1, 0))
    errs = [_rel_fro(a, b) for a, b in zip(fused, split)]
    print("routing: T=8192 P6 vs P2 + P3 gradients, rel fro "
          + ", ".join(f"{e:.3e}" for e in errs))
    _check(max(errs) <= TOL_GRAD, f"routing: P6 vs split {errs}")
    del ins, g, fused, split
    ins, g = inputs(16384)
    routed(16384, "pallas_fused", ins, g, (1, 1, 0))
    del ins, g
    ins, g = inputs(SEQ)
    split, _ = run(SEQ, "pallas", ins, g)
    t0 = time.perf_counter()
    xla, launches = run(SEQ, "xla", ins, g)
    seconds = time.perf_counter() - t0
    errs = [_rel_fro(a, b) for a, b in zip(xla, split)]
    print(f"routing: T={SEQ} bwd_impl='xla' (plain PyTorch, "
          f"{seconds * 1e3:.1f} ms host clock for forward and backward) vs "
          f"P2 + P3, rel fro " + ", ".join(f"{e:.3e}" for e in errs)
          + f"; kernel launches in its backward {launches}")
    _check(not any(launches.values()),
           f"routing: the xla backward launched kernels {launches}")
    _check(max(errs) <= TOL_GRAD, f"routing: xla vs split {errs}")


# --------------------------------------------------------------------------
# The int8 codec (P4, P5), the ring and the DistributedOptimizer.


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _snap_plain(x):
    """``snap_to_grid`` on the plain codec."""
    from horovod_tpu_torch.ops import quantized_collectives as qc
    n = x.numel()
    flat = torch.nn.functional.pad(x.reshape(-1).float(),
                                   (0, -n % qc.BLOCK_ELEMS))
    q, s = qc._quantize_plain(flat.reshape(-1, qc.BLOCK_ELEMS))
    return qc._dequantize_plain(q, s).reshape(-1)[:n].reshape(x.shape)


def _edge_blocks(gen):
    """Five 1024-element blocks: all zero; two tiny normal values; a
    subnormal absmax; values near 1e38; randn * exp(U(-6, 6))."""
    def uniform(lo, hi):
        return torch.rand(1024, generator=gen, device="cuda") * (hi - lo) \
            + lo

    zero = torch.zeros(1024, device="cuda")
    tiny = torch.zeros(1024, device="cuda")
    tiny[7], tiny[100] = 2e-38, -1.5e-38
    sub = uniform(-1.1e-38, 1.1e-38)
    big = uniform(-1e38, 1e38)
    big[5] = 3e38
    wide = torch.randn(1024, generator=gen, device="cuda") \
        * torch.exp(uniform(-6, 6))
    return torch.cat([zero, tiny, sub, big, wide])


def _codec_agrees(x, label):
    """P4 and P5 against their plain versions on ``x`` (a multiple of 1024
    elements), bit for bit."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    grid = x.reshape(-1, qc.BLOCK_ELEMS)
    q, s = _cuda.int8_quantize(grid)
    q_ref, s_ref = qc._quantize_plain(grid)
    d = _cuda.int8_dequantize(q_ref, s_ref)
    d_ref = qc._dequantize_plain(q_ref, s_ref)
    torch.cuda.synchronize()
    ok = {"q": _bits_equal(q, q_ref), "scales": _bits_equal(s, s_ref),
          "dequantized": _bits_equal(d, d_ref)}
    print(f"  {label}: " + ", ".join(
        f"{k} {'bit-identical' if v else 'DIFFERENT'}" for k, v in ok.items())
        + f"; max abs error of the round trip vs input "
        f"{_max_abs(d, x.reshape(grid.shape)):.3e}")
    _check(all(ok.values()), f"{label}: codec kernel differs from its "
           f"plain version: {ok}")
    return max(_max_abs(d, d_ref), _max_abs(q, q_ref), _max_abs(s, s_ref))


def phase_codec():
    """Returns the timing shape's numbers; launches come from the int8
    train phase."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    print("int8 codec kernels vs plain versions:")
    _codec_agrees(_edge_blocks(gen), "edge blocks")
    tail = torch.randn(1025, generator=gen, device="cuda")
    snapped, snapped_ref = qc.snap_to_grid(tail), _snap_plain(tail)
    torch.cuda.synchronize()
    print(f"  1025-element tail through snap_to_grid: "
          f"{'bit-identical' if _bits_equal(snapped, snapped_ref) else 'DIFFERENT'}")
    _check(_bits_equal(snapped, snapped_ref), "snap_to_grid tail differs")
    x = torch.randn(CODEC_N, generator=gen, device="cuda") \
        * torch.exp(torch.rand(CODEC_N, generator=gen, device="cuda") * 12
                    - 6)
    err = _codec_agrees(x, f"n={CODEC_N}")
    grid = x.reshape(-1, qc.BLOCK_ELEMS)
    q, s = _cuda.int8_quantize(grid)
    times = {
        "int8_quantize": _median_ms(lambda: _cuda.int8_quantize(grid)),
        "int8_dequantize": _median_ms(lambda: _cuda.int8_dequantize(q, s)),
        "int8_quantize_plain": _median_ms(lambda: qc._quantize_plain(grid)),
        "int8_dequantize_plain": _median_ms(
            lambda: qc._dequantize_plain(q, s)),
        # Yardstick only: one PyTorch call, int8 x f32 promoted to f32.
        "int8_dequantize_library": _median_ms(lambda: torch.mul(q, s)),
    }
    lib_same = _bits_equal(torch.mul(q, s), qc._dequantize_plain(q, s))
    blocks = CODEC_N // qc.BLOCK_ELEMS
    nbytes = CODEC_N * 4 + CODEC_N + blocks * 4   # f32 <-> int8 + scales
    print(f"  n={CODEC_N}: quantize {times['int8_quantize']:.4f} ms (plain "
          f"{times['int8_quantize_plain']:.4f}), dequantize "
          f"{times['int8_dequantize']:.4f} ms (plain "
          f"{times['int8_dequantize_plain']:.4f}, torch.mul "
          f"{times['int8_dequantize_library']:.4f}, "
          f"{'bit-identical' if lib_same else 'DIFFERENT'}); bound "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms each ({nbytes} bytes at "
          f"3.35 TB/s)")
    _check(lib_same, "torch.mul(q, scales) differs from the plain "
           "dequantize")
    return {"err": err, "times": times, "work": {
        # abs, max, scale, clamp x2, round per element; a convert and a
        # multiply per element.
        "int8_quantize": (6 * CODEC_N, nbytes),
        "int8_dequantize": (2 * CODEC_N, nbytes)}}


class _PlainCodec:
    """Within the block, the codec's CUDA entry points run the plain
    versions: the ring on the same data without the kernels."""

    def __enter__(self):
        from horovod_tpu_torch.ops import _cuda
        from horovod_tpu_torch.ops import quantized_collectives as qc
        self.saved = (_cuda.int8_quantize, _cuda.int8_dequantize)
        _cuda.int8_quantize = qc._quantize_plain
        _cuda.int8_dequantize = qc._dequantize_plain

    def __exit__(self, *exc):
        from horovod_tpu_torch.ops import _cuda
        _cuda.int8_quantize, _cuda.int8_dequantize = self.saved


def _ring_inputs(rank: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + rank)
    return torch.randn(RING_N, generator=gen, device="cuda") * (1 + rank)


def phase_ring():
    from horovod_tpu_torch.ops import quantized_collectives as qc
    xs = [_ring_inputs(r) for r in range(RING_RANKS)]
    t0 = time.perf_counter()
    out = qc.lockstep_ring_allreduce(xs, average=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with _PlainCodec():
        ref = qc.lockstep_ring_allreduce(xs, average=True)
    mean = torch.stack(xs).mean(0)
    rel = _rel_fro(out[0], mean)
    same = all(_bits_equal(o, r) for o, r in zip(out, ref))
    print(f"ring: {RING_RANKS} ranks in lockstep x {RING_N} elements, "
          f"kernels vs plain codec "
          f"{'bit-identical' if same else 'DIFFERENT'}, rel fro vs f32 "
          f"mean {rel:.3e}, {seconds * 1e3:.1f} ms host clock")
    _check(same, "ring on the kernels differs from the ring on the plain "
           "codec")
    _check(rel <= TOL_RING, f"ring vs mean rel error {rel} > {TOL_RING}")


def phase_train_int8(depth: int, plain: dict):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    torch.cuda.reset_peak_memory_stats()
    model, tokens, loss_fn = _train_setup(depth)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=hvd.Compression.int8, error_feedback=True)
    leaves = sum(qc.int8_eligible(p.shape, p.dtype)
                 for p in model.parameters())
    _check(leaves == 3 + 4 * depth,
           f"{leaves} int8-eligible leaves, expected {3 + 4 * depth}")

    def step(batch):
        opt.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses, times = [], []
    for _ in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(_cuda.LAUNCHES)
    steps = WARMUP + TIMED
    step_s = statistics.median(times[WARMUP:])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    first = abs(losses[0] - plain["losses"][0]) / abs(plain["losses"][0])
    track = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    print(f"train int8: depth {depth}, DistributedOptimizer(SGD momentum, "
          f"int8, error feedback), losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"train int8: step {step_s * 1e3:.1f} ms against "
          f"{plain['step_s'] * 1e3:.1f} ms plain (median of {TIMED}; all "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms), "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, MFU "
          f"{_model_flops(depth) / step_s / PEAK_BF16_FLOPS:.3f} at 989 "
          f"TFLOP/s, peak memory "
          f"{peak_gb:.2f} GiB, {leaves} int8 leaves, first loss vs plain "
          f"{first:.2e} relative, every loss vs plain {track:.2e} at most, "
          f"launches {launches}")
    print(f"train int8: after the timed steps, SM clock, power, "
          f"temperature: {_clocks()}")
    _check(all(math.isfinite(x) for x in losses), "int8: non-finite loss")
    _check(losses[-1] < losses[0],
           f"int8: loss did not fall: {losses[0]} -> {losses[-1]}")
    _check(first <= TOL_FIRST_LOSS,
           f"int8: first loss {losses[0]} vs plain {plain['losses'][0]}")
    _check(track <= TOL_LOSS_TRACK,
           f"int8: losses {losses} stray from plain {plain['losses']}")
    for name in FLASH:
        _check(launches[name] == depth * steps,
               f"int8: {name} launched {launches[name]} times, expected "
               f"{depth * steps}")
    for name in ("int8_quantize", "int8_dequantize"):
        _check(launches[name] == leaves * steps,
               f"int8: {name} launched {launches[name]} times, expected "
               f"{leaves * steps}")
    _profile_step(step, tokens)
    _replay_head_step(model, opt, tokens, loss_fn)
    return {"launches": launches, "losses": losses, "step_s": step_s}


def _replay_head_step(model, opt, tokens, loss_fn) -> None:
    """The wrapper's arithmetic on the card: one ``DistributedOptimizer``
    step of the ``head`` leaf from the trained state (parameter, momentum,
    residual) and its gradient there, on the kernels and on the plain
    codec.  The two must agree bit for bit, and with the step written out
    here: carry-in ``g + r``, residual ``g - Q(g)`` (bit for bit), momentum
    ``0.9 buf + g`` and ``p - lr buf`` (each element to one bf16 step of
    its value; at world size 1 the reduction is the identity)."""
    import contextlib
    import horovod_tpu_torch as hvd
    src = model.head.kernel
    grad, = torch.autograd.grad(loss_fn(model, tokens), [src])
    st = opt.state[src]
    lr, momentum = opt.param_groups[0]["lr"], 0.9
    out = []
    for codec in (contextlib.nullcontext(), _PlainCodec()):
        p = torch.nn.Parameter(src.detach().clone())
        one = hvd.DistributedOptimizer(
            torch.optim.SGD([p], lr=lr, momentum=momentum),
            compression=hvd.Compression.int8, error_feedback=True,
            overlap=False)
        one.state[p]["momentum_buffer"] = st["momentum_buffer"].clone()
        one.state[p]["residual"] = st["residual"].clone()
        p.grad = grad.clone()
        with codec:
            one.step()
        out.append((p.detach(), one.state[p]["momentum_buffer"],
                    one.state[p]["residual"]))
    g = grad + st["residual"].to(grad.dtype)
    residual = g.float() - _snap_plain(g.float())
    buf = st["momentum_buffer"] * momentum + g
    param = torch.add(src.detach(), buf, alpha=-lr)

    def off(a, b):
        """Elements of ``a`` more than one bf16 step from ``b``."""
        a, b = a.float(), b.float()
        return int(((a - b).abs() > 2 ** -7 * b.abs()).sum().item())

    same = all(_bits_equal(a, b) for a, b in zip(*out))
    res_ok = _bits_equal(out[0][2], residual)
    buf_off, p_off = off(out[0][1], buf), off(out[0][0], param)
    moved = int((out[0][0] != src.detach()).sum().item())
    print(f"train int8: one head step replayed, kernels vs plain codec "
          f"{'bit-identical' if same else 'DIFFERENT'}; residual vs "
          f"g - Q(g) {'bit-identical' if res_ok else 'DIFFERENT'} (max "
          f"{residual.abs().max().item():.3e}); momentum and parameter vs "
          f"the step written out: {buf_off} and {p_off} elements more than "
          f"one bf16 step off, {_max_abs(out[0][1], buf):.3e} and "
          f"{_max_abs(out[0][0], param):.3e} max abs; {moved} of "
          f"{src.numel()} parameters moved")
    _check(same, "int8: the wrapper's step on the kernels differs from the "
           "plain codec")
    _check(res_ok, "int8: the residual is not g - Q(g) of the carried-in "
           "gradient")
    _check(buf_off == 0 and p_off == 0,
           f"int8: {buf_off} momentum and {p_off} parameter elements off "
           f"the step")
    _check(moved > 0 and residual.abs().max().item() > 0,
           "int8: the replayed step moved nothing")


def _nccl_worker(rank: int, port: int, results) -> None:
    try:
        import torch.distributed as dist
        from horovod_tpu_torch.ops import quantized_collectives as qc
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        out = qc.quantized_ring_allreduce(_ring_inputs(rank), average=True)
        want = qc.lockstep_ring_allreduce(
            [_ring_inputs(r) for r in range(2)], average=True)[rank]
        torch.cuda.synchronize()
        ok = _bits_equal(out, want)
        dist.destroy_process_group()
        results.put((rank, ok))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_nccl_ring():
    if torch.cuda.device_count() < 2:
        print("nccl ring: not run (one CUDA device; it needs two)")
        return
    got = _spawn(_nccl_worker, 2)
    print(f"nccl ring: 2 processes x {RING_N} elements, distributed vs "
          f"lockstep ring: {got}")
    _check(got == {0: True, 1: True}, f"nccl ring failed: {got}")


# The ResNet-50 leg (bench.py:150-256): batch 128 per GPU, 224 x 224,
# bf16, SGD lr 0.01 momentum 0.9, sync_aux_state=True, steps_per_call=5.
RESNET_BATCH, RESNET_SIZE, RESNET_SPC, RESNET_TIMED = 128, 224, 5, 3
# bench.py:270-281: 4.1e9 is ResNet-50's multiply-accumulates per 224 x
# 224 image (8.2 GFLOP); the bench's analytic MFU counts 3 x 4.1e9 per
# image for forward and backward, and so does this script.
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9
TOL_BN_STATS = 1e-3      # bn_init's running statistics, relative
TOL_SPC = 1e-5           # steps_per_call vs single steps, losses, relative
# ResNet-50 on the card against the CPU on RESNET_CHECK images, relative
# Frobenius.  The backward of this problem amplifies small changes: on the
# CPU alone, inputs moved by 1e-6 moved its f32 gradients by 1.3e-3 taken
# together and one BatchNorm bias gradient by 9e-3, and its bf16 logits by
# 3.8e-3 (phase 15 prints this floor in every run; H100 80GB HBM3 host,
# PERF.md).  So the limits sit a few times above that floor, and far
# below the O(1) error of a wrong gradient: f32 loss and logits 1e-4, all
# f32 gradients together 1e-2, every f32 gradient and buffer 5e-2; bf16
# loss and logits 2e-2 (the bf16 gradients are not held: bf16 rounding
# alone moves them by ~6e-2).
RESNET_CHECK = 4
TOL_RESNET_FWD = 1e-4
TOL_RESNET_GRADS = 1e-2
TOL_RESNET_TENSOR = 5e-2
TOL_RESNET_BF16 = 2e-2
SMALL_RESNET = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)


def _resnet_loss(model, batch):
    import torch.nn.functional as F
    images, labels = batch
    return F.cross_entropy(model(images), labels)


def _resnet_category(name: str) -> str:
    low = name.lower()
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "xmma",
                              "implicit", "cudnn", "nhwc", "nchw")):
        return "convolution (cuDNN)"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "reduce", "copy", "fill", "batch_norm",
                              "cat")):
        return "BatchNorm and elementwise"
    return "other (pooling, head, optimizer)"


def phase_resnet_steps_per_call():
    """A small ResNet on the card: one call with ``steps_per_call=3``
    against three single-step calls of the same model, same batches."""
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.spmd import make_train_step
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    images = torch.randn(3, 16, 32, 32, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (3, 16), generator=gen, device="cuda")
    losses = {}
    for spc in (1, 3):
        model = ResNet(**SMALL_RESNET, seed=SEED, device="cuda")
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, _resnet_loss, opt,
                               steps_per_call=spc)
        if spc == 1:
            losses[spc] = [step((images[i], labels[i])).item()
                           for i in range(3)]
        else:
            losses[spc] = step((images, labels)).item()
    want = sum(losses[1]) / 3
    err = abs(losses[3] - want) / abs(want)
    print(f"resnet steps_per_call: one call of 3 gives {losses[3]:.6f}, "
          f"3 single steps {losses[1]} (mean {want:.6f}), {err:.2e} "
          f"relative")
    _check(err <= TOL_SPC, f"steps_per_call=3 differs from 3 single steps "
           f"by {err} > {TOL_SPC}")


def _resnet_pass(model, images, labels) -> dict:
    """One train-mode forward and backward: loss, logits, every
    parameter's gradient and every buffer after the forward, as f64 on
    the CPU."""
    import torch.nn.functional as F
    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    out = {"loss": loss.detach().reshape(1), "logits": logits.detach()}
    out.update({"grad " + n: p.grad for n, p in model.named_parameters()})
    out.update({"buffer " + n: b for n, b in model.named_buffers()})
    return {k: v.detach().double().cpu() for k, v in out.items()}


def phase_resnet_cpu():
    """ResNet-50 at full width on the card against the same model and
    inputs on the CPU, in f32 (TF32 off) and in the leg's bf16, on
    ``RESNET_CHECK`` images of 224 x 224 with random labels.  The last
    BatchNorm scale of every block, zero at init, is drawn from U(0.05,
    0.15): every block's convolutions then get a gradient while the
    residual branches stay small.  (With every scale drawn from U(0.5,
    1.5) the backward is chaotic: a 1e-6 change of the inputs moved
    gradients by 3e-2, so no two devices can agree on them.)  The CPU
    pass is repeated on inputs moved by 1e-6 relative, to print how far
    the problem itself amplifies a change that small.  In f32 the loss
    and the logits within ``TOL_RESNET_FWD``, all gradients together
    within ``TOL_RESNET_GRADS``, every gradient and buffer within
    ``TOL_RESNET_TENSOR``; in bf16 the loss and the logits within
    ``TOL_RESNET_BF16``."""
    from horovod_tpu_torch.models import ResNet50
    _card_vs_cpu("resnet50", lambda dtype, device: ResNet50(
        num_classes=1000, dtype=dtype, seed=SEED, device=device),
        RESNET_CHECK, RESNET_SIZE, SEED + 5,
        lambda n: n.endswith("BatchNorm_2.scale"))


def _card_vs_cpu(label, make, n_images, size, seed, small_scale):
    """The card against the CPU on one train-mode forward and backward of
    ``make(dtype, device)`` (see :func:`phase_resnet_cpu`): the parameters
    named by ``small_scale`` drawn from U(0.05, 0.15), ``n_images`` random
    ``size`` x ``size`` images with random labels, f32 (TF32 off) and
    bf16, the floor from inputs moved by 1e-6, the same limits."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(n_images, size, size, 3, generator=gen)
    moved = images * (1 + 1e-6 * torch.randn(images.shape, generator=gen))
    labels = torch.randint(0, 1000, (n_images,), generator=gen)
    state = None
    errs, floor, cpu_s = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        got = {}
        for device, x in (("cpu", images), ("cpu moved", moved),
                          ("cuda", images)):
            model = make(dtype, device.split()[0])
            if state is None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        if small_scale(n):
                            p.uniform_(0.05, 0.15, generator=gen)
                state = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            t0 = time.perf_counter()
            got[device] = _resnet_pass(model, x.to(device.split()[0]),
                                       labels.to(device.split()[0]))
            if device == "cpu":
                cpu_s[dtype] = time.perf_counter() - t0
            del model
        errs[dtype] = _resnet_errs(got["cuda"], got["cpu"])
        floor[dtype] = _resnet_errs(got["cpu moved"], got["cpu"])
    f32, bf16 = errs[torch.float32], errs[torch.bfloat16]
    worst = max(f32, key=f32.get)
    for dtype, e in errs.items():
        w = max(e, key=e.get)
        fl = floor[dtype]
        print(f"{label} card vs CPU, {str(dtype)[6:]} ({n_images} "
              f"images, {len(e) - 1} tensors): loss {e['loss']:.2e}, "
              f"logits {e['logits']:.2e}, all gradients "
              f"{e['all gradients']:.2e}, worst {w} {e[w]:.2e}; CPU vs "
              f"CPU on inputs moved by 1e-6: logits {fl['logits']:.2e}, "
              f"all gradients {fl['all gradients']:.2e}, worst "
              f"{max(fl.values()):.2e}")
    print(f"{label} card vs CPU: one CPU pass {cpu_s[torch.float32]:.1f} "
          f"s; held: f32 loss and logits within {TOL_RESNET_FWD}, all "
          f"gradients within {TOL_RESNET_GRADS}, every tensor within "
          f"{TOL_RESNET_TENSOR}; bf16 loss and logits within "
          f"{TOL_RESNET_BF16}")
    for key, tol in (("loss", TOL_RESNET_FWD), ("logits", TOL_RESNET_FWD),
                     ("all gradients", TOL_RESNET_GRADS),
                     (worst, TOL_RESNET_TENSOR)):
        _check(f32[key] <= tol,
               f"{label}: f32 card vs CPU, {key} {f32[key]} > {tol}")
    for key in ("loss", "logits"):
        _check(bf16[key] <= TOL_RESNET_BF16,
               f"{label}: bf16 card vs CPU, {key} {bf16[key]} > "
               f"{TOL_RESNET_BF16}")


def _resnet_errs(got: dict, want: dict) -> dict:
    """Relative Frobenius error of every tensor of ``_resnet_pass``, and
    of all the gradients together."""
    errs = {k: _rel_fro(got[k], want[k]) for k in want}
    grads = [k for k in want if k.startswith("grad ")]
    errs["all gradients"] = _rel_fro(
        torch.cat([got[k].reshape(-1) for k in grads]),
        torch.cat([want[k].reshape(-1) for k in grads]))
    return errs


def phase_resnet():
    """The ResNet-50 leg at full width: the first step's BatchNorm
    statistics against a direct computation, 1 warm-up call and 3 timed
    calls of 5 steps, an eval step, two profiled steps."""
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.spmd import make_eval_step, make_train_step
    torch.cuda.reset_peak_memory_stats()
    model = ResNet50(num_classes=1000, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    images = torch.randn(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3,
                         generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.zeros(RESNET_BATCH, dtype=torch.long, device="cuda")
    # The bench stacks one batch steps_per_call times (bench.py:232-234).
    stacked = (images.expand(RESNET_SPC, *images.shape),
               labels.expand(RESNET_SPC, *labels.shape))
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    one = make_train_step(model, _resnet_loss, opt, sync_aux_state=True)
    call = make_train_step(model, _resnet_loss, opt, sync_aux_state=True,
                           steps_per_call=RESNET_SPC)
    with torch.no_grad():
        y = model.conv_init(images.permute(0, 3, 1, 2)).float()
        want_mean = 0.1 * y.mean(dim=(0, 2, 3))
        want_var = 0.9 + 0.1 * y.var(dim=(0, 2, 3), unbiased=False)
        del y
    _cuda.reset_launches()
    first = one((images, labels)).item()
    bn = model.bn_init
    errs = (_rel_fro(bn.mean, want_mean), _rel_fro(bn.var, want_var))
    print(f"resnet50: first step loss {first:.4f}; bn_init running mean "
          f"and var against 0.1 x the batch's (and 0.9 + 0.1 x): "
          f"{errs[0]:.2e}, {errs[1]:.2e} relative")
    _check(max(errs) <= TOL_BN_STATS,
           f"resnet50: bn_init statistics {errs} > {TOL_BN_STATS}")
    losses, times = [first], []
    for i in range(1 + RESNET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = call(stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(_cuda.LAUNCHES)
    call_s = statistics.median(times[1:])
    step_s = call_s / RESNET_SPC
    images_s = RESNET_BATCH / step_s
    mfu = RESNET_FLOPS_PER_IMAGE * images_s / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"resnet50: batch {RESNET_BATCH} x {RESNET_SIZE}^2 bf16, "
          f"steps_per_call {RESNET_SPC}, losses (first step, then the mean "
          f"of each call) " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"resnet50: {images_s:.1f} images/s per GPU, {step_s * 1e3:.2f} ms "
          f"per step (median of {RESNET_TIMED} calls; calls "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms, the first "
          f"a warm-up), MFU {mfu:.4f} (3 x 4.1e9 per image at 989 "
          f"TFLOP/s), peak memory {peak_gb:.2f} GiB, port kernels "
          f"launched {sum(launches.values())}")
    print(f"resnet50: after the timed calls, SM clock, power, "
          f"temperature: {_clocks()}")
    _check(all(math.isfinite(x) for x in losses), "resnet50: non-finite loss")
    _check(losses[-1] < losses[0],
           f"resnet50: loss did not fall: {losses[0]} -> {losses[-1]}")
    # The leg runs no Pallas kernel in the JAX package either.
    _check(not any(launches.values()),
           f"resnet50: port kernels launched: {launches}")
    logits = make_eval_step(model, lambda m, b: m(b))(images)
    _check(tuple(logits.shape) == (RESNET_BATCH, 1000)
           and bool(torch.isfinite(logits).all()),
           f"resnet50: eval logits {tuple(logits.shape)} not finite")
    print(f"resnet50: eval step on the running statistics: logits "
          f"{tuple(logits.shape)}, finite, mean {logits.mean().item():.4f}")
    # One profiled step's busy share varies from profile to profile at
    # the same kernel time (0.80-0.955 on an H100, PERF.md §5): two.
    for _ in range(2):
        _profile_step(one, (images, labels), _resnet_category)
    return {"images_s": images_s, "step_s": step_s, "mfu": mfu,
            "peak_gb": peak_gb}


# The image leg's other two models (bench.py:159-210): InceptionV3 in bf16
# at batch 32 of 299 x 299, VGG16 in bf16 at batch 64 of 224 x 224, zero
# labels, SGD lr 0.01 momentum 0.9, steps_per_call 5; sync_aux_state for
# InceptionV3 only (VGG16 has no buffers, bench.py:229).
ZOO = {
    "inception_v3": dict(batch=32, size=299, sync_aux_state=True),
    "vgg16": dict(batch=64, size=224, sync_aux_state=False),
}
INCEPTION_CHECK, VGG_CHECK = 4, 2      # images of the card-vs-CPU checks
# Kernels cuDNN runs to change a tensor's layout: none of them should run
# while every layer keeps channels_last.
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "transpose")


def _zoo_model(name, dtype=torch.bfloat16, device="cuda"):
    from horovod_tpu_torch.models import VGG16, InceptionV3
    if name == "inception_v3":
        return InceptionV3(num_classes=1000, dtype=dtype, seed=SEED,
                           device=device)
    return VGG16(num_classes=1000, dtype=dtype, seed=SEED, device=device,
                 image_size=ZOO["vgg16"]["size"])


def phase_vgg16_cpu():
    """VGG16 at full width on the card against the CPU (in phase 30), as
    phase 15 holds ResNet-50, on ``VGG_CHECK`` images of 224 x 224: this
    holds ``fc1``'s flatten order at the real width."""
    t0 = time.perf_counter()
    _card_vs_cpu("vgg16", lambda dtype, device: _zoo_model("vgg16", dtype,
                                                           device),
                 VGG_CHECK, ZOO["vgg16"]["size"], SEED + 7, lambda p: False)
    print(f"vgg16 card vs CPU: {time.perf_counter() - t0:.1f} s")


# InceptionV3's top-level units, in the order its forward runs them.
INCEPTION_UNITS = (
    ["ConvBN_%d" % i for i in range(5)]
    + ["InceptionA_%d" % i for i in range(3)] + ["InceptionB_0"]
    + ["InceptionC_%d" % i for i in range(4)] + ["InceptionD_0"]
    + ["InceptionE_0", "InceptionE_1", "head"])
# A unit's cotangent is zero where the CPU's output lies within this of
# the ReLU's kink: an output that rounds to the other side of 0 on one
# device would move every gradient below it (tests/test_torch_models_zoo).
KINK = 1e-4


def _inception_unit(model, name):
    """A copy of ``model``'s unit ``name`` and the function it computes in
    the forward from the previous unit's output (the stem's pools before
    ``ConvBN_3`` and ``InceptionA_0``, the spatial mean before the
    head)."""
    import copy
    from horovod_tpu_torch.models.resnet import max_pool
    unit = copy.deepcopy(getattr(model, name))
    if name in ("ConvBN_3", "InceptionA_0"):
        return unit, lambda x: unit(max_pool(x, (3, 3), (2, 2)))
    if name == "head":
        return unit, lambda x: unit(x.float().mean(dim=(2, 3)).to(
            model.dtype))
    return unit, unit


def _unit_pass(model, name, x, g) -> dict:
    """One train-mode forward and backward of ``model``'s unit ``name``
    (a copy) on ``x`` under the cotangent ``g``: output, input gradient,
    every parameter's gradient and every buffer after the forward, as f64
    on the CPU."""
    unit, fn = _inception_unit(model, name)
    x = x.detach().clone().requires_grad_()
    y = fn(x)
    y.backward(g.to(y.dtype))
    out = {"output": y.detach(), "input gradient": x.grad}
    out.update({"grad " + n: p.grad for n, p in unit.named_parameters()})
    out.update({"buffer " + n: b for n, b in unit.named_buffers()})
    return {k: v.detach().double().cpu() for k, v in out.items()}


def phase_inception_cpu():
    """Phase 29: InceptionV3 at full width on the card against the CPU on
    ``INCEPTION_CHECK`` images of 299 x 299, every BatchNorm scale drawn
    from U(0.05, 0.15).  The whole model in train mode is chaotic at
    this batch (on an H100 80GB HBM3 host, the CPU against itself on
    inputs moved by 1e-6 moved the f32 gradients by 5.1e-2 together and
    the bf16 logits by 1.3e-1, above phase 15's limits; PERF.md), so the
    train-mode forward and backward is held unit by unit: each of the 17
    units (stem ConvBN, blocks, head, each with the pool or mean before
    it) on the CPU's own f32 input to it, with a seeded cotangent, in f32
    (TF32 off) and bf16, with phase 15's limits (f32: each output within
    ``TOL_RESNET_FWD``, all gradients together within
    ``TOL_RESNET_GRADS``, every gradient, input gradient and new buffer
    within ``TOL_RESNET_TENSOR``; bf16: each output within
    ``TOL_RESNET_BF16``); the floor from inputs moved by 1e-6 printed.
    The whole model's eval-mode logits within ``TOL_RESNET_FWD`` (f32)
    and ``TOL_RESNET_BF16`` (bf16), with the BatchNorm scales drawn from
    U(0.5, 1.5) for that check (scales of 0.1 on the running statistics
    at init shrink the activations to 0 before the head); its train-mode
    loss and logits are printed beside their floor."""
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 6)
    size = ZOO["inception_v3"]["size"]
    images = torch.randn(INCEPTION_CHECK, size, size, 3, generator=gen)
    labels = torch.randint(0, 1000, (INCEPTION_CHECK,), generator=gen)
    cpu = _zoo_model("inception_v3", torch.float32, "cpu")
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("BatchNorm_0.scale"):
                p.uniform_(0.05, 0.15, generator=gen)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    eval_state = {k: (torch.rand(v.shape, generator=gen) + 0.5
                      if k.endswith("BatchNorm_0.scale") else v)
                  for k, v in state.items()}
    # Each unit's input in the CPU's f32 train-mode forward: the previous
    # unit's output.
    inputs, hooks = {"ConvBN_0": images.permute(0, 3, 1, 2)}, []
    for prev, n in zip(INCEPTION_UNITS, INCEPTION_UNITS[1:]):
        hooks.append(getattr(cpu, prev).register_forward_hook(
            lambda m, a, out, n=n: inputs.__setitem__(n, out.detach())))
    with torch.no_grad():
        cpu(images)
    for h in hooks:
        h.remove()
    errs, floor, whole = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        models = {}
        for device in ("cpu", "cuda"):
            models[device] = _zoo_model("inception_v3", dtype, device)
            models[device].load_state_dict(state)
        e, f = {}, {}
        for n in INCEPTION_UNITS:
            x = inputs[n].to(dtype)
            moved = x * (1 + 1e-6 * torch.randn(x.shape, generator=gen,
                                                 dtype=torch.float32)
                         ).to(dtype)
            with torch.no_grad():
                ref = _inception_unit(models["cpu"], n)[1](x).float()
            g = torch.randn(ref.shape, generator=gen)
            g[ref.abs() < KINK] = 0.0
            g = g.to(memory_format=torch.channels_last) if g.dim() == 4 \
                else g
            got = {}
            for label, dev, xin in (("cpu", "cpu", x),
                                    ("cpu moved", "cpu", moved),
                                    ("cuda", "cuda", x)):
                got[label] = _unit_pass(models[dev], n, xin.to(dev),
                                        g.to(dev))
            for k in got["cpu"]:
                e[f"{n} {k}"] = _rel_fro(got["cuda"][k], got["cpu"][k])
                f[f"{n} {k}"] = _rel_fro(got["cpu moved"][k], got["cpu"][k])
            grads = [k for k in got["cpu"] if k.startswith("grad ")]
            for d, src in ((e, "cuda"), (f, "cpu moved")):
                d.setdefault("_grads", []).append(
                    (torch.cat([got[src][k].reshape(-1) for k in grads]),
                     torch.cat([got["cpu"][k].reshape(-1) for k in grads])))
        for d in (e, f):
            pairs = d.pop("_grads")
            d["all gradients"] = _rel_fro(torch.cat([a for a, _ in pairs]),
                                          torch.cat([b for _, b in pairs]))
        errs[dtype], floor[dtype] = e, f
        # The whole model: eval-mode logits, train-mode loss and logits.
        out = {}
        for device in ("cpu", "cuda"):
            m = models[device]
            with torch.no_grad():
                m.load_state_dict(eval_state)
                m.eval()
                ev = m(images.to(device)).double().cpu()
                m.load_state_dict(state)
                m.train()
                tr = m(images.to(device)).double().cpu()
            out[device] = (ev, tr, torch.nn.functional.cross_entropy(
                tr, labels).reshape(1))
        whole[dtype] = tuple(_rel_fro(a, b) for a, b in zip(out["cuda"],
                                                             out["cpu"]))
        del models
    for dtype in (torch.float32, torch.bfloat16):
        e, f = errs[dtype], floor[dtype]
        outs = {k: v for k, v in e.items() if k.endswith(" output")}
        wo, wt = max(outs, key=outs.get), max(e, key=e.get)
        ev, tr, loss = whole[dtype]
        print(f"inception_v3 card vs CPU, {str(dtype)[6:]}, unit by unit "
              f"({len(INCEPTION_UNITS)} units, {len(e) - 1} tensors): "
              f"worst output {wo} {outs[wo]:.2e}, all gradients "
              f"{e['all gradients']:.2e}, worst tensor {wt} {e[wt]:.2e}; "
              f"CPU vs CPU on inputs moved by 1e-6: all gradients "
              f"{f['all gradients']:.2e}, worst {max(f.values()):.2e}; "
              f"whole model: eval logits {ev:.2e}, train logits {tr:.2e} "
              f"and loss {loss:.2e} (not held: chaotic at this batch)")
    f32, bf16 = errs[torch.float32], errs[torch.bfloat16]
    print(f"inception_v3 card vs CPU: held: f32 unit outputs and eval "
          f"logits within {TOL_RESNET_FWD}, all unit gradients within "
          f"{TOL_RESNET_GRADS}, every tensor within {TOL_RESNET_TENSOR}; "
          f"bf16 unit outputs and eval logits within {TOL_RESNET_BF16}; "
          f"phase {time.perf_counter() - t_start:.1f} s")
    for key, v in f32.items():
        tol = (TOL_RESNET_FWD if key.endswith(" output")
               else TOL_RESNET_GRADS if key == "all gradients"
               else TOL_RESNET_TENSOR)
        _check(v <= tol, f"inception_v3: f32 card vs CPU, {key} {v} > {tol}")
    for key, v in bf16.items():
        if key.endswith(" output"):
            _check(v <= TOL_RESNET_BF16, f"inception_v3: bf16 card vs CPU, "
                   f"{key} {v} > {TOL_RESNET_BF16}")
    _check(whole[torch.float32][0] <= TOL_RESNET_FWD,
           f"inception_v3: f32 eval logits {whole[torch.float32][0]}")
    _check(whole[torch.bfloat16][0] <= TOL_RESNET_BF16,
           f"inception_v3: bf16 eval logits {whole[torch.bfloat16][0]}")


def _channels_last_outputs(model, size) -> list:
    """The modules whose 4-D output is not in channels_last memory, from
    one eval forward of two images on the card."""
    bad, hooks = [], []
    for n, m in model.named_modules():
        hooks.append(m.register_forward_hook(
            lambda m, a, out, n=n: bad.append(n) if (
                torch.is_tensor(out) and out.dim() == 4
                and not out.is_contiguous(
                    memory_format=torch.channels_last)) else None))
    model.eval()
    with torch.no_grad():
        model(torch.randn(2, size, size, 3, device="cuda"))
    model.train()
    for h in hooks:
        h.remove()
    return bad


def _step_flops(step, batch) -> int:
    """FLOPs of one training step as ``FlopCounterMode`` counts them (two a
    multiply-add, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        step(batch)
    return counter.get_total_flops()


def phase_zoo_train(name: str) -> dict:
    """Phase 30: ``name`` at the bench's full width (``ZOO``): channels_last
    kept by every layer; for InceptionV3 the first step's ``ConvBN_0``
    running statistics against a direct computation; 1 warm-up call and
    3 timed calls of 5 steps, an eval step, a profiled step, the MFU from
    ``FlopCounterMode``; no port kernel launched."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.spmd import make_eval_step, make_train_step
    cfg = ZOO[name]
    batch, size = cfg["batch"], cfg["size"]
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = _zoo_model(name)
    bad = _channels_last_outputs(model, size)
    print(f"{name}: modules whose output left channels_last: {bad}")
    _check(not bad, f"{name}: outputs not channels_last: {bad[:5]}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    images = torch.randn(batch, size, size, 3, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.zeros(batch, dtype=torch.long, device="cuda")
    stacked = (images.expand(RESNET_SPC, *images.shape),
               labels.expand(RESNET_SPC, *labels.shape))
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    sync = cfg["sync_aux_state"]
    one = make_train_step(model, _resnet_loss, opt, sync_aux_state=sync)
    call = make_train_step(model, _resnet_loss, opt, sync_aux_state=sync,
                           steps_per_call=RESNET_SPC)
    want = None
    if name == "inception_v3":
        with torch.no_grad():
            y = model.ConvBN_0.Conv_0(images.permute(0, 3, 1, 2)).float()
            want = (0.1 * y.mean(dim=(0, 2, 3)),
                    0.9 + 0.1 * y.var(dim=(0, 2, 3), unbiased=False))
            del y
    _cuda.reset_launches()
    first = one((images, labels)).item()
    if want is not None:
        bn = model.ConvBN_0.BatchNorm_0
        errs = (_rel_fro(bn.mean, want[0]), _rel_fro(bn.var, want[1]))
        print(f"{name}: first step loss {first:.4f}; ConvBN_0 running mean "
              f"and var against 0.1 x the batch's (and 0.9 + 0.1 x): "
              f"{errs[0]:.2e}, {errs[1]:.2e} relative")
        _check(max(errs) <= TOL_BN_STATS,
               f"{name}: ConvBN_0 statistics {errs} > {TOL_BN_STATS}")
    losses, times = [first], []
    for _ in range(1 + RESNET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = call(stacked)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(_cuda.LAUNCHES)
    step_s = statistics.median(times[1:]) / RESNET_SPC
    images_s = batch / step_s
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = _step_flops(one, (images, labels))
    mfu = flops / step_s / PEAK_BF16_FLOPS
    print(f"{name}: batch {batch} x {size}^2 bf16, steps_per_call "
          f"{RESNET_SPC}, losses (first step, then the mean of each call) "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"{name}: {images_s:.1f} images/s per GPU, {step_s * 1e3:.2f} ms "
          f"per step (median of {RESNET_TIMED} calls; calls "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms, the first "
          f"a warm-up), {flops / 1e9:.1f} GFLOP a step (FlopCounterMode, "
          f"2 a multiply-add), MFU {mfu:.4f} at 989 TFLOP/s (phase 16's "
          f"ResNet-50 MFU counts multiply-adds, bench.py:270-281, so the "
          f"two differ by that factor 2), peak memory {peak_gb:.2f} GiB, "
          f"port kernels launched {sum(launches.values())}")
    print(f"{name}: after the timed calls, SM clock, power, temperature: "
          f"{_clocks()}")
    _check(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss")
    _check(losses[-1] < losses[0],
           f"{name}: loss did not fall: {losses[0]} -> {losses[-1]}")
    # The leg runs no Pallas kernel in the JAX package either.
    _check(not any(launches.values()),
           f"{name}: port kernels launched: {launches}")
    logits = make_eval_step(model, lambda m, b: m(b))(images)
    _check(tuple(logits.shape) == (batch, 1000)
           and bool(torch.isfinite(logits).all()),
           f"{name}: eval logits {tuple(logits.shape)} not finite")
    print(f"{name}: eval step on the running statistics: logits "
          f"{tuple(logits.shape)}, finite, mean {logits.mean().item():.4f}")
    kernels = []
    _profile_step(one, (images, labels), _resnet_category, kernels=kernels)
    layout = [(k, ms, n) for k, ms, n in kernels
              if any(t in k for t in LAYOUT_KERNELS)]
    print(f"{name}: layout-conversion kernels in the profiled step: "
          f"{sum(n for _, _, n in layout)} launches, "
          f"{sum(ms for _, ms, _ in layout):.2f} ms"
          + "".join(f"; {ms:.2f} ms x{n} {k[:60]}" for k, ms, n in layout))
    print(f"{name}: phase {time.perf_counter() - t_start:.1f} s")
    return {"images_s": images_s, "step_s": step_s, "mfu": mfu,
            "peak_gb": peak_gb, "flops": flops}


HIER_HOSTS = ("A", "A", "B", "B")
# int8 on the mesh against the flat sum of the same snapped leaves: the
# two-tier path sums the bf16 wire in another order than the flat
# all_reduce of f32, a few bf16 roundings (2^-8) apart.
TOL_HIER_INT8 = 1e-2


def _hier_worker(rank: int, port: int, results) -> None:
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_HOST_FINGERPRINT": HIER_HOSTS[rank]})
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import ResNet
        from horovod_tpu_torch.ops import _cuda, injit
        from horovod_tpu_torch.parallel.hierarchical import (
            hierarchical_allreduce)
        from horovod_tpu_torch.spmd import make_train_step, reduce_gradients
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        mesh = hvd.hierarchical_mesh()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + rank)
        x = torch.randint(-1000, 1000, (RING_N + 3,), generator=gen,
                          device="cuda").float()
        same = _bits_equal(hierarchical_allreduce(x, mesh=mesh),
                           injit.allreduce(x, average=False))
        # int8 on the two-tier path: eligible leaves snapped through P4/P5,
        # reduced in bf16 over the mesh, against the plain snap.
        grads = [torch.randn(1024, 1024, generator=gen, device="cuda"),
                 torch.randn(301, generator=gen, device="cuda")]
        _cuda.reset_launches()
        got = reduce_gradients(grads, compression="int8", mesh=mesh)
        torch.cuda.synchronize()
        codec = {k: _cuda.LAUNCHES[k]
                 for k in ("int8_quantize", "int8_dequantize")}
        wire = [_snap_plain(grads[0]).to(torch.bfloat16),
                grads[1].to(torch.float32)]
        int8_same = all(_bits_equal(g, hierarchical_allreduce(
            w, average=True, mesh=mesh).to(g.dtype))
            for g, w in zip(got, wire))
        flat = [injit.allreduce(w.float(), average=True) for w in wire]
        int8_err = max(_rel_fro(g, f) for g, f in zip(got, flat))
        images = torch.randn(2, 8, 32, 32, 3, generator=gen, device="cuda")
        labels = torch.randint(0, 10, (2, 8), generator=gen, device="cuda")
        losses = {}
        for key, m in (("mesh", mesh), ("flat", None)):
            model = ResNet(**SMALL_RESNET, seed=SEED, device="cuda")
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            step = make_train_step(model, _resnet_loss, opt, mesh=m)
            losses[key] = [step((images[i], labels[i])).item()
                           for i in range(2)]
        torch.cuda.synchronize()
        hvd.shutdown()
        results.put((rank, {"grid": mesh.grid, "same": same,
                            "int8_same": int8_same, "int8_err": int8_err,
                            "codec": codec, "losses": losses}))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_hierarchical_nccl():
    """Four processes, one card each, on two fake hosts (A, A, B, B):
    the two-tier allreduce of integer-valued f32 against the flat
    all_reduce, bit for bit; ``reduce_gradients(compression="int8",
    mesh=)`` against the plain snap reduced over the mesh (bit for bit)
    and over the flat group; and two small-ResNet steps on the mesh
    against the flat step."""
    if torch.cuda.device_count() < 4:
        print("hierarchical nccl: not run (it needs four CUDA devices, "
              f"this machine has {torch.cuda.device_count()})")
        return
    got = _spawn(_hier_worker, 4)
    print(f"hierarchical nccl: 4 processes on hosts {HIER_HOSTS}: {got}")
    _check(all(isinstance(got.get(r), dict) for r in range(4)),
           f"hierarchical nccl failed: {got}")
    for r in range(4):
        out = got[r]
        _check(out["grid"] == ((0, 1), (2, 3)), f"rank {r}: {out['grid']}")
        _check(out["same"], f"rank {r}: two-tier allreduce differs from "
               f"the flat one")
        _check(out["int8_same"] and min(out["codec"].values()) > 0,
               f"rank {r}: int8 on the mesh differs from the plain snap's "
               f"two-tier reduce, or P4/P5 did not launch: {out['codec']}")
        _check(out["int8_err"] <= TOL_HIER_INT8,
               f"rank {r}: int8 on the mesh vs the flat sum of the plain "
               f"snap {out['int8_err']} > {TOL_HIER_INT8}")
        err = max(abs(a - b) / abs(b) for a, b in
                  zip(out["losses"]["mesh"], out["losses"]["flat"]))
        _check(err <= TOL_SPC, f"rank {r}: mesh step vs flat {err}")


# The eager plane's timing shapes: one 4 KiB allreduce for latency, and a
# burst of 64 float32 tensors of 1 MiB each, which the planner fuses into
# 64 MiB responses (HOROVOD_TPU_FUSION_THRESHOLD's default).
EAGER_SMALL = 1024                       # f32 elements: 4 KiB
EAGER_BURST, EAGER_BURST_N = 64, 1 << 18  # 64 x 1 MiB of f32
EAGER_REPS = 50


def _eager_latency_ms(hvd, device) -> float:
    """Median host time of one synchronous 4 KiB eager allreduce, until
    its result is on the device."""
    x = torch.ones(EAGER_SMALL, device=device)
    times = []
    for i in range(EAGER_REPS + 5):
        t0 = time.perf_counter()
        hvd.allreduce(x, name="eager.small")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[5:])


def _eager_burst(hvd, device, tag: str):
    """The 64 x 1 MiB burst, async: enqueue all, then synchronize all.
    Returns (the inputs, the results, host ms until every result is on the
    device, the cache hits the burst added, host ms of the enqueues alone,
    the control plane's ticks during the enqueues)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    xs = [torch.randint(-8, 8, (EAGER_BURST_N,), generator=gen,
                        device=device).float() for _ in range(EAGER_BURST)]
    torch.cuda.synchronize()
    c0 = hvd.metrics()["counters"]
    t0 = time.perf_counter()
    hs = [hvd.allreduce_async(x, average=False, name=f"{tag}.{i}")
          for i, x in enumerate(xs)]
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ticks = (hvd.metrics()["counters"].get("control.ticks", 0)
             - c0.get("control.ticks", 0))
    outs = [hvd.synchronize(h) for h in hs]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    added = (hvd.metrics()["counters"].get("control.cache_hits", 0)
             - c0.get("control.cache_hits", 0))
    return xs, outs, ms, added, enqueue_ms, ticks


def _eager_small_bursts(hvd, device, rank: int, n: int) -> dict:
    """The reference's cache burst (tests/test_multiprocess.py
    CACHE_BYTES_WORKER) on the card: 16 allreduces of 8 floats enqueued
    together, then synchronized, 31 times.  Returns the cache hits they
    added, the first burst's and the best later burst's control bytes, and
    the ticks the coordinator served from the cache."""
    def counters():
        return hvd.metrics()["counters"]

    def served():
        return hvd.metrics()["histograms"].get(
            "control.tick_seconds#cached=1", {}).get("count", 0)

    c0, s0 = counters(), served()
    per_burst = []
    for _ in range(31):
        b0 = counters().get("control.negotiation_bytes", 0)
        hs = [hvd.allreduce_async(torch.full((8,), float(rank + 1),
                                             device=device),
                                  average=False, name=f"nc.cache.{j:02d}")
              for j in range(16)]
        for h in hs:
            _check(hvd.synchronize(h).tolist() == [n * (n + 1) / 2] * 8,
                   "eager nccl: a cache burst's sum is wrong")
        per_burst.append(counters().get("control.negotiation_bytes", 0)
                         - b0)
    return {"hits": counters().get("control.cache_hits", 0)
            - c0.get("control.cache_hits", 0),
            "first_bytes": per_burst[0], "best_bytes": min(per_burst[6:]),
            "served_ticks": served() - s0}


def _library_allreduce_ms(buf) -> float:
    """Median host time of one dist.all_reduce of ``buf`` until it is
    done on the device (the library yardstick of the burst)."""
    import torch.distributed as dist
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def phase_eager():
    """The negotiated eager plane at size 1 on the card: allreduce (sum
    and average), allgather and broadcast of CUDA f32, bf16 and int64
    tensors, async with poll and synchronize, results on the card and
    equal to what one rank gives (the input; integers floor-divided);
    then the latency of one 4 KiB allreduce, and the 64 x 1 MiB burst
    three times, fused (hvd.metrics()'s ops and fill ratio) and served
    from the response cache from the second burst on, timed beside one
    dist.all_reduce of the same 64 MiB on a one-rank NCCL group."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    ok = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = (torch.arange(24, device=dev) - 7).reshape(4, 6).to(dtype)
        hs = [hvd.allreduce_async(x, average=False, name=f"e.sum.{dtype}"),
              hvd.allreduce_async(x, average=True, name=f"e.avg.{dtype}"),
              hvd.allgather_async(x, name=f"e.ag.{dtype}"),
              hvd.broadcast_async(x, 0, name=f"e.bc.{dtype}")]
        while not all(hvd.poll(h) for h in hs):
            time.sleep(1e-4)
        outs = [hvd.synchronize(h) for h in hs]
        ok[str(dtype)] = all(o.is_cuda and o.dtype == dtype
                             and _bits_equal(o, x) for o in outs)
    print(f"eager (size 1): allreduce sum/average, allgather, broadcast "
          f"on the card, async, equal to the input: {ok}")
    _check(all(ok.values()), f"eager at size 1: {ok}")
    lat = _eager_latency_ms(hvd, dev)
    c0 = hvd.metrics()
    bursts = [_eager_burst(hvd, dev, "burst") for _ in range(3)]
    c1 = hvd.metrics()
    ops = (c1["counters"]["controller.ops#type=allreduce"]
           - c0["counters"].get("controller.ops#type=allreduce", 0))
    fill = c1["histograms"]["controller.fusion_fill_ratio"]
    for xs, outs, *_ in bursts:
        _check(all(_bits_equal(o, x) for o, x in zip(outs, xs)),
               "eager burst: a result differs from its input")
    hits = [b[3] for b in bursts]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        buf = torch.cat(bursts[-1][0])
        lib_ms = _library_allreduce_ms(buf)
    finally:
        dist.destroy_process_group()
    times = [b[2] for b in bursts]
    print(f"eager (size 1): 4 KiB allreduce {lat:.3f} ms (median of "
          f"{EAGER_REPS}, host clock to the result on the card); burst "
          f"{EAGER_BURST} x 1 MiB f32: {[round(t, 3) for t in times]} ms "
          f"in 3 bursts, {ops} allreduce responses, fill ratio histogram "
          f"count {fill['count']} sum {fill['sum']:.3f}; cache hits per "
          f"burst {hits}; one dist.all_reduce of the 64 MiB on a one-rank "
          f"NCCL group {lib_ms:.3f} ms")
    _check(sum(hits[1:]) > 0, f"eager burst: no cache hit: {hits}")
    _check(ops <= 3 * EAGER_BURST, f"eager burst: {ops} responses")
    return {"latency_ms": lat, "burst_ms": times, "library_ms": lib_ms,
            "cache_hits": hits, "responses": ops}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _eager_nccl_worker(rank: int, port: int, results) -> None:
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{port + 1}"})
        os.environ.pop("HOROVOD_TPU_LOCAL_RANK", None)
        import torch.distributed as dist
        import horovod_tpu_torch as hvd
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        dev = torch.device("cuda", torch.cuda.current_device())
        out = {"local_rank": hvd.local_rank(), "device": dev.index}
        ctrl = hvd.controller()
        gen = torch.Generator(device=dev).manual_seed(SEED + 20 + rank)
        # Allreduce, fused: each fused response against dist.all_reduce of
        # the same concatenated buffer, bit for bit.
        xs = {f"nc.{i}": torch.randn(1000 + 37 * i, generator=gen,
                                     device=dev) for i in range(6)}
        xs["nc.bf16"] = torch.randn(333, generator=gen,
                                    device=dev).bfloat16()
        xs["nc.int64"] = torch.randint(-1000, 1000, (77,), generator=gen,
                                       device=dev)
        hs = {n: hvd.allreduce_async(x, average=False, name=n)
              for n, x in xs.items()}
        got = {n: hvd.synchronize(h) for n, h in hs.items()}
        same = True
        for names in ctrl._executor.recent_fusions:
            buf = torch.cat([xs[n].reshape(-1) for n in names])
            dist.all_reduce(buf)
            off = 0
            for n in names:
                k = xs[n].numel()
                same &= _bits_equal(got[n], buf[off:off + k])
                off += k
        out["fusions"] = [len(f) for f in ctrl._executor.recent_fusions]
        out["allreduce_same"] = same
        avg = hvd.allreduce(torch.full((5,), rank + 1, device=dev,
                                       dtype=torch.int64), name="nc.avg")
        out["int_avg"] = avg.tolist()
        # Ragged allgather and broadcast.
        g = hvd.allgather(torch.full((rank + 1, 3), float(rank), device=dev),
                          name="nc.gather")
        out["gather"] = g[:, 0].tolist()
        b = hvd.broadcast(torch.full((4,), float(rank), device=dev), 2,
                          name="nc.bcast")
        out["bcast"] = b.tolist()
        # The coordinated mismatch error, on every rank.
        bad = torch.zeros(2, device=dev,
                          dtype=torch.int32 if rank == 0 else torch.float32)
        try:
            hvd.allreduce(bad, name="nc.bad")
            out["mismatch"] = None
        except hvd.CollectiveError as e:
            out["mismatch"] = str(e)
        out["latency_ms"] = _eager_latency_ms(hvd, dev)
        out["small"] = _eager_small_bursts(hvd, dev, rank, 4)
        bursts = [_eager_burst(hvd, dev, "nc.burst") for _ in range(3)]
        out["burst_ms"] = [b[2] for b in bursts]
        out["cache_hits"] = [b[3] for b in bursts]
        out["enqueue_ms"] = [b[4] for b in bursts]
        out["enqueue_ticks"] = [b[5] for b in bursts]
        xs_b, outs_b = bursts[-1][0], bursts[-1][1]
        buf = torch.cat(xs_b)
        ref = buf.clone()
        dist.all_reduce(ref)
        out["burst_same"] = _bits_equal(torch.cat(outs_b), ref)
        out["library_ms"] = _library_allreduce_ms(buf)
        torch.cuda.synchronize()
        hvd.shutdown()
        results.put((rank, out))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_eager_nccl():
    """The eager plane on four cards, one process each, launched without
    HOROVOD_TPU_LOCAL_RANK: host discovery must give four distinct GPUs.
    Each fused allreduce (f32, bf16, int64) equals dist.all_reduce of the
    same fused buffer bit for bit; the integer average floor-divides; a
    ragged allgather and a broadcast from rank 2 are exact; a dtype
    mismatch raises the coordinator's error on every rank; then the 4 KiB
    latency; the reference's cache burst (16 x 8 floats, 31 times) must
    get cache hits; then the 64 x 1 MiB burst beside one dist.all_reduce
    of the same 64 MiB, with the native cache's hits a burst, the host
    time of its 64 enqueues and the ticks they spanned (hits printed, not
    required: a name is given a cache slot only in a tick that carries
    every rank's request for it, and enqueues that span ticks from
    start times that differ across processes split the burst
    differently; the coordinator then negotiates in full, as the
    reference's does)."""
    if torch.cuda.device_count() < 4:
        print("eager nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    got = _spawn(_eager_nccl_worker, 4)
    _check(all(isinstance(got.get(r), dict) for r in range(4)),
           f"eager nccl failed: {got}")
    for r in range(4):
        o = got[r]
        print(f"eager nccl rank {r}: local_rank {o['local_rank']} on "
              f"cuda:{o['device']}, fusions {o['fusions']}, allreduce vs "
              f"dist.all_reduce bit-identical {o['allreduce_same']}, burst "
              f"{o['burst_same']}; 4 KiB allreduce {o['latency_ms']:.3f} ms;"
              f" burst {[round(t, 3) for t in o['burst_ms']]} ms, cache hits "
              f"{o['cache_hits']}, its enqueues "
              f"{[round(t, 3) for t in o['enqueue_ms']]} ms over "
              f"{o['enqueue_ticks']} ticks; dist.all_reduce of 64 MiB "
              f"{o['library_ms']:.3f} ms; reference cache burst: "
              f"{o['small']}")
        _check(o["small"]["hits"] > 0,
               f"rank {r}: the cache burst got no cache hit: {o['small']}")
        _check(o["allreduce_same"] and o["burst_same"],
               f"rank {r}: eager allreduce differs from dist.all_reduce")
        _check(o["int_avg"] == [(1 + 2 + 3 + 4) // 4] * 5,
               f"rank {r}: integer average {o['int_avg']}")
        _check(o["gather"] == [float(q) for q in range(4)
                               for _ in range(q + 1)],
               f"rank {r}: allgather {o['gather']}")
        _check(o["bcast"] == [2.0] * 4, f"rank {r}: broadcast {o['bcast']}")
        _check(o["mismatch"] == got[0]["mismatch"] and o["mismatch"]
               and o["mismatch"].startswith("Mismatched data types"),
               f"rank {r}: mismatch error {o['mismatch']!r}")
    devices = sorted(got[r]["device"] for r in range(4))
    _check(devices == [0, 1, 2, 3] and all(
        got[r]["local_rank"] == got[r]["device"] for r in range(4)),
        f"eager nccl: ranks share GPUs: {devices}")
    return got


# Phase 20's three runs: label, overlap, int8 with error feedback.
EAGER_RUNS = (("eager", False, False), ("eager overlap", True, False),
              ("eager int8", True, True))
# Every eager loss against phase 7's (phase 12's for int8), relative, if
# it is not bit-identical: the eager route copies the gradients through
# the plane, and at size 1 divides them by 1.
TOL_EAGER = 1e-6


def _hist_delta(c0: dict, c1: dict, name: str):
    """(count, sum) a histogram gained between two snapshots."""
    h0 = c0["histograms"].get(name, {"count": 0, "sum": 0.0})
    h1 = c1["histograms"].get(name, {"count": 0, "sum": 0.0})
    return h1["count"] - h0["count"], h1["sum"] - h0["sum"]


def _eager_plane_per_step(c0: dict, c1: dict, steps: int) -> dict:
    """The eager plane's records over ``steps`` steps: responses, cache
    hits and buckets a step; the overlapped steps' hidden and exposed
    seconds and hidden fraction (means)."""
    out = {k: (c1["counters"].get(name, 0) - c0["counters"].get(name, 0))
           / steps for k, name in (
        ("responses", "controller.ops#type=allreduce"),
        ("cache_hits", "control.cache_hits"),
        ("buckets", "overlap.buckets"),
        ("overlap_steps", "overlap.steps"))}
    for k in ("hidden_seconds", "exposed_seconds", "hidden_fraction"):
        n, total = _hist_delta(c0, c1, "overlap." + k)
        out[k] = total / n if n else None
    return out


def phase_train_eager(depth: int, plain: dict, int8: dict) -> dict:
    """Phase 7's model through a plain loop with
    ``hvd.DistributedOptimizer(SGD, eager=True)``: overlap off, overlap
    on, and int8 with error feedback under overlap; 2 warm-up and 5 timed
    steps each, counters zeroed just before and read just after."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops import quantized_collectives as qc
    results = {}
    hvd.observe.set_enabled(True)
    try:
        for label, overlap, lossy in EAGER_RUNS:
            _free()
            torch.cuda.reset_peak_memory_stats()
            model, tokens, loss_fn = _train_setup(depth)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                eager=True, overlap=overlap,
                compression=hvd.Compression.int8 if lossy else "none",
                error_feedback=lossy)
            leaves = sum(qc.int8_eligible(p.shape, p.dtype)
                         for p in model.parameters())

            def step(batch):
                opt.zero_grad()
                loss = loss_fn(model, batch)
                loss.backward()
                opt.step()
                return loss.detach()

            # The batches come through the loader: host copies of the
            # tokens, put on the card on its side stream.
            host = tokens.cpu()
            loader = hvd.ShardedLoader(
                lambda: (host for _ in range(WARMUP + TIMED)))
            torch.cuda.synchronize()
            _cuda.reset_launches()
            c0 = hvd.metrics()
            losses, times, same_batch = [], [], True
            for batch in loader:
                same_batch &= torch.equal(batch, tokens)
                t0 = time.perf_counter()
                loss = step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
            launches = dict(_cuda.LAUNCHES)
            _check(same_batch and len(losses) == WARMUP + TIMED,
                   f"{label}: the loader's batches differ from the tokens")
            c1 = hvd.metrics()
            steps = WARMUP + TIMED
            step_s = statistics.median(times[WARMUP:])
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            plane = _eager_plane_per_step(c0, c1, steps)
            want = int8 if lossy else plain
            same = losses == want["losses"]
            track = max(abs(a - b) / abs(b)
                        for a, b in zip(losses, want["losses"]))
            print(f"{label}: depth {depth}, DistributedOptimizer(SGD "
                  f"momentum, eager=True, overlap={overlap}"
                  + (", int8, error feedback" if lossy else "")
                  + "), losses " + ", ".join(f"{x:.4f}" for x in losses))
            print(f"{label}: step {step_s * 1e3:.1f} ms against "
                  f"{plain['step_s'] * 1e3:.1f} ms make_train_step (phase "
                  f"7) (median of {TIMED}; all "
                  + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms), "
                  f"{BATCH * SEQ / step_s:.0f} tokens/s, peak memory "
                  f"{peak_gb:.2f} GiB; losses vs phase "
                  f"{12 if lossy else 7} "
                  f"{'bit-identical' if same else 'DIFFERENT'} "
                  f"({track:.2e} relative at most); per step: "
                  f"{plane['responses']:.1f} eager responses, "
                  f"{plane['cache_hits']:.1f} cache hits, "
                  f"{plane['buckets']:.1f} buckets; overlap: hidden "
                  f"{plane['hidden_seconds']} s, exposed "
                  f"{plane['exposed_seconds']} s, hidden fraction "
                  f"{plane['hidden_fraction']}; launches {launches}")
            _check(all(math.isfinite(x) for x in losses),
                   f"{label}: non-finite loss")
            _check(losses[-1] < losses[0],
                   f"{label}: loss did not fall: {losses}")
            if lossy:
                first = abs(losses[0] - plain["losses"][0]) / abs(
                    plain["losses"][0])
                worst = max(abs(a - b) / abs(b)
                            for a, b in zip(losses, plain["losses"]))
                _check(first <= TOL_FIRST_LOSS and worst <= TOL_LOSS_TRACK,
                       f"{label}: losses {losses} stray from phase 7's "
                       f"{plain['losses']}")
            else:
                _check(track <= TOL_EAGER,
                       f"{label}: losses {losses} stray from phase 7's "
                       f"{plain['losses']}")
            for name in FLASH:
                _check(launches[name] == depth * steps,
                       f"{label}: {name} launched {launches[name]} times, "
                       f"expected {depth * steps}")
            for name in ("int8_quantize", "int8_dequantize"):
                want_n = leaves * steps if lossy else 0
                _check(launches[name] == want_n,
                       f"{label}: {name} launched {launches[name]} times, "
                       f"expected {want_n}")
            _check(plane["responses"] >= 1,
                   f"{label}: the eager plane served no response")
            if overlap:
                _check(plane["overlap_steps"] == 1
                       and plane["hidden_fraction"] is not None,
                       f"{label}: no overlap.* series: {plane}")
            prof = _profile_step(step, tokens)
            results[label] = {"losses": losses, "step_s": step_s,
                              "peak_gb": peak_gb, "plane": plane,
                              "profile": prof, "same": same}
            del model, opt
        view = hvd.observe()
        print(f"eager: hvd.observe() local digest {view['local']}")
        _check(view["enabled"] and view["local"].get("steps", 0) > 0,
               f"eager: hvd.observe() shows no step: {view}")
        hist = hvd.metrics()["histograms"]
        _check(all(hist.get(f"step.{k}", {}).get("count", 0) > 0
                   for k in ("seconds", "compute_seconds",
                             "exposed_comm_seconds")),
               "eager: no step.* histograms in hvd.metrics()")
    finally:
        hvd.observe.set_enabled(False)
    return results


def _eager_train_worker(rank: int, port: int, results) -> None:
    """Phase 21 on one of four cards: the full-width model on this rank's
    own batch, three ways; the exactness and sparse checks."""
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{port + 1}"})
        os.environ.pop("HOROVOD_TPU_LOCAL_RANK", None)
        import torch.distributed as dist
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import injit
        from horovod_tpu_torch.spmd import make_train_step
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        dev = torch.device("cuda", torch.cuda.current_device())
        out = {"device": dev.index}
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + rank)
        tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                               device=dev)
        for label in ("make_train_step", "eager", "eager overlap"):
            _free()
            model, _, loss_fn = _train_setup(DEPTH)
            sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            if label == "make_train_step":
                step = make_train_step(model, loss_fn, sgd)
            else:
                opt = hvd.DistributedOptimizer(
                    sgd, eager=True, overlap=label == "eager overlap")

                def step(batch, opt=opt, model=model):
                    # Host time of the forward's launches, of backward
                    # (the hooks' bucket copies and submissions
                    # included) and of step() (its wait included).
                    t0 = time.perf_counter()
                    opt.zero_grad()
                    loss = loss_fn(model, batch)
                    t1 = time.perf_counter()
                    loss.backward()
                    t2 = time.perf_counter()
                    opt.step()
                    split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
                    return injit.allreduce(loss.detach(), average=True)

            split = []
            losses, times = [], []
            c0 = hvd.metrics()
            for _ in range(2 + 3):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                loss = step(tokens)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
            out[label] = {"losses": losses,
                          "step_ms": statistics.median(times[2:]) * 1e3,
                          "times_ms": [t * 1e3 for t in times],
                          "plane": _eager_plane_per_step(
                              c0, hvd.metrics(), 5),
                          "host_ms": [round(statistics.median(x[2:]) * 1e3,
                                            1) for x in zip(*split)]
                          if split else None}
            # One more step under the profiler on rank 0 (the others run
            # it plainly, so that the collectives match).
            dist.barrier()
            if rank == 0:
                print(f"eager train nccl rank 0, {label}:", flush=True)
                out[label]["profile"] = _profile_step(step, tokens)
                sys.stdout.flush()
            else:
                step(tokens)
                torch.cuda.synchronize()
            del model, sgd, step
            if label != "make_train_step":
                del opt
        # Exactness: integer-valued f32 gradients of the model's leaf
        # shapes through the eager branch equal dist.all_reduce leaf for
        # leaf, bit for bit, overlap off and on.
        _free()
        model, _, _ = _train_setup(DEPTH)
        shapes = [p.shape for p in model.parameters()]
        del model
        _free()
        grads = [torch.randint(-64, 64, s, generator=gen, device=dev)
                 .float() for s in shapes]
        exact = {}
        for overlap in (False, True):
            red = hvd.allreduce_gradients(grads, eager=True, overlap=overlap,
                                          name_prefix=f"exact.{overlap}")
            same = True
            for g, r in zip(grads, red):
                ref = g.clone()
                dist.all_reduce(ref)
                same &= _bits_equal(r, ref / 4)
            exact[overlap] = bool(same)
            del red
        out["exact"] = exact
        del grads
        # Sparse: an embedding gradient with ragged rows per rank (integer
        # rows, so that every order of summation is exact) against the
        # dense mean.
        _free()
        emb = torch.nn.Embedding(VOCAB, DIM, sparse=True, device=dev)
        ids = torch.randint(0, VOCAB, ((rank + 1) * 512,), generator=gen,
                            device=dev)
        w = torch.randint(-4, 4, (ids.numel(), DIM), generator=gen,
                          device=dev).float()
        (emb(ids) * w).sum().backward()
        g = emb.weight.grad
        red = hvd.allreduce_gradients({"emb": g}, eager=True)["emb"]
        dense = g.to_dense()
        dist.all_reduce(dense)
        out["sparse"] = {"nnz": int(g._nnz()), "gathered": int(red._nnz()),
                         "same": _bits_equal(red.to_dense(), dense / 4)}
        torch.cuda.synchronize()
        hvd.shutdown()
        results.put((rank, out))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_eager_train_nccl():
    """Phase 21: the eager gradient route on four cards over NCCL (only
    with four or more cards; otherwise a line says it did not run)."""
    if torch.cuda.device_count() < 4:
        print("eager train nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    got = _spawn(_eager_train_worker, 4)
    _check(all(isinstance(got.get(r), dict) for r in range(4)),
           f"eager train nccl failed: {got}")
    for r in range(4):
        o = got[r]
        base = o["make_train_step"]["losses"]
        for label in ("make_train_step", "eager", "eager overlap"):
            run = o[label]
            track = max(abs(a - b) / abs(b)
                        for a, b in zip(run["losses"], base))
            p = run["plane"]
            print(f"eager train nccl rank {r} (cuda:{o['device']}), "
                  f"{label}: step {run['step_ms']:.1f} ms (median of 3; "
                  f"all {[round(t, 1) for t in run['times_ms']]}), losses "
                  f"{[round(x, 5) for x in run['losses']]}, vs "
                  f"make_train_step {track:.2e}; per step "
                  f"{p['responses']:.1f} responses, {p['cache_hits']:.1f} "
                  f"cache hits, {p['buckets']:.1f} buckets; hidden "
                  f"{p['hidden_seconds']} s, exposed "
                  f"{p['exposed_seconds']} s; host ms a step in forward, "
                  f"backward, step(): {run['host_ms']}")
            _check(all(math.isfinite(x) for x in run["losses"]),
                   f"rank {r} {label}: non-finite loss")
            _check(track <= 1e-5,
                   f"rank {r} {label}: losses {run['losses']} stray from "
                   f"make_train_step's {base}")
        print(f"eager train nccl rank {r}: integer gradients vs "
              f"dist.all_reduce bit-identical {o['exact']}; sparse "
              f"{o['sparse']}")
        _check(all(o["exact"].values()),
               f"rank {r}: eager gradients differ from dist.all_reduce")
        _check(o["sparse"]["same"]
               and o["sparse"]["gathered"] == 512 * (1 + 2 + 3 + 4),
               f"rank {r}: sparse route {o['sparse']}")
    return got


# ----------------------------------------------------- parallelism library

SP_SEQ = 8192                      # global sequence of the SP phase
SP_RANKS = 4
PP_STAGES, PP_DEPTH, PP_MICRO = 4, 3, 8
MOE_E, MOE_HIDDEN, MOE_TOKENS, MOE_K, MOE_CF = 4, 8192, 4096, 2, 1.25
# On a world of one, the sequence-parallel paths against attn="full" /
# "flash" in f32, relative Frobenius (6.2e-7 measured on an H100 80GB
# HBM3 at 700 W, PERF.md).
TOL_SP_ONE = 1e-5
# bf16 checks of the four-card phases, relative, each set from its
# readings on four H100 80GB HBM3 at 700 W: ulysses_flash's first loss
# 8.8e-8 from one card's; the batch-1 modes within 1.4e-5 of each other
# over 3 steps; TP's first loss 1.4e-6 from its twin's;
# matmul_reducescatter and the pipeline's first loss bit-identical to
# their twins.  The experts' twin routes on its own (torch.topk, the
# capacity rule written out) and moves data with the layer's one-hot
# products, so only the order of f32 sums in the gate gradients can part
# them; one token routed otherwise moves the outputs by about 1e-2.
TOL_SP_FIRST = 1e-5      # ulysses_flash's first loss vs one card's
TOL_SP_MODES = 1e-4      # ring, zigzag, ulysses vs ulysses_flash, batch 1
TOL_TP_LOSS = 1e-5       # TP first loss vs the one-card twin
TOL_MRS = 1e-5           # matmul_reducescatter vs psum_scatter, bf16
TOL_PP_FIRST = 1e-5      # pipeline first loss vs the 12-block model's
TOL_MOE = 1e-5           # MoE outputs, aux and gradients vs rank 0's twin
# A parallel path's first update (TP, the pipeline, each SP mode at
# batch 1) against its one-card bf16 twin's: the path sums its partial
# gradients (row-parallel products, microbatches, ranks) after rounding
# each to bf16, so its update is another bf16 approximation of the f32
# one.  The limit is this many times the problem's own floor, the twin's
# bf16 update against its f32 update (TP: 9.3e-3 against a floor of
# 1.1e-2 measured, H100 80GB HBM3 at 700 W).
UPDATE_FLOORS = 2.0


def _first_update(model, batch, device=None):
    """One SGD-momentum step of ``model`` on ``batch`` under
    ``_lm_loss``: (the loss, the change of every state-dict entry, on
    ``device``, else the model's).  The weights before the step wait in
    host memory."""
    before = {k: v.to("cpu", copy=True)
              for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    loss = _lm_loss(model, batch)
    loss.backward()
    opt.step()
    return loss.item(), _change(model, before, device)


def _change(model, before: dict, device=None) -> dict:
    """Each state-dict entry of ``model`` less its value in ``before``
    (host tensors), on ``device``, else the model's."""
    return {k: (v.to(device) if device else v) - before[k].to(
        device or v.device) for k, v in model.state_dict().items()}


def _dict_rel(a: dict, b: dict, group=None) -> float:
    """Relative Frobenius distance of two dicts of tensors over all of
    ``b``'s entries together; with ``group``, over the entries of all its
    ranks (the gathered tensors' distance)."""
    import torch.distributed as dist
    num = sum(torch.linalg.vector_norm(a[k].float() - b[k].float())
              .item() ** 2 for k in b)
    den = sum(torch.linalg.vector_norm(b[k].float()).item() ** 2 for k in b)
    if group is not None:
        t = torch.tensor([num, den], dtype=torch.float64,
                         device=next(iter(b.values())).device)
        dist.all_reduce(t, group=group)
        num, den = t.tolist()
    return math.sqrt(num / max(den, 1e-300))


def phase_parallel_one_card():
    """Phase 22: the sequence-parallel modes on a world of one at small
    widths in f32 (ring, ring_zigzag, ulysses against attn="full";
    ulysses_flash against attn="flash"), ulysses_flash in bf16 through
    P1-P3, and P1-P3 against their plain versions at every shape the
    four-card phases give them, timed at ulysses_flash's (B 8, H 16 / 4,
    T 8192, D 128)."""
    from horovod_tpu_torch.ops import _cuda
    cfg = dict(vocab=512, dim=256, depth=2, num_heads=2, max_len=256)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    toks = torch.randint(0, 512, (2, 257), generator=gen, device="cuda")
    batch = (toks[:, :-1], toks[:, 1:])
    from horovod_tpu_torch.models import TransformerLM

    def run(attn, dtype):
        model = TransformerLM(**cfg, attn=attn, dtype=dtype,
                              head_dtype=dtype, ln_dtype=dtype, seed=SEED,
                              device="cuda")
        loss = _lm_loss(model, batch)
        loss.backward()
        return loss.item(), [p.grad for p in model.parameters()]

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        refs = {a: run(a, torch.float32) for a in ("full", "flash")}
        for attn, ref in (("ring", "full"), ("ring_zigzag", "full"),
                          ("ulysses", "full"), ("ulysses_flash", "flash")):
            loss, grads = run(attn, torch.float32)
            rl = abs(loss - refs[ref][0]) / abs(refs[ref][0])
            rg = _dict_rel(dict(enumerate(grads)),
                           dict(enumerate(refs[ref][1])))
            print(f"parallel one card: {attn} vs attn={ref!r} (f32): loss "
                  f"{rl:.2e}, gradients {rg:.2e} (limit {TOL_SP_ONE})")
            _check(rl <= TOL_SP_ONE and rg <= TOL_SP_ONE,
                   f"{attn} on one card strays from attn={ref!r}: loss "
                   f"{rl}, gradients {rg}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    flash_loss, _ = run("flash", torch.bfloat16)
    _cuda.reset_launches()
    loss, _ = run("ulysses_flash", torch.bfloat16)
    launches = {n: _cuda.LAUNCHES[n] for n in FLASH}
    rl = abs(loss - flash_loss) / abs(flash_loss)
    print(f"parallel one card: ulysses_flash bf16 launches {launches}, loss "
          f"vs attn='flash' {rl:.2e}")
    _check(all(launches[n] == cfg["depth"] for n in FLASH),
           f"ulysses_flash in bf16 did not run P1-P3 once a layer: "
           f"{launches}")
    _check(rl <= TOL_SP_FIRST, f"ulysses_flash bf16 loss strays {rl}")
    # P1-P3 at every shape the four-card phases give them: a pipeline
    # stage's (one microbatch, every head), ulysses_flash's at batch 1,
    # and at batch 8 (one card's heads over the whole sequence, timed).
    print("kernels at the four-card phases' shapes (bf16):")
    for b, h, t, label in ((1, HEADS, SEQ, "pipeline stage"),
                           (1, HEADS // SP_RANKS, SP_SEQ,
                            "ulysses_flash batch 1")):
        _run_case(_case(b, h, t, DIM // HEADS, True, None, gen),
                  f"{label} B={b} H={h} T={t} D={DIM // HEADS} causal")
    c = _case(BATCH, HEADS // SP_RANKS, SP_SEQ, DIM // HEADS, True, None,
              gen)
    errs, times = _run_case(c, "ulysses_flash B=8 H=4 T=8192 D=128 causal",
                            timing=True)
    B, H, T, D = BATCH, HEADS // SP_RANKS, SP_SEQ, DIM // HEADS
    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * D * 2
    rows = B * H * T * 4
    work = {"flash_fwd": (4 * D * pairs, 4 * tensor + rows),
            "flash_bwd_dkdv": (8 * D * pairs, 6 * tensor + 2 * rows),
            "flash_bwd_dq": (6 * D * pairs, 5 * tensor + 2 * rows)}
    out = {}
    for name, key, lib in (("flash_fwd", "fwd", "sdpa_fwd"),
                           ("flash_bwd_dkdv", "dkdv", "sdpa_bwd"),
                           ("flash_bwd_dq", "dq", "sdpa_bwd")):
        flops, nbytes = work[name]
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        out[name] = {"ms": times[key], "plain_ms": times[key + "_plain"],
                     "bound_ms": bound, "library_ms": times[lib]}
        print(f"  ulysses_flash shape: {name} {times[key]:.4f} ms, "
              f"{bound / times[key]:.3f} of its bound ({bound:.4f} ms), "
              f"plain {times[key + '_plain']:.2f} ms, "
              f"scaled_dot_product_attention "
              f"{'forward' if lib == 'sdpa_fwd' else 'backward'} "
              f"{times[lib]:.4f} ms ({times[key] / times[lib]:.2f}x)")
    return out


def _par_env(rank: int, port: int):
    os.environ.update({"HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
                       "HOROVOD_TPU_LOCAL_SIZE": "1",
                       "HOROVOD_TPU_LOCAL_RANK": str(rank)})
    import horovod_tpu_torch as hvd
    hvd.init(init_method=f"tcp://127.0.0.1:{port}")
    return hvd, torch.device("cuda", rank)


def _timed_steps(step, batch, n: int):
    """``n`` steps, each timed between barriers; (losses, seconds)."""
    import torch.distributed as dist
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return losses, times


def _profile_on_rank0(rank: int, label: str, step, batch):
    """One more ``step(batch)`` under the profiler on rank 0 (the other
    ranks run it plainly, so that the collectives match)."""
    import torch.distributed as dist
    dist.barrier()
    if rank != 0:
        step(batch)
        torch.cuda.synchronize()
        return None
    print(f"{label}, rank 0:", flush=True)
    prof = _profile_step(step, batch)
    sys.stdout.flush()
    return prof


def _sp_worker_phase(hvd, dev, rank):
    """Phase 23 on one of four cards."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.ring_attention import zigzag_indices
    from horovod_tpu_torch.spmd import make_train_step, shard_batch
    out = {}
    mesh = build_mesh(hvd.get_topology(), (SP_RANKS,), ("sp",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    toks = torch.randint(0, VOCAB, (BATCH, SP_SEQ + 1), generator=gen,
                         device=dev)
    full = (toks[:, :-1], toks[:, 1:])
    # One card's attn="flash" forward over the whole sequence, on rank 0.
    if rank == 0:
        ref = _lm("flash", DEPTH, SP_SEQ, dev)
        with torch.no_grad():
            out["one_card_loss"] = _lm_loss(ref, full).item()
        del ref
        _free()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    model = _lm("ulysses_flash", DEPTH, SP_SEQ, dev, sp_axis="sp",
                mesh=mesh)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, _lm_loss, opt)
    batch = shard_batch(full, (None, "sp"), mesh=mesh)
    _cuda.reset_launches()
    losses, times = _timed_steps(step, batch, WARMUP + TIMED)
    out["launches"] = {n: _cuda.LAUNCHES[n] for n in FLASH + (FUSED,)}
    out["losses"], out["times"] = losses, times
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["clocks"] = _clocks()
    out["profile"] = _profile_on_rank0(rank, "sp nccl, ulysses_flash", step,
                                       batch)
    del model, opt, step, batch
    _free()
    # Batch 1, 3 steps each: the four modes on the same tokens (zigzag's
    # permuted by zigzag_indices), each mode's first update (replicated:
    # make_train_step averages the gradients over the ranks) against a
    # one-card attn="flash" twin's on rank 0, beside the floor, the twin's
    # bf16 update against its f32 update.
    one = (full[0][:1], full[1][:1])
    if rank == 0:
        # On the host: rank 0's card also holds the parent's context.
        twin = {}
        for dtype in (torch.float32, torch.bfloat16):
            twin[dtype] = _first_update(_lm("flash", DEPTH, SP_SEQ, dev,
                                            dtype=dtype), one, "cpu")[1]
            _free()
        out["b1_floor"] = _dict_rel(twin[torch.bfloat16],
                                    twin[torch.float32])
        twin = twin[torch.bfloat16]
        _free()
    dist.barrier()
    idx = torch.as_tensor(zigzag_indices(SP_RANKS, SP_SEQ), device=dev)
    for attn in ("ulysses_flash", "ring", "ring_zigzag", "ulysses"):
        data = (one if attn != "ring_zigzag"
                else (one[0][:, idx], one[1][:, idx]))
        torch.cuda.reset_peak_memory_stats(dev)
        model = _lm(attn, DEPTH, SP_SEQ, dev, sp_axis="sp", mesh=mesh)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, _lm_loss, opt)
        data = shard_batch(data, (None, "sp"), mesh=mesh)
        if rank == 0:
            before = {k: v.to("cpu", copy=True)
              for k, v in model.state_dict().items()}
        losses, times = _timed_steps(step, data, 1)
        run = {}
        if rank == 0:
            run["update_err"] = _dict_rel(_change(model, before, "cpu"),
                                          twin)
            del before
        more, more_t = _timed_steps(step, data, 2)
        run.update(losses=losses + more, times=times + more_t,
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        out[("b1", attn)] = run
        if attn == "ulysses_flash":
            _profile_on_rank0(rank, "sp nccl batch 1, ulysses_flash", step,
                              data)
        del model, opt, step, data
        _free()
    return out


def _sp_flops(depth: int, tokens: int) -> float:
    """``bench.py:425-427``'s model FLOPs with seq the global SP_SEQ, for
    ``tokens`` tokens on one card."""
    n_matmul = 12 * depth * DIM * DIM + VOCAB * DIM
    return (6 * n_matmul + 12 * depth * SP_SEQ * DIM) * tokens


def _check_sp(got: dict) -> None:
    o0 = got[0]["sp"]
    steps = WARMUP + TIMED
    for r in range(SP_RANKS):
        o = got[r]["sp"]
        step_s = statistics.median(o["times"][WARMUP:])
        tokens = BATCH * SP_SEQ // SP_RANKS
        mfu = _sp_flops(DEPTH, tokens) / step_s / PEAK_BF16_FLOPS
        print(f"sp nccl rank {r}: ulysses_flash, seq {SP_SEQ} over "
              f"{SP_RANKS} cards, batch {BATCH}, depth {DEPTH}: step "
              f"{step_s * 1e3:.1f} ms (median of {TIMED}; all "
              f"{[round(t * 1e3, 1) for t in o['times']]}), "
              f"{tokens / step_s:.0f} tokens/s/GPU, MFU {mfu:.3f} at 989 "
              f"TFLOP/s, peak memory {o['peak_gb']:.2f} GiB, launches "
              f"{o['launches']}; losses {[round(x, 5) for x in o['losses']]};"
              f" SM clock, power, temperature {o['clocks']}")
        for name in FLASH:
            _check(o["launches"][name] == DEPTH * steps,
                   f"rank {r}: {name} launched {o['launches'][name]} "
                   f"times, expected {DEPTH * steps}")
        _check(o["launches"][FUSED] == 0, f"rank {r}: P6 ran")
        _check(all(math.isfinite(x) for x in o["losses"]),
               f"rank {r}: non-finite loss")
        _check(o["losses"][-1] < o["losses"][0],
               f"rank {r}: loss did not fall {o['losses']}")
        _check(o["losses"] == o0["losses"],
               f"rank {r}: losses differ from rank 0's")
    ref = o0["one_card_loss"]
    first = o0["losses"][0]
    rel = abs(first - ref) / abs(ref)
    print(f"sp nccl: first loss {first:.6f} vs one card's attn='flash' "
          f"forward over all {SP_SEQ} tokens {ref:.6f}: {rel:.2e} (limit "
          f"{TOL_SP_FIRST})")
    _check(rel <= TOL_SP_FIRST, f"sp first loss strays {rel}")
    print("sp nccl: cut: batch 8 -> 1 for the four modes side by side "
          "(the dense ring and ulysses keep f32 (B, H, T_q, T_k) blocks "
          "for the backward; depth and widths not cut)")
    base = o0[("b1", "ulysses_flash")]["losses"]
    floor = o0["b1_floor"]
    for attn in ("ulysses_flash", "ring", "ring_zigzag", "ulysses"):
        run = o0[("b1", attn)]
        track = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base))
        print(f"sp nccl: batch 1, {attn}: losses "
              f"{[round(x, 5) for x in run['losses']]}, vs ulysses_flash "
              f"{track:.2e} (limit {TOL_SP_MODES}); first update vs the "
              f"one-card attn='flash' twin's {run['update_err']:.2e} (limit "
              f"{UPDATE_FLOORS} x the floor, twin bf16 vs f32, "
              f"{floor:.2e}); steps "
              f"{[round(t * 1e3, 1) for t in run['times']]} ms, peak memory "
              f"{run['peak_gb']:.2f} GiB (rank 0, which also holds the "
              f"twin's update and a copy of the weights)")
        _check(track <= TOL_SP_MODES,
               f"{attn} at batch 1 strays from ulysses_flash: {track}")
        _check(0 < floor and run["update_err"] <= UPDATE_FLOORS * floor,
               f"{attn} at batch 1: first update strays "
               f"{run['update_err']}, floor {floor}")
        _check(all(math.isfinite(x) for x in run["losses"]),
               f"{attn}: non-finite loss")
    for a in ("ring", "ring_zigzag", "ulysses"):
        for b in ("ring", "ring_zigzag", "ulysses"):
            d = max(abs(x - y) / abs(y) for x, y in zip(
                o0[("b1", a)]["losses"], o0[("b1", b)]["losses"]))
            _check(d <= TOL_SP_MODES, f"{a} and {b} disagree: {d}")


def _tp_worker_phase(hvd, dev, rank):
    """Phase 24 on one of four cards: (dp 2, tp 2)."""
    from horovod_tpu_torch import weights
    from horovod_tpu_torch.parallel import collectives as coll
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.parallel.tensor_parallel import (
        matmul_reducescatter, tp_value_and_grad)
    mesh = build_mesh(hvd.get_topology(), (2, 2), ("dp", "tp"))
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    toks = torch.randint(0, VOCAB, (2 * dp.size, SEQ + 1), generator=gen,
                         device=dev)
    full = (toks[:, :-1], toks[:, 1:])
    mine = tuple(t[2 * dp.index:2 * dp.index + 2] for t in full)

    def my_slices(state):
        return weights.dense_to_tp_state(state, DEPTH, tp.index, tp.size)

    # The one-card twin (attn="full") from the seed: one SGD step on the
    # whole batch in bf16, and in f32 for the problem's own floor.
    twin = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = _lm("full", DEPTH, SEQ, dev, dtype=dtype)
        if label == "bf16":
            state0 = my_slices({k: v.clone()
                                for k, v in model.state_dict().items()})
        loss, update = _first_update(model, full)
        twin[label] = (loss, my_slices(update))
        del model, update
        _free()
    torch.cuda.reset_peak_memory_stats(dev)
    model = _lm("full", DEPTH, SEQ, dev, tp_axis="tp", mesh=mesh)
    model.load_state_dict(state0)
    del state0
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)

    def step(batch):
        loss, grads = tp_value_and_grad(lambda m: _lm_loss(m, batch), model,
                                        ("dp",), mesh=mesh)
        for n, p in model.named_parameters():
            p.grad = grads[n]
        opt.step()
        return loss

    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses, times = _timed_steps(step, mine, 1)
    after = model.state_dict()
    update = {k: after[k] - before[k] for k in before}
    del before
    more, more_t = _timed_steps(step, mine, 3)
    out["losses"], out["times"] = losses + more, times + more_t
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    # Errors over this rank's slices, summed over the tp group: the
    # gathered tensors' relative Frobenius distance.
    out["update_err"] = _dict_rel(update, twin["bf16"][1], tp.group)
    out["update_floor"] = _dict_rel(twin["bf16"][1], twin["f32"][1],
                                    tp.group)
    out["twin_losses"] = (twin["bf16"][0], twin["f32"][0])
    del model, opt, update, twin
    _free()
    # matmul_reducescatter against psum_scatter of the full product, at
    # the MLP row shape (tokens of one dp shard, hidden / tp rows).
    x = torch.randn((2, SEQ, 4 * DIM // tp.size), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = (torch.randn((4 * DIM // tp.size, DIM), generator=gen, device=dev)
         / math.sqrt(4 * DIM)).to(torch.bfloat16)
    ring = matmul_reducescatter(x, k, "tp", mesh=mesh)
    ref = coll.psum_scatter(x @ k, "tp", 1, mesh=mesh)
    out["mrs_err"] = _rel_fro(ring, ref)
    out["mrs_ms"] = _median_ms(
        lambda: matmul_reducescatter(x, k, "tp", mesh=mesh), runs=5,
        warmup=2, reps=5)
    out["psum_ms"] = _median_ms(
        lambda: coll.psum_scatter(x @ k, "tp", 1, mesh=mesh), runs=5,
        warmup=2, reps=5)
    return out


def _check_tp(got: dict) -> None:
    print("tp nccl: cut: batch 8 a card -> 2 a dp shard (the one-card twin "
          "holds the whole batch in the oracle attention's f32 (B, H, T, T) "
          "blocks, in bf16 and in f32; depth and widths not cut)")
    for r in range(4):
        o = got[r]["tp"]
        twin_bf16, twin_f32 = o["twin_losses"]
        rl = abs(o["losses"][0] - twin_bf16) / abs(twin_bf16)
        floor = abs(twin_bf16 - twin_f32) / abs(twin_f32)
        print(f"tp nccl rank {r} (dp {r // 2}, tp {r % 2}): depth {DEPTH}, "
              f"T {SEQ}, batch 2 a dp shard, bf16: losses "
              f"{[round(x, 5) for x in o['losses']]}, steps "
              f"{[round(t * 1e3, 1) for t in o['times']]} ms, peak memory "
              f"{o['peak_gb']:.2f} GiB; first loss vs the one-card twin "
              f"{rl:.2e} (limit {TOL_TP_LOSS}; floor, twin bf16 vs f32, "
              f"{floor:.2e}); first update, gathered, vs the twin's "
              f"{o['update_err']:.2e} (limit {UPDATE_FLOORS} x the "
              f"floor, twin bf16 vs f32, {o['update_floor']:.2e}); "
              f"matmul_reducescatter vs "
              f"psum_scatter {o['mrs_err']:.2e} (limit {TOL_MRS}), "
              f"{o['mrs_ms']:.3f} ms vs {o['psum_ms']:.3f} ms")
        _check(all(math.isfinite(x) for x in o["losses"]),
               f"tp rank {r}: non-finite loss")
        _check(o["losses"][-1] < o["losses"][0],
               f"tp rank {r}: loss did not fall {o['losses']}")
        _check(rl <= TOL_TP_LOSS, f"tp rank {r}: first loss strays {rl}")
        _check(0 < o["update_floor"]
               and o["update_err"] <= UPDATE_FLOORS * o["update_floor"],
               f"tp rank {r}: first update strays {o['update_err']}, "
               f"floor {o['update_floor']}")
        _check(o["mrs_err"] <= TOL_MRS,
               f"tp rank {r}: matmul_reducescatter strays {o['mrs_err']}")


def _pp_stage(seed: int, device):
    from horovod_tpu_torch.models import BlockStack
    return BlockStack(DIM, HEADS, PP_DEPTH, attn="flash",
                      dtype=torch.bfloat16, ln_dtype=torch.bfloat16,
                      seed=seed, device=device)


def _pp_worker_phase(hvd, dev, rank):
    """Phase 25 on one of four cards: one stage of three blocks."""
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.ops.losses import fused_softmax_xent
    from horovod_tpu_torch.parallel.mesh import build_mesh, fold_in
    from horovod_tpu_torch.parallel.pipeline import (
        microbatch, pipeline_apply, stage_params_init, unmicrobatch)
    mesh = build_mesh(hvd.get_topology(), (PP_STAGES,), ("pp",))
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    toks = torch.randint(0, VOCAB, (PP_MICRO, SEQ + 1), generator=gen,
                         device=dev)
    batch = (toks[:, :-1], toks[:, 1:])
    # Embeddings, final LayerNorm and head: a TransformerLM of no block,
    # replicated on every stage.
    ends = _lm("flash", 0, SEQ, dev)
    stage = stage_params_init(lambda s: _pp_stage(s, dev), SEED + 1,
                              axis="pp", mesh=mesh)

    def loss_fn(batch):
        inp, lab = batch
        pos = torch.arange(inp.shape[1], device=dev)
        x = ends.tok_emb(inp) + ends.pos_emb(pos)[None]
        y = unmicrobatch(pipeline_apply(lambda m, a: m(a), stage,
                                        microbatch(x, PP_MICRO),
                                        mesh=mesh))
        h = ends.ln_f(y)
        return fused_softmax_xent(h.reshape(-1, DIM), ends.head.kernel,
                                  lab.reshape(-1)).mean()

    # The 12-block model with the same weights (the ends, then every
    # stage's blocks in order, each stage rebuilt from its seed): one step
    # on the whole batch in bf16, and in f32 for the problem's own floor,
    # on every rank.  Each rank keeps the update of the ends and of its
    # own stage's blocks, under the names they have here.
    state = {k: v.cpu() for k, v in ends.state_dict().items()}
    mine = {k: k for k in state}
    for s in range(PP_STAGES):
        for k, v in _pp_stage(fold_in(SEED + 1, s),
                              dev).state_dict().items():
            i, rest = k.split(".", 1)
            name = f"block_{s * PP_DEPTH + int(i[6:])}.{rest}"
            state[name] = v.cpu()
            if s == rank:
                mine[name] = k
    twin = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _lm("flash", PP_STAGES * PP_DEPTH, SEQ, dev, dtype=dtype)
        model.load_state_dict(state)
        loss, update = _first_update(model, batch)
        twin[dtype] = (loss, {mine[k]: update[k] for k in mine})
        del model, update
        _free()
    del state
    out["twin_loss"] = twin[torch.bfloat16][0]
    out["update_floor"] = _dict_rel(twin[torch.bfloat16][1],
                                    twin[torch.float32][1])
    twin = twin[torch.bfloat16][1]
    params = list(ends.parameters()) + list(stage.parameters())
    opt = torch.optim.SGD(params, lr=0.01, momentum=0.9)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launches()
    with torch.no_grad():
        loss_fn(batch)
    out["fwd_launches"] = {n: _cuda.LAUNCHES[n] for n in FLASH}
    _cuda.reset_launches()
    before = [{k: v.to("cpu", copy=True)
               for k, v in m.state_dict().items()} for m in (ends, stage)]
    losses, times = _timed_steps(step, batch, 1)
    out["update_err"] = _dict_rel({**_change(ends, before[0]),
                                   **_change(stage, before[1])}, twin)
    del before, twin
    more, more_t = _timed_steps(step, batch, 2)
    out["launches"] = {n: _cuda.LAUNCHES[n] for n in FLASH}
    out["losses"], out["times"] = losses + more, times + more_t
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _profile_on_rank0(rank, "pp nccl", step, batch)
    del ends, stage, opt, params
    _free()
    return out


def _check_pp(got: dict) -> None:
    ticks = PP_MICRO + PP_STAGES - 1
    for r in range(PP_STAGES):
        o = got[r]["pp"]
        print(f"pp nccl rank {r} (stage {r}): {PP_STAGES} stages of "
              f"BlockStack(depth {PP_DEPTH}, attn='flash'), {PP_MICRO} "
              f"microbatches of 1 x {SEQ}: a forward launches "
              f"{o['fwd_launches']}, 3 steps {o['launches']}; losses "
              f"{[round(x, 5) for x in o['losses']]}, steps "
              f"{[round(t * 1e3, 1) for t in o['times']]} ms, peak memory "
              f"{o['peak_gb']:.2f} GiB; first update of the ends and "
              f"this stage vs the 12-block twin's {o['update_err']:.2e} "
              f"(limit {UPDATE_FLOORS} x the floor, twin bf16 vs f32, "
              f"{o['update_floor']:.2e})")
        _check(0 < o["update_floor"]
               and o["update_err"] <= UPDATE_FLOORS * o["update_floor"],
               f"pp rank {r}: first update strays {o['update_err']}, "
               f"floor {o['update_floor']}")
        _check(o["fwd_launches"]["flash_fwd"] == PP_DEPTH * ticks,
               f"pp rank {r}: P1 launched {o['fwd_launches']['flash_fwd']} "
               f"times in a forward, expected {PP_DEPTH * ticks}")
        for name in FLASH:
            _check(o["launches"][name] == 3 * PP_DEPTH * ticks,
                   f"pp rank {r}: {name} launched {o['launches'][name]} "
                   f"times in 3 steps, expected {3 * PP_DEPTH * ticks}")
        _check(all(math.isfinite(x) for x in o["losses"]),
               f"pp rank {r}: non-finite loss")
        _check(o["losses"] == got[0]["pp"]["losses"],
               f"pp rank {r}: losses differ from stage 0's")
    o0 = got[0]["pp"]
    rel = abs(o0["losses"][0] - o0["twin_loss"]) / abs(o0["twin_loss"])
    print(f"pp nccl: first loss {o0['losses'][0]:.6f} vs the 12-block "
          f"model's on one card {o0['twin_loss']:.6f}: {rel:.2e} "
          f"(limit {TOL_PP_FIRST})")
    _check(rel <= TOL_PP_FIRST, f"pp first loss strays {rel}")
    _check(o0["losses"][-1] < o0["losses"][0],
           f"pp loss did not fall {o0['losses']}")


def _moe_worker_phase(hvd, dev, rank):
    """Phase 26 on one of four cards: one expert; rank 0 also runs the
    same function with every expert gathered on its card."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from horovod_tpu_torch.parallel import moe as pm
    from horovod_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(hvd.get_topology(), (MOE_E,), ("ep",))
    out = {}
    layer = pm.MoELayer(DIM, MOE_HIDDEN, MOE_CF, "ep", top_k=MOE_K,
                        router_z_weight=1e-3, dtype=torch.bfloat16,
                        mesh=mesh, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50 + rank)
    x = torch.randn((MOE_TOKENS, DIM), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn((MOE_TOKENS, DIM), generator=gen, device=dev)

    def loss_of(y, aux, g):
        return (y.float() * g).sum() / g.numel() + aux

    y, aux = layer(x)
    loss_of(y, aux, g).backward()
    mine = {"y": y.detach(), "aux": aux.detach(),
            "balance": layer.aux_load_balance.detach(),
            "z": layer.aux_router_z.detach(), "x_grad": x.grad,
            "w1_grad": layer.w1.grad, "w2_grad": layer.w2.grad,
            "router_grad": layer.router.kernel.grad}
    out["dropped"] = float(layer.dropped)
    out["capacity"] = layer.capacity(MOE_TOKENS)

    def fwd_bwd():
        layer.zero_grad(set_to_none=True)
        x.grad = None
        y, aux = layer(x)
        loss_of(y, aux, g).backward()

    out["ms"] = _median_ms(fwd_bwd, runs=5, warmup=2, reps=3)
    _profile_on_rank0(rank, "moe nccl", lambda _: fwd_bwd(), None)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(MOE_E)]
        dist.all_gather(parts, t.contiguous())
        return parts

    got = {k: gather(v) for k, v in mine.items()}
    xs, gs = gather(x.detach()), gather(g)
    w1s, w2s = gather(layer.w1.detach()), gather(layer.w2.detach())
    if rank == 0:
        # The same function written out on rank 0 in plain torch, with
        # every expert gathered: each shard's tokens routed by torch.topk
        # on the f32 softmax (gates renormalised over the k choices), the
        # slots of an expert handed out by choice, then token, up to the
        # capacity; each expert's FFN over the slots of all shards
        # (shard-major, as the exchange delivers them), combined per
        # shard.  Data moves by the layer's one-hot products.
        E, K, bf16 = MOE_E, MOE_K, torch.bfloat16
        C = max(1, int(MOE_CF * K * MOE_TOKENS / E))
        out["twin_capacity"] = C
        router = layer.router.kernel.detach().clone().requires_grad_()
        w1 = torch.stack(w1s).requires_grad_()
        w2 = torch.stack(w2s).requires_grad_()
        xr = [t.clone().requires_grad_() for t in xs]
        plans = []
        for t in xr:
            logits = t.float() @ router
            probs = torch.softmax(logits, dim=-1)
            gate, choice = torch.topk(probs, K, dim=-1)          # (T, K)
            if K > 1:
                gate = gate / gate.sum(dim=-1, keepdim=True)
            disp = torch.zeros((MOE_TOKENS, E, C), device=dev)
            comb = torch.zeros((MOE_TOKENS, E, C), device=dev)
            filled = [0] * E
            for j in range(K):
                for e in range(E):
                    tok = torch.nonzero(choice[:, j] == e).flatten()
                    slot = filled[e] + torch.arange(tok.numel(), device=dev)
                    filled[e] += tok.numel()
                    tok, slot = tok[slot < C], slot[slot < C]
                    disp[tok, e, slot] = 1.0
                    comb[tok, e, slot] = gate[tok, j]
            first = F.one_hot(choice[:, 0], E).float()
            bal = E * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
            z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
            plans.append((disp, comb, bal, z))
        out["twin_dropped"] = [1.0 - p[0].sum().item() / (K * MOE_TOKENS)
                               for p in plans]
        bufs = torch.stack([torch.einsum("td,tec->ecd", t, p[0].to(bf16))
                            for t, p in zip(xr, plans)])   # (S, E, C, d)
        res = torch.stack([
            (F.gelu(bufs[:, e].reshape(-1, DIM) @ w1[e].to(bf16),
                    approximate="tanh") @ w2[e].to(bf16))
            .reshape(MOE_E, C, DIM) for e in range(E)], 1)
        total = 0.0
        ref = {"y": [], "aux": [], "balance": [], "z": []}
        for s, (_, comb, bal, z) in enumerate(plans):
            ys = torch.einsum("ecd,tec->td", res[s].float(), comb).to(bf16)
            aux = bal + 1e-3 * z
            total = total + loss_of(ys, aux, gs[s])
            for k, v in (("y", ys), ("aux", aux), ("balance", bal),
                         ("z", z)):
                ref[k].append(v.detach())
        total.backward()
        ref["x_grad"] = [t.grad for t in xr]
        ref["w1_grad"] = list(w1.grad)
        ref["w2_grad"] = list(w2.grad)
        ref["router_grad"] = [router.grad] * E
        errs = {}
        for k in ("y", "x_grad", "w1_grad", "w2_grad", "router_grad"):
            errs[k] = max(_rel_fro(a, b) for a, b in zip(got[k], ref[k]))
        for k in ("aux", "balance", "z"):
            errs[k] = max(abs(a.item() - b.item()) / abs(b.item())
                          for a, b in zip(got[k], ref[k]))
        out["errs"] = errs
    del layer, x, g, got
    _free()
    return out


def _check_moe(got: dict) -> None:
    for r in range(MOE_E):
        o = got[r]["moe"]
        print(f"moe nccl rank {r} (expert {r}): E {MOE_E}, d {DIM}, hidden "
              f"{MOE_HIDDEN}, top-{MOE_K}, capacity factor {MOE_CF} "
              f"(C {o['capacity']}), {MOE_TOKENS} tokens, bf16: dropped "
              f"share {o['dropped']:.4f}, forward + backward "
              f"{o['ms']:.2f} ms")
    o0 = got[0]["moe"]
    errs = o0["errs"]
    print(f"moe nccl: vs rank 0's twin with every expert gathered, "
          f"relative: {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} "
          f"(limit {TOL_MOE}); the twin's capacity {o0['twin_capacity']}, "
          f"dropped shares {o0['twin_dropped']}")
    _check(o0["twin_capacity"] == o0["capacity"],
           f"moe capacity {o0['capacity']}, the twin's {o0['twin_capacity']}")
    for r in range(MOE_E):
        _check(abs(got[r]["moe"]["dropped"] - o0["twin_dropped"][r]) < 1e-9,
               f"moe rank {r} dropped {got[r]['moe']['dropped']}, the "
               f"twin's shard {o0['twin_dropped'][r]}")
    for k, v in errs.items():
        _check(math.isfinite(v) and v <= TOL_MOE,
               f"moe {k} strays from the gathered twin: {v}")


def _parallel_worker(rank: int, port: int, results) -> None:
    """Phases 23-26 on one of four cards."""
    try:
        hvd, dev = _par_env(rank, port)
        out = {}
        for name, fn in (("sp", _sp_worker_phase), ("tp", _tp_worker_phase),
                         ("pp", _pp_worker_phase),
                         ("moe", _moe_worker_phase)):
            out[name] = fn(hvd, dev, rank)
            _free()
        hvd.shutdown()
        results.put((rank, out))
    except BaseException:   # reported to the parent, which fails
        import traceback
        results.put((rank, traceback.format_exc()))
        raise


def phase_parallel_nccl():
    """Phases 23-26: sequence, tensor, pipeline and expert parallelism on
    four cards over NCCL, in one group of four processes (only with four
    or more cards; otherwise a line says each did not run)."""
    labels = ("sp nccl", "tp nccl", "pp nccl", "moe nccl")
    if torch.cuda.device_count() < 4:
        for label in labels:
            print(f"{label}: not run (it needs four CUDA devices, this "
                  f"machine has {torch.cuda.device_count()})")
        return None
    # The parent's own footprint on card 0, which rank 0 shares.
    print(f"parallel nccl: the parent holds "
          f"{torch.cuda.memory_allocated(0) / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved(0) / 2 ** 30:.2f} GiB reserved on "
          f"card 0, which has {torch.cuda.mem_get_info(0)[0] / 2 ** 30:.2f} "
          f"GiB free")
    got = _spawn(_parallel_worker, 4, timeout=600)
    _check(all(isinstance(got.get(r), dict) for r in range(4)),
           f"parallel nccl failed: {got}")
    _check_sp(got)
    _check_tp(got)
    _check_pp(got)
    _check_moe(got)
    return got


# -------------------------------------------------------------- resilience

# Phases 27-28 write their checkpoints inside the checkout (``build/`` is
# gitignored) and remove them at their end.
CKPT_ROOT = Path("build") / "chip_smoke_ckpt"
CKPT_SAVE_AT, CKPT_RESUME_STEPS, STREAM_STEPS = 3, 2, 4
ELASTIC_RANKS, ELASTIC_STEPS = 3, 10
ELASTIC_DIE_RANK, ELASTIC_DIE_STEP = 2, 5
# Phases 35-36: the fleet policy on phase 28's job.  Process 1 alone
# slows each of its ticks by EVICT_MS from tick EVICT_ONSET_TICK; the
# eviction waits for a parked standby (the floor is the full world),
# which parks only once rank 0 has committed epoch 0, so the demotion
# comes after the commit however fast the ticks run.  The final
# generation trains FLEET_STEPS steps; a generation that waits for a
# membership change trains until it comes, at most FLEET_WAIT_S.  Phase
# 36 goes AUTOSCALE_RANKS -> AUTOSCALE_SMALL -> AUTOSCALE_RANKS through
# the file seam: rank 0 writes each target after AUTOSCALE_STEPS steps of
# a generation.
EVICT_MS, EVICT_ONSET_TICK = 50, 2000
# Phase 38: the tenants' spec and elements of their timed allreduce; the
# publish drill's steps a leg and its commit cadence.
SET_TENANTS = ("tenantA", "tenantB")
SET_TIMED_N = 1 << 20
PUBLISH_STEPS, PUBLISH_EVERY = 12, 4
FLEET_STEPS, FLEET_WAIT_S = 4, 300
AUTOSCALE_RANKS, AUTOSCALE_SMALL, AUTOSCALE_STEPS = 4, 2, 4
# Phase 37: steps a topology.
TOPO_STEPS = 3


def _fingerprint(t: torch.Tensor) -> int:
    """A position-weighted sum of ``t``'s bit patterns in int64 (which
    wraps, exactly, in any order of summation): one pass on the card, and
    equal only for equal bits but for a 2^-64 chance."""
    flat = t.detach().contiguous().view(-1)
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = flat.view(ints[flat.element_size()]).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64)
    return int((v * (w % 65521 + 1)).sum().item())


def _state_fingerprints(tree) -> dict:
    """{key: fingerprint} of the tensor leaves of a state tree."""
    from horovod_tpu_torch import checkpoint
    return {k: _fingerprint(v) for k, v in checkpoint.leaves_with_keys(tree)
            if isinstance(v, torch.Tensor)}


def _flat_fingerprints(flat: dict, keys, device) -> dict:
    """The same fingerprints of a chain's leaves as read from disk
    (``checkpoint.read_chain_state``), for ``keys``, on ``device``."""
    import numpy as np
    out = {}
    for k in keys:
        a = flat[k]
        if a.dtype == np.dtype("V2"):       # bfloat16 records
            a = a.view(np.int16)
        out[k] = _fingerprint(torch.from_numpy(a).to(device))
    return out


def _digest(fps: dict) -> str:
    import hashlib
    return hashlib.sha256(json.dumps(sorted(fps.items())).encode()
                          ).hexdigest()[:16]


def _sgd_step(model, opt, tokens) -> float:
    opt.zero_grad()
    loss = _lm_loss(model, tokens)
    loss.backward()
    opt.step()
    return loss.item()


def _timed_sgd_steps(model, opt, batches):
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_sgd_step(model, opt, b))
        times.append(time.perf_counter() - t0)
    return losses, times


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _peak_rss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def phase_checkpoint(depth: int) -> dict:
    """Phase 27: the headline model's training state through
    ``save_model`` / ``load_model`` and the async checkpoint stream on one
    card; resume bit-identical, the stream's restored tip equal to its
    snapshot."""
    import shutil
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, ckpt_stream
    from horovod_tpu_torch.ops import _cuda
    root = CKPT_ROOT / "phase27"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free0 = shutil.disk_usage(root).free
    orig_save_chain = checkpoint.save_chain
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
        batches = [torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                                 device="cuda")
                   for _ in range(CKPT_SAVE_AT + CKPT_RESUME_STEPS
                                  + STREAM_STEPS)]
        resume = batches[CKPT_SAVE_AT:CKPT_SAVE_AT + CKPT_RESUME_STEPS]
        stream = batches[CKPT_SAVE_AT + CKPT_RESUME_STEPS:]
        model = _lm("flash", depth, SEQ, "cuda")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        _timed_sgd_steps(model, opt, batches[:CKPT_SAVE_AT])
        n_params = sum(p.numel() for p in model.parameters())
        state_bytes = sum(
            t.numel() * t.element_size() for _, t in
            checkpoint.leaves_with_keys(checkpoint.model_state(model, opt))
            if isinstance(t, torch.Tensor))
        print(f"checkpoint: depth {depth}, {n_params} f32 parameters; the "
              f"training state (parameters + SGD momentum) is {state_bytes} "
              f"bytes ({state_bytes / 2 ** 30:.2f} GiB); free disk "
              f"{free0 / 2 ** 30:.1f} GiB")
        d = str(root / "model")
        t0 = time.perf_counter()
        hvd.save_model(d, model, opt, CKPT_SAVE_AT, optimizer=opt)
        save_s = time.perf_counter() - t0
        saved_bytes = _dir_bytes(d)
        losses_a, times_a = _timed_sgd_steps(model, opt, resume)
        fresh = _lm("flash", depth, SEQ, "cuda")
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        t0 = time.perf_counter()
        fresh, opt_b, epoch = hvd.load_model(d, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        losses_b, times_b = _timed_sgd_steps(fresh, opt_b, resume)
        same_params = all(torch.equal(p, q) for p, q in
                          zip(model.parameters(), fresh.parameters()))
        same_momentum = all(
            torch.equal(opt.state[p]["momentum_buffer"],
                        opt_b.state[q]["momentum_buffer"])
            for p, q in zip(model.parameters(), fresh.parameters()))
        print(f"checkpoint: save_model (epoch {CKPT_SAVE_AT}, chain base) "
              f"{save_s:.2f} s, {saved_bytes} bytes on disk; load_model "
              f"from the directory alone {load_s:.2f} s (epoch {epoch}, "
              f"{type(opt_b).__name__}); run A losses {losses_a}, run B "
              f"{losses_b}: {'bit-identical' if losses_a == losses_b else 'DIFFERENT'}"
              f"; parameters {'bit-identical' if same_params else 'DIFFERENT'}, "
              f"momentum {'bit-identical' if same_momentum else 'DIFFERENT'}; "
              f"peak host RSS {_peak_rss_gib():.2f} GiB")
        _check(epoch == CKPT_SAVE_AT, f"checkpoint: load_model resumed at "
               f"epoch {epoch}, expected {CKPT_SAVE_AT}")
        _check(losses_a == losses_b and same_params and same_momentum,
               f"checkpoint: resume is not bit-identical: {losses_a} vs "
               f"{losses_b}, parameters {same_params}, momentum "
               f"{same_momentum}")
        del fresh, opt_b
        _free()
        shutil.rmtree(d)
        # The stream: one snapshot a step, a base every second commit.
        commits = []

        def timed_save_chain(directory, flat, epoch, **kw):
            t0 = time.perf_counter()
            out = orig_save_chain(directory, flat, epoch, **kw)
            commits.append(dict(out, seconds=time.perf_counter() - t0))
            return out

        checkpoint.save_chain = timed_save_chain
        sd = str(root / "stream")
        snap_ms, on_ms, fps = [], [], {}
        ac = ckpt_stream.AsyncCheckpointer(sd, snapshot_every_steps=1,
                                           full_every=2)
        try:
            first = CKPT_SAVE_AT + CKPT_RESUME_STEPS
            for i, b in enumerate(stream):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _sgd_step(model, opt, b)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state = checkpoint.model_state(model, opt)
                ac.snapshot(state, first + i + 1)
                t2 = time.perf_counter()
                # The live state at snapshot time, before the next step
                # updates it in place.
                fps[first + i + 1] = _state_fingerprints(state)
                snap_ms.append((t2 - t1) * 1e3)
                on_ms.append((t2 - t0) * 1e3)
            t0 = time.perf_counter()
            ac.flush(timeout=600)
            flush_s = time.perf_counter() - t0
        finally:
            ac.close()
            checkpoint.save_chain = orig_save_chain
        stream_bytes = _dir_bytes(sd)
        tip = checkpoint.latest_epoch(sd)
        like = checkpoint.model_state(model, opt)
        t0 = time.perf_counter()
        restored = checkpoint.restore(sd, tip, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        live = dict(checkpoint.leaves_with_keys(like))
        tip_equal = all(torch.equal(v, live[k]) for k, v in
                        checkpoint.leaves_with_keys(restored)
                        if isinstance(v, torch.Tensor))
        del restored
        _free()
        committed_ok = {}
        for c in commits:
            e = c["epoch"]
            flat = checkpoint.read_chain_state(sd, e)
            committed_ok[e] = (_flat_fingerprints(flat, fps[e], "cuda")
                               == fps[e])
            del flat
        launches = dict(_cuda.LAUNCHES)
        off_ms = [t * 1e3 for t in times_a + times_b]
        print(f"checkpoint: stream (snapshot every step, full_every 2) over "
              f"{STREAM_STEPS} steps: snapshot device->host ms "
              + ", ".join(f"{x:.1f}" for x in snap_ms)
              + "; commits " + ", ".join(
                  f"epoch {c['epoch']} {c['kind']} {c['nbytes']} bytes "
                  f"{c['seconds']:.2f} s" for c in commits)
              + f"; flush {flush_s:.2f} s; {stream_bytes} bytes on disk; "
              f"tip epoch {tip} restored in {restore_s:.2f} s, "
              f"{'bit-identical to' if tip_equal else 'DIFFERENT from'} the "
              f"snapshotted state; each commit against its snapshot "
              f"{committed_ok}")
        print(f"checkpoint: step ms with the stream on (step + snapshot) "
              + ", ".join(f"{x:.1f}" for x in on_ms) + " (median "
              f"{statistics.median(on_ms):.1f}), off "
              + ", ".join(f"{x:.1f}" for x in off_ms) + " (median "
              f"{statistics.median(off_ms):.1f}); peak host RSS "
              f"{_peak_rss_gib():.2f} GiB; free disk "
              f"{shutil.disk_usage(root).free / 2 ** 30:.1f} GiB; launches "
              f"{launches}")
        _check(tip == first + STREAM_STEPS,
               f"checkpoint: the stream's tip is epoch {tip}, expected "
               f"{first + STREAM_STEPS}")
        _check(tip_equal, "checkpoint: the restored tip differs from the "
               "snapshotted state")
        _check(commits and all(committed_ok.values()),
               f"checkpoint: a committed epoch differs from its snapshot: "
               f"{committed_ok}")
        steps = CKPT_SAVE_AT + 2 * CKPT_RESUME_STEPS + STREAM_STEPS
        for name in FLASH:
            _check(launches[name] == depth * steps,
                   f"checkpoint: {name} launched {launches[name]} times, "
                   f"expected {depth * steps}")
        del model, opt, like, live
        return {"state_bytes": state_bytes, "save_s": save_s,
                "load_s": load_s, "snapshot_ms": snap_ms,
                "commits": commits, "restore_s": restore_s,
                "on_ms": on_ms, "off_ms": off_ms}
    finally:
        checkpoint.save_chain = orig_save_chain
        shutil.rmtree(root, ignore_errors=True)


def _elastic_emit(kind: str, **kw) -> None:
    """One ``ELASTIC {json}`` line in one write: the job's processes share
    the launcher's stdout."""
    sys.stdout.flush()
    os.write(1, ("ELASTIC " + json.dumps(dict(kind=kind, **kw)) + "\n")
             .encode())


def _elastic_events(out: str) -> list:
    """The ``ELASTIC`` events in a job's stdout, wherever another
    process's output split their lines."""
    dec = json.JSONDecoder()
    events = []
    for chunk in out.split("ELASTIC ")[1:]:
        try:
            events.append(dec.raw_decode(chunk)[0])
        except ValueError:
            _fail(f"elastic job: a garbled event {chunk[:200]!r}")
    return events


def _elastic_worker() -> None:
    """Phases 28, 35 and 36 in one process of the launcher's job
    (``chip_smoke.py --elastic-worker``; ``CHIP_SMOKE_ELASTIC_MODE``
    ``loss``, ``evict`` or ``autoscale``): the headline model through
    ``run_elastic`` with ``DistributedOptimizer(eager=True)``, each rank
    on its own batch.  ``loss``: rank ``ELASTIC_DIE_RANK`` kills itself at
    step ``ELASTIC_DIE_STEP`` of generation 0; a smaller generation waits
    for the standby, which parks only once the survivors have
    reconfigured.  ``evict``: process 1 (not a standby) is the planted
    straggler; rank 0 commits epoch 0 before the first step, generation 0
    trains until the fleet policy reconfigures the job.  ``autoscale``:
    rank 0 writes each target of ``AUTOSCALE_FILE`` after a committed
    snapshot.  Every re-entry and every generation's steps and P1-P3
    launches are reported; an aborted process prints ``ABORTED`` and
    exits 3.  Lines ``ELASTIC {json}`` report to the parent."""
    import signal
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, cpp_core, elastic
    from horovod_tpu_torch.ops import _cuda
    d = os.environ["CHIP_SMOKE_ELASTIC_DIR"]
    mode = os.environ.get("CHIP_SMOKE_ELASTIC_MODE", "loss")
    pidx = int(os.environ["HOROVOD_TPU_PROCESS_INDEX"])
    marker = os.path.join(d, "reconfigured")
    committed = os.path.join(d, "committed")
    if elastic.is_standby() and mode in ("loss", "evict"):
        # loss: park once the survivors have reconfigured; evict: once
        # epoch 0 is on disk (the launcher's first standby only).
        wait_for = marker if mode == "loss" else committed
        deadline = time.monotonic() + 600
        while not os.path.exists(wait_for):
            if time.monotonic() > deadline:
                sys.exit(f"elastic worker: {wait_for} never appeared")
            time.sleep(0.1)
    if elastic.is_standby() and mode == "autoscale":
        open(os.path.join(d, f"parked.{pidx}"), "w").close()
    if mode == "evict" and pidx == 1 and not elastic.is_standby():
        spec = f"slow:rank=1:ms={EVICT_MS}:tick={EVICT_ONSET_TICK}"
        os.environ.update(HOROVOD_TPU_FAULT=spec)
        _elastic_emit("fault", pidx=pidx, spec=spec)
    elastic.init()
    if mode != "loss":
        # The policy's records must outlive the ticks of a generation's
        # last step, after which rank 0 reads them.
        cpp_core.flight_set_capacity(1 << 18)
    dev = torch.device("cuda", torch.cuda.current_device())
    model = _lm("flash", DEPTH, SEQ, dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        eager=True)
    # A zero momentum gives SGD's first update bit for bit, and the state
    # its whole structure from the start (the restore template).
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    like = checkpoint.model_state(model, opt)
    times = {}

    def tick() -> int:
        return json.loads(cpp_core.flight_snapshot("tick"))["tick"]

    def set_target(n: int, step: int) -> None:
        """Rank 0: commit what is queued, then ask for ``n`` processes."""
        elastic.active_stream().flush()
        with open(os.path.join(d, "target"), "w") as f:
            f.write(f"{n}\n")
        _elastic_emit("target", n=n, step=step, tick=tick())

    def train(state, epoch):
        gen = elastic.generation()
        # hvd.size() can move before the generation does: the size read
        # at entry decides.
        size = hvd.size()
        checkpoint.load_model_state(model, opt, state)
        fps = _state_fingerprints(checkpoint.model_state(model, opt))
        _elastic_emit("reentry", rank=hvd.rank(), size=size, gen=gen,
                      epoch=epoch, fp=_digest(fps), card=dev.index,
                      pidx=pidx, group_rank=dist.get_rank()
                      if dist.is_initialized() else 0)
        if hvd.rank() == 0 and epoch >= 0:
            flat = checkpoint.read_chain_state(d, epoch)
            _elastic_emit("tip", gen=gen, epoch=epoch,
                          fp=_digest(_flat_fingerprints(flat, fps, dev)))
            del flat
        if gen > 0:
            open(marker, "w").close()
        gen_tok = torch.Generator(device=dev).manual_seed(
            SEED + 40 + hvd.rank())
        tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen_tok,
                               device=dev)
        launches0 = {k: _cuda.LAUNCHES[k] for k in FLASH}
        started = [0]
        loss = [None]

        def steps(first, count, until_change=False):
            """``count`` steps from ``first`` (with ``until_change``, then
            more until the membership changes, at most FLEET_WAIT_S, with
            no snapshot: the re-entry then waits for no write)."""
            deadline = time.monotonic() + FLEET_WAIT_S
            step = first
            while step < first + count or until_change:
                if elastic.generation() != gen:
                    raise hvd.HorovodRetryableError(
                        "membership changed between steps")
                if time.monotonic() > deadline:
                    sys.exit(f"elastic worker: no membership change within "
                             f"{FLEET_WAIT_S} s at generation {gen}")
                if (mode == "loss" and gen == 0
                        and hvd.rank() == ELASTIC_DIE_RANK
                        and step == ELASTIC_DIE_STEP):
                    torch.cuda.synchronize()
                    _elastic_emit("kill", rank=hvd.rank(), step=step)
                    os.kill(os.getpid(), signal.SIGKILL)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                started[0] += 1
                loss[0] = _sgd_step(model, opt, tokens)
                times.setdefault(gen, []).append(
                    (time.perf_counter() - t0) * 1e3)
                if not until_change:
                    elastic.snapshot(checkpoint.model_state(model, opt),
                                     step + 1)
                step += 1
            return step

        first = max(epoch, 0)
        try:
            if mode == "loss":
                deadline = time.monotonic() + 600
                # A generation of another size trains no step: it waits
                # for the next membership change.
                while size != ELASTIC_RANKS:
                    if elastic.generation() != gen:
                        raise hvd.HorovodRetryableError(
                            "membership changed while waiting for a "
                            "standby")
                    if time.monotonic() > deadline:
                        sys.exit("elastic worker: no standby was admitted")
                    time.sleep(0.05)
                steps(first, ELASTIC_STEPS - first)
            elif mode == "evict":
                if gen == 0 and epoch < 0 and hvd.rank() == 0:
                    stream = elastic.active_stream()
                    stream.snapshot(checkpoint.model_state(model, opt), 0)
                    stream.flush()
                    _elastic_emit("commit", epoch=0, tick=tick())
                    # FLEET_STEPS steps with the straggler, then the
                    # standby may park.
                    first = steps(first, FLEET_STEPS)
                    open(committed, "w").close()
                if gen == 0:
                    steps(first, 0, until_change=True)
                steps(first, FLEET_STEPS)
            else:
                if size == AUTOSCALE_RANKS and gen > 0:
                    steps(first, FLEET_STEPS)
                else:
                    step = steps(first, AUTOSCALE_STEPS)
                    if hvd.rank() == 0 and size == AUTOSCALE_RANKS:
                        set_target(AUTOSCALE_SMALL, step)
                    elif hvd.rank() == 0 and size == AUTOSCALE_SMALL:
                        # Grow once both parked processes are back as
                        # standbys, so that one reconfigure admits both.
                        wait = time.monotonic() + FLEET_WAIT_S
                        while (len([f for f in os.listdir(d)
                                    if f.startswith("parked.")])
                               < AUTOSCALE_RANKS - AUTOSCALE_SMALL
                               and time.monotonic() < wait):
                            time.sleep(0.2)
                        time.sleep(2.0)
                        set_target(AUTOSCALE_RANKS, step)
                    steps(step, 0, until_change=True)
        finally:
            torch.cuda.synchronize()
            _elastic_emit("generation", rank=hvd.rank(), gen=gen,
                          size=size, started=started[0], launches={
                              k: _cuda.LAUNCHES[k] - launches0[k]
                              for k in FLASH})
            if hvd.rank() == 0 and mode != "loss":
                # The policy's records of the reconfigure that just ended
                # this generation, read before the restore's ticks can
                # overwrite them in the ring.
                events = json.loads(cpp_core.flight_snapshot("policy"))
                _elastic_emit("policy", gen=gen, records=[
                    e for e in events["events"]
                    if e["kind"].startswith("policy.")])
        return loss[0]

    try:
        loss = elastic.run_elastic(train, directory=d, like=like)
    except hvd.HorovodAbortedError as exc:
        print(f"ABORTED rank={hvd.rank()} pidx={pidx} msg={exc}",
              flush=True)
        _elastic_emit("aborted", rank=hvd.rank(), pidx=pidx, msg=str(exc))
        sys.exit(3)
    hist = hvd.metrics()["histograms"]

    def h(name):
        x = hist.get(name, {})
        return {"count": x.get("count", 0), "sum": x.get("sum", 0.0)}

    counters = cpp_core.metrics_snapshot().get("counters", {})
    _elastic_emit("done", rank=hvd.rank(), size=hvd.size(),
                  gen=elastic.generation(), loss=loss, pidx=pidx,
                  fp=_digest(_state_fingerprints(
                      checkpoint.model_state(model, opt))),
                  step_ms={g: [round(t, 1) for t in ts]
                           for g, ts in times.items()},
                  downtime=h("elastic.downtime_seconds"),
                  resume=h("elastic.resume_seconds"),
                  rebuild=h("elastic.rebuild_seconds"),
                  snapshot=h("ckpt.snapshot_seconds"),
                  write=h("ckpt.write_seconds"),
                  policy={k: v for k, v in counters.items()
                          if k.startswith("policy.")})
    hvd.shutdown()


def _elastic_job(label: str, root: Path, launcher_args, env_extra: dict,
                 timeout: float = 900, worker: str = "--elastic-worker"):
    """Run ``python -m horovod_tpu_torch.run <launcher_args> --elastic
    --snapshot-every-steps 2 -- chip_smoke.py --elastic-worker`` in its
    own session with ``env_extra``; print its notes and events.  Returns
    (exit code, stdout, stderr, events, wall seconds).  With another
    ``worker`` (phase 38's ``--set-worker``) the job is not elastic."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_TPU_", "MASTER_", "TORCHELASTIC_"))}
    env.update(CHIP_SMOKE_ELASTIC_DIR=str(root), **env_extra)
    elastic = (["--elastic", "--snapshot-every-steps", "2"]
               if worker == "--elastic-worker" else [])
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", *launcher_args,
           *elastic, "--", sys.executable, os.path.abspath(__file__),
           worker]
    t0 = time.perf_counter()
    # Its own session, so that a job which does not end is stopped whole:
    # the launcher, its workers and its standbys.
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        _fail(f"{label}: no end within {timeout:.0f} s; stderr tail "
              f"{err[-3000:]}")
    wall_s = time.perf_counter() - t0
    events = _elastic_events(out)
    notes = [line for line in err.splitlines()
             if any(t in line for t in (
                 "reconfigured to", "standby admitted", "rebuilt the",
                 "exited with code", "relaunched", "ABORT", "Error",
                 "FAILED", "fault injection", "htpu policy"))]
    print(f"{label}: " + "\n  ".join(notes[:40]))
    for e in events:
        if e["kind"] not in ("policy", "tenant", "publish"):
            print(f"{label}: {e}")
    _check(proc.returncode == 0,
           f"{label}: the launcher exited {proc.returncode}; stderr tail "
           f"{err[-3000:]}")
    return proc.returncode, out, err, events, wall_s


def _check_elastic_states(label: str, events, final_gen: int,
                          final_size: int) -> list:
    """The checks every elastic phase shares: the job ends at
    ``final_gen`` with ``final_size`` ranks on bit-identical states, and
    every re-entry after generation 0 restores the committed tip read from
    disk.  Returns the ``done`` events."""
    done = [e for e in events if e["kind"] == "done"]
    tips = {(e["gen"], e["epoch"]): e["fp"] for e in events
            if e["kind"] == "tip"}
    _check(len(done) == final_size
           and all(e["gen"] == final_gen and e["size"] == final_size
                   for e in done),
           f"{label}: the job did not end at generation {final_gen} with "
           f"{final_size} ranks: {done}")
    _check(len({e["fp"] for e in done}) == 1,
           f"{label}: the final states differ across ranks: "
           f"{[e['fp'] for e in done]}")
    for e in events:
        if e["kind"] == "reentry" and e["epoch"] >= 0:
            want = tips.get((e["gen"], e["epoch"]))
            _check(e["fp"] == want,
                   f"{label}: rank {e['rank']} restored {e['fp']} at "
                   f"generation {e['gen']}, epoch {e['epoch']}; the "
                   f"committed tip is {want}")
    return done


def _check_fleet_generations(label: str, events, gens) -> dict:
    """Every member of each generation in ``gens`` trained steps there,
    and every generation's P1-P3 launches are depth x its steps, each
    process in its own group seat on its own card.  Returns {gen: {rank:
    steps}}."""
    first_card = {}
    for e in events:
        if e["kind"] == "reentry":
            first_card.setdefault(e["pidx"], e["card"])
            _check(e["group_rank"] == e["rank"]
                   and e["card"] == first_card[e["pidx"]],
                   f"{label}: process {e['pidx']} at generation "
                   f"{e['gen']} is rank {e['rank']} but rank "
                   f"{e['group_rank']} of the NCCL group, or moved from "
                   f"card {first_card[e['pidx']]} to {e['card']}")
    trained = {}
    for e in events:
        if e["kind"] != "generation":
            continue
        trained.setdefault(e["gen"], {})[e["rank"]] = e["started"]
        _check((e["started"] > 0 or e["gen"] not in gens) and all(
            n == DEPTH * e["started"] for n in e["launches"].values()),
            f"{label}: rank {e['rank']} at generation {e['gen']} trained "
            f"{e['started']} steps with P1-P3 launches {e['launches']}, "
            f"not {DEPTH} x steps each")
    for g in gens:
        _check(g in trained, f"{label}: no rank trained at generation {g}")
    return trained


def phase_elastic_nccl():
    """Phase 28: the launcher's elastic job on four cards over NCCL (only
    with four or more cards; otherwise a line says it did not run)."""
    import shutil
    if torch.cuda.device_count() < 4:
        print("elastic nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    root = (CKPT_ROOT / "phase28").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        # The rejoin action admits a parked standby at the first tick
        # with a seat open: after the loss has shrunk the world.
        _, out, err, events, wall_s = _elastic_job(
            "elastic nccl", root,
            ["-np", str(ELASTIC_RANKS), "--num-standby", "1"],
            {"HOROVOD_TPU_FAULT": "rejoin:rank=0:tick=1"})
        _check("ABORTED" not in out + err,
               "elastic nccl: a rank was aborted")
        reentries = [e for e in events if e["kind"] == "reentry"]
        done = _check_elastic_states("elastic nccl", events, 2,
                                     ELASTIC_RANKS)
        gens = sorted({e["gen"] for e in reentries})
        _check(gens == [0, 1, 2] and {e["size"] for e in reentries
                                      if e["gen"] == 1} == {2},
               f"elastic nccl: generations {gens}, not 0 -> 1 (size 2) "
               f"-> 2")
        r0 = next(e for e in done if e["rank"] == 0)
        before = r0["step_ms"].get("0", [])
        after = r0["step_ms"].get("2", [])
        print(f"elastic nccl: {wall_s:.1f} s; generations 0 -> 1 (size 2) "
              f"-> 2 (size 3), every re-entry bit-identical to the "
              f"committed tip, final state bit-identical on "
              f"{len(done)} ranks; rank 0: step ms before the loss "
              f"{before}, after {after}; elastic.downtime_seconds "
              f"{r0['downtime']}, elastic.resume_seconds {r0['resume']}, "
              f"NCCL rebuild (elastic.rebuild_seconds) {r0['rebuild']}, "
              f"ckpt.snapshot_seconds {r0['snapshot']}, "
              f"ckpt.write_seconds {r0['write']}")
        return {"done": done, "reentries": reentries, "wall_s": wall_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _policy_records(events, kind: str) -> list:
    """The fleet policy's flight records of ``kind`` that rank 0 read at
    the end of each generation, each once."""
    seen = {}
    for e in events:
        if e["kind"] == "policy":
            for r in e["records"]:
                if r["kind"] == kind:
                    seen[(r["tick"], r["detail"])] = r
    return [seen[k] for k in sorted(seen)]


def phase_evict_nccl():
    """Phase 35: straggler eviction on phase 28's job (four cards; only
    with four or more, otherwise a line says it did not run).  Three
    processes and a parked standby; process 1 alone slows each of its
    ticks by ``EVICT_MS`` from tick ``EVICT_ONSET_TICK``; the fleet policy
    (threshold 20 ms for 5 ticks, one eviction, floor 3 ranks) demotes it
    and admits the standby in the same reconfigure."""
    import shutil
    if torch.cuda.device_count() < 4:
        print("evict nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    label = "evict nccl"
    root = (CKPT_ROOT / "phase35").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        _, out, err, events, wall_s = _elastic_job(
            label, root, ["-np", str(ELASTIC_RANKS), "--num-standby", "1",
                          "--elastic-min-ranks", str(ELASTIC_RANKS)],
            {"CHIP_SMOKE_ELASTIC_MODE": "evict",
             "HOROVOD_TPU_EVICT_THRESHOLD": "0.02",
             "HOROVOD_TPU_EVICT_TICKS": "5", "HOROVOD_TPU_EVICT_MAX": "1"})
        aborted = [e for e in events if e["kind"] == "aborted"]
        _check(len(aborted) == 1 and aborted[0]["pidx"] == 1
               and "evicted from the membership at generation 1 after: "
               "straggler rank 1 demoted to standby by fleet policy"
               in aborted[0]["msg"] and out.count("ABORTED") == 1,
               f"{label}: not the victim alone evicted: {aborted}")
        _check(err.count("relaunched as standby") == 1
               and "standby admitted at generation 1 as rank 2 of 3" in err
               and "rebuilt the nccl world group for generation 1" in err,
               f"{label}: the standby was not admitted in the eviction's "
               f"reconfigure, the victim not relaunched, or the NCCL group "
               f"not rebuilt")
        reentries = [e for e in events if e["kind"] == "reentry"
                     and e["gen"] == 1]
        _check(sorted(e["pidx"] for e in reentries) == [0, 2, 3]
               and {e["size"] for e in reentries} == {ELASTIC_RANKS}
               and all(e["epoch"] >= 0 for e in reentries),
               f"{label}: generation 1 is not processes 0, 2 and the "
               f"standby 3 at size {ELASTIC_RANKS} from a committed tip: "
               f"{reentries}")
        done = _check_elastic_states(label, events, 1, ELASTIC_RANKS)
        trained = _check_fleet_generations(label, events, (0, 1))
        commit = next(e for e in events if e["kind"] == "commit")
        evicts = _policy_records(events, "policy.evict")
        r0 = next(e for e in done if e["rank"] == 0)
        _check(r0["policy"].get("policy.evictions") == 1
               and len(evicts) == 1 and evicts[0]["a"] == 1,
               f"{label}: policy.evictions {r0['policy']}, records "
               f"{evicts}")
        onset = re.search(r"slowing rank 1 by \d+ms per tick from tick "
                          r"(\d+)", err)
        _check(onset is not None and commit["tick"] < evicts[0]["tick"]
               and int(onset.group(1)) < evicts[0]["tick"],
               f"{label}: epoch 0 committed at tick {commit['tick']}, the "
               f"slowdown began {onset and onset.group(0)}, the demotion "
               f"at tick {evicts[0]['tick']}")
        print(f"{label}: {wall_s:.1f} s; onset tick {onset.group(1)} "
              f"(epoch 0 committed at tick {commit['tick']}), demoted at "
              f"tick {evicts[0]['tick']} with the victim's EWMA "
              f"{evicts[0]['bytes'] / 1e3:.1f} ms ({evicts[0]['detail']}); "
              f"steps a rank: generation 0 {trained[0]}, 1 {trained[1]} "
              f"(P1-P3 {DEPTH} x steps each); rank 0 step ms before "
              f"{r0['step_ms'].get('0', [])}, after "
              f"{r0['step_ms'].get('1', [])}; elastic.downtime_seconds "
              f"{r0['downtime']}, elastic.rebuild_seconds {r0['rebuild']}, "
              f"elastic.resume_seconds {r0['resume']}; policy counters "
              f"{r0['policy']}")
        return {"done": done, "wall_s": wall_s, "trained": trained}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_autoscale_nccl():
    """Phase 36: scripted autoscaling on phase 28's job (four cards; only
    with four or more, otherwise a line says it did not run): four
    processes, ``HOROVOD_TPU_AUTOSCALE_FILE`` written by rank 0 (the
    file seam of ``--autoscale-script``, at chosen steps): 4 -> 2, the
    parked pair relaunched as standbys on the cards they freed, -> 4."""
    import shutil
    if torch.cuda.device_count() < 4:
        print("autoscale nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    label = "autoscale nccl"
    root = (CKPT_ROOT / "phase36").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        _, out, err, events, wall_s = _elastic_job(
            label, root, ["-np", str(AUTOSCALE_RANKS)],
            {"CHIP_SMOKE_ELASTIC_MODE": "autoscale",
             "HOROVOD_TPU_AUTOSCALE_FILE": str(root / "target")})
        shrink = f"autoscale: shrink to {AUTOSCALE_SMALL} process(es)"
        aborted = [e for e in events if e["kind"] == "aborted"]
        _check(sorted(e["pidx"] for e in aborted) == [2, 3]
               and all(shrink in e["msg"] for e in aborted),
               f"{label}: the shrink did not park processes 2 and 3 "
               f"alone: {aborted}")
        _check(err.count("relaunched as standby") == 2
               and f"reconfigured to {AUTOSCALE_SMALL} process(es) at "
               "generation 1" in err
               and f"autoscale: grow to {AUTOSCALE_RANKS} process(es)" in err,
               f"{label}: no shrink to {AUTOSCALE_SMALL}, relaunch of the "
               f"parked pair or grow to {AUTOSCALE_RANKS}")
        reentries = [e for e in events if e["kind"] == "reentry"]
        final_gen = max(e["gen"] for e in reentries)
        freed = {e["pidx"]: e["card"] for e in reentries
                 if e["gen"] == 0 and e["pidx"] in (2, 3)}
        back = {e["pidx"]: e["card"] for e in reentries
                if e["gen"] == final_gen and e["pidx"] >= AUTOSCALE_RANKS}
        _check(len(back) == 2 and sorted(back.values())
               == sorted(freed.values()),
               f"{label}: the relaunched standbys {back} are not on the "
               f"cards the parked pair freed {freed}")
        _check({e["size"] for e in reentries if e["gen"] == 1}
               == {AUTOSCALE_SMALL},
               f"{label}: generation 1 is not of size {AUTOSCALE_SMALL}")
        done = _check_elastic_states(label, events, final_gen,
                                     AUTOSCALE_RANKS)
        size_of = {e["gen"]: e["size"] for e in reentries}
        # The generations the targets asked for train their steps; one of
        # size 3 (the grow admitting one standby first) may not.
        trained = _check_fleet_generations(
            label, events, [g for g, n in size_of.items()
                            if n in (AUTOSCALE_RANKS, AUTOSCALE_SMALL)])
        rescales = _policy_records(events, "policy.rescale")
        targets = [e for e in events if e["kind"] == "target"]
        r0 = next(e for e in done if e["rank"] == 0)
        _check(r0["policy"].get("policy.rescales", 0) >= 2,
               f"{label}: policy counters {r0['policy']}")
        by_size = {}
        for g, ms in r0["step_ms"].items():
            by_size.setdefault(size_of[int(g)], []).extend(ms)
        asked = [(t["n"], t["step"], t["tick"]) for t in targets]
        print(f"{label}: {wall_s:.1f} s; targets written by rank 0 "
              f"(target, step, tick): {asked}; rescales (tick, what): "
              f"{[(r['tick'], r['detail']) for r in rescales]}; "
              f"generations {sorted(size_of.items())}; steps a rank "
              f"{trained}; relaunched standbys on cards {back}; rank 0 "
              f"step ms by size {by_size}; elastic.downtime_seconds "
              f"{r0['downtime']}, elastic.rebuild_seconds {r0['rebuild']}, "
              f"elastic.resume_seconds {r0['resume']}; policy counters "
              f"{r0['policy']}")
        return {"done": done, "wall_s": wall_s, "trained": trained}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _hist_median(h: dict):
    """The upper bound of the bucket that holds a native histogram's
    median (None when empty)."""
    counts, bounds = h.get("counts", []), h.get("bounds", [])
    total = sum(counts)
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if total and seen * 2 >= total:
            return bounds[i] if i < len(bounds) else math.inf
    return None


def _topo_train_worker(run: str, rank: int, port: int, results) -> None:
    """Phase 37 on one of four cards: the headline model from one seed,
    this rank's own batch, ``TOPO_STEPS`` steps through
    ``DistributedOptimizer(eager=True, overlap=True)`` under
    ``HOROVOD_TPU_CONTROL_TOPO`` = ``run`` without its trailing digits
    (``flat2`` is a second ``flat`` run), on fake host
    ``HIER_HOSTS[rank]``."""
    try:
        topo = run.rstrip("0123456789")
        os.environ.update({
            "HOROVOD_TPU_SIZE": "4", "HOROVOD_TPU_RANK": str(rank),
            "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_LOCAL_RANK": str(rank),
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{port + 1}",
            "HOROVOD_TPU_HOST_FINGERPRINT": HIER_HOSTS[rank],
            "HOROVOD_TPU_CONTROL_TOPO": topo,
            # One NCCL call a bucket, whatever the ticks' timing: the
            # scheduler's buckets are the same in every run.
            "HOROVOD_TPU_FUSION_THRESHOLD": "0"})
        import torch.distributed as dist
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import checkpoint
        from horovod_tpu_torch.ops import _cuda
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev).manual_seed(SEED + 50 + rank)
        tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                               device=dev)
        model, _, _ = _train_setup(DEPTH)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            eager=True, overlap=True)
        _cuda.reset_launches()
        losses, times = [], []
        for _ in range(TOPO_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            losses.append(_sgd_step(model, opt, tokens))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: _cuda.LAUNCHES[k] for k in FLASH}
        fps = _state_fingerprints(checkpoint.model_state(model, opt))
        m = hvd.metrics()
        out = {"losses": losses, "times_ms": times, "launches": launches,
               "fp": _digest(fps), "leaves": fps, "device": dev.index,
               "agg_depth": m["gauges"].get("control.agg_depth"),
               "merged_frames": m["counters"].get("control.merged_frames",
                                                  0),
               "tick_median_s": _hist_median(
                   m["histograms"].get("control.tick_seconds", {})),
               "ticks": m["counters"].get("control.ticks", 0)}
        hvd.shutdown()
        results.put((rank, out))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_topo_nccl():
    """Phase 37: the hierarchical control topology on four cards (only
    with four or more; otherwise a line says it did not run): four
    processes on fake hosts A, A, B, B train the headline model from one
    seed ``TOPO_STEPS`` steps under ``flat`` and under ``hier``; losses
    and final states bit-identical (else held to the difference between
    two ``flat`` runs), ``control.agg_depth`` 1.0 and 2.0, P1-P3 depth x
    steps."""
    import functools
    if torch.cuda.device_count() < 4:
        print("topo nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    label = "topo nccl"
    runs = {}
    for topo in ("flat", "hier"):
        got = _spawn(functools.partial(_topo_train_worker, topo), 4)
        _check(all(isinstance(got.get(r), dict) for r in range(4)),
               f"{label} ({topo}) failed: {got}")
        runs[topo] = got
    for topo, got in runs.items():
        want = 1.0 if topo == "flat" else 2.0
        for r in range(4):
            o = got[r]
            print(f"{label} {topo} rank {r} (cuda:{o['device']}, host "
                  f"{HIER_HOSTS[r]}): losses {o['losses']}, step ms "
                  f"{[round(t, 1) for t in o['times_ms']]}, "
                  f"control.tick_seconds median bucket <= "
                  f"{o['tick_median_s']} s over {o['ticks']} ticks, "
                  f"agg_depth {o['agg_depth']}, merged frames "
                  f"{o['merged_frames']}, P1-P3 {o['launches']}")
            _check(all(math.isfinite(x) for x in o["losses"])
                   and all(n == DEPTH * TOPO_STEPS
                           for n in o["launches"].values()),
                   f"{label} {topo} rank {r}: losses {o['losses']}, "
                   f"launches {o['launches']}")
        _check(got[0]["agg_depth"] == want,
               f"{label} {topo}: control.agg_depth {got[0]['agg_depth']}, "
               f"not {want}")
    _check(runs["hier"][0]["merged_frames"] > 0
           and runs["flat"][0]["merged_frames"] == 0,
           f"{label}: merged frames flat {runs['flat'][0]['merged_frames']}"
           f", hier {runs['hier'][0]['merged_frames']}")

    def distance(a: str, b: str):
        """(largest loss difference, leaves whose bits differ) over the
        ranks of runs ``a`` and ``b``."""
        loss = max(abs(x - y) for r in range(4) for x, y in zip(
            runs[a][r]["losses"], runs[b][r]["losses"]))
        leaves = max(sum(runs[a][r]["leaves"][k] != runs[b][r]["leaves"][k]
                         for k in runs[a][r]["leaves"]) for r in range(4))
        return loss, leaves

    hier_d = distance("flat", "hier")
    if hier_d == (0.0, 0):
        print(f"{label}: hier bit-identical to flat on every rank (losses "
              f"and every leaf of the final state)")
    else:
        got = _spawn(functools.partial(_topo_train_worker, "flat2"), 4)
        _check(all(isinstance(got.get(r), dict) for r in range(4)),
               f"{label} (second flat) failed: {got}")
        runs["flat2"] = got
        flat_d = distance("flat", "flat2")
        print(f"{label}: hier against flat: largest loss difference "
              f"{hier_d[0]:.3e}, {hier_d[1]} leaves differ; flat against "
              f"flat: {flat_d[0]:.3e}, {flat_d[1]} leaves")
        _check(hier_d[0] <= flat_d[0] and hier_d[1] <= flat_d[1],
               f"{label}: hier strays from flat further than two flat "
               f"runs from each other: {hier_d} against {flat_d}")
    return runs


# The phase-38 cases: (case, kind, numpy dtype, average, set-local root).
SET_CASES = (("sum", "allreduce", "float32", False, -1),
             ("avg", "allreduce", "float32", True, -1),
             ("iavg", "allreduce", "int32", True, -1),
             ("gather", "allgather", "float32", False, -1),
             ("bcast", "broadcast", "float32", False, 1))


def _set_contribution(tenant: int, local: int, case: str):
    """One member's seeded contribution to one case (numpy)."""
    import numpy as np
    rng = np.random.default_rng([tenant, local, [c[0] for c in SET_CASES]
                                 .index(case)])
    if case == "iavg":
        return rng.integers(-1000, 1000, size=SET_TIMED_N).astype(np.int32)
    if case == "gather":
        return rng.standard_normal((local + 1, 1024)).astype(np.float32)
    return (rng.standard_normal(SET_TIMED_N) * 5).astype(np.float32)


def _execute_host(kind: str, per, dtype: str, average: bool, root: int):
    """The reference's set data plane, ``execute_host``
    (``horovod_tpu/process_set.py:445-475``), in numpy: a sum in the
    entry's dtype, floats divided by the set's size, integers
    floor-divided, dim-0 concatenation, the set-local root's value."""
    import numpy as np
    if kind == "allreduce":
        out = np.sum(np.stack(per), axis=0, dtype=np.dtype(dtype))
        if average:
            out = ((out / len(per)).astype(dtype)
                   if np.issubdtype(np.dtype(dtype), np.floating)
                   else out // len(per))
        return out
    if kind == "allgather":
        return np.concatenate(per, axis=0)
    return per[root].copy()


def _sets_tenants_worker() -> None:
    """Phase 38 (a) in one process of the launcher's job: this rank's
    tenant runs every case at once under the same names as the other
    tenant, on CUDA tensors, and holds each result against
    ``_execute_host``; then times a 4 MiB allreduce over the set."""
    import numpy as np
    import horovod_tpu_torch as hvd
    hvd.init()
    rank = hvd.rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    tenant = rank // 2
    ps = hvd.process_set_by_name(SET_TENANTS[tenant])
    local = ps.rank()
    hvd.allreduce(torch.ones(1, device=dev), name="sets.start")
    handles = {}
    for case, kind, _, average, root in SET_CASES:
        x = torch.from_numpy(_set_contribution(tenant, local, case)).to(dev)
        if kind == "allreduce":
            handles[case] = hvd.allreduce_async(
                x, average=average, name=f"sets.{case}", process_set=ps)
        elif kind == "allgather":
            handles[case] = hvd.allgather_async(x, name=f"sets.{case}",
                                                process_set=ps)
        else:
            handles[case] = hvd.broadcast_async(x, root, name=f"sets.{case}",
                                                process_set=ps)
    bad, on_card = [], True
    for case, kind, dtype, average, root in SET_CASES:
        got = hvd.synchronize(handles[case])
        on_card = on_card and got.is_cuda
        want = _execute_host(kind, [_set_contribution(tenant, r, case)
                                    for r in range(ps.size())],
                             dtype, average, root)
        g = got.cpu().numpy()
        if g.dtype != want.dtype or g.shape != want.shape or \
                g.tobytes() != want.tobytes():
            bad.append(case)
    x = torch.ones(SET_TIMED_N, device=dev)
    for i in range(3):
        hvd.allreduce(x, name=f"sets.warm.{i}", process_set=ps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        hvd.allreduce(x, name=f"sets.timed.{i}", process_set=ps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e2
    counters = {k: v for k, v in hvd.metrics()["counters"].items()
                if k.startswith("control.set_requests#")}
    _elastic_emit("tenant", rank=rank, tenant=ps.name, local=local,
                  bad=bad, on_card=on_card, counters=counters,
                  allreduce_ms=ms, device=dev.index)
    hvd.allreduce(torch.ones(1, device=dev), name="sets.end")
    hvd.shutdown()


def _publish_leg(hvd, rank: int, directory: str, publishing: bool):
    """One leg of phase 38 (b): the headline model from ``SEED``, this
    rank's own batches, ``PUBLISH_STEPS`` steps through
    ``make_train_step`` on the world group; when ``publishing``, rank 0
    commits the parameters every ``PUBLISH_EVERY`` steps and ranks 2 and 3
    poll the ``serve`` publisher between steps.  Returns (losses, step
    seconds, launches, [(epoch, state)] published here)."""
    from horovod_tpu_torch import checkpoint, ckpt_stream
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.publish import ParameterPublisher
    from horovod_tpu_torch.spmd import make_train_step
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEED + 60 + rank)
    batches = [torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                             device=dev) for _ in range(PUBLISH_STEPS)]
    model = _lm("flash", DEPTH, SEQ, dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, _lm_loss, opt)
    # Every commit a base (each step changes every parameter, so a delta
    # would hold them all and a read replay two links).
    writer = (ckpt_stream.AsyncCheckpointer(directory, full_every=1)
              if publishing and rank == 0 else None)
    pub = (ParameterPublisher(directory, "serve")
           if publishing and rank >= 2 else None)
    published, losses, times = [], [], []
    torch.cuda.synchronize()
    hvd.allreduce(torch.ones(1, device=dev), name=f"leg.{publishing}.go")
    _cuda.reset_launches()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(step(b).item())
        if writer is not None and i % PUBLISH_EVERY == PUBLISH_EVERY - 1:
            # No snapshot coalesces over a commit still in flight: each
            # epoch reaches the disk, and the next waits for it here.
            if i >= PUBLISH_EVERY:
                writer.flush(timeout=600)
            writer.snapshot(checkpoint.model_state(model),
                            i // PUBLISH_EVERY)
        if pub is not None:
            out = pub.poll()
            if out is not None:
                published.append((pub.last_published_epoch, out))
        times.append(time.perf_counter() - t0)
    launches = {k: _cuda.LAUNCHES[k] for k in FLASH}
    if writer is not None:
        writer.close()
    del step, opt, model
    _free()
    return losses, times, launches, published


def _sets_publish_worker() -> None:
    """Phase 38 (b) in one process of the launcher's job: a baseline leg,
    a publishing leg, then the serving ranks hold every published state
    against ``read_chain_state`` of its epoch."""
    import numpy as np
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint
    directory = os.environ["CHIP_SMOKE_ELASTIC_DIR"]
    hvd.init()
    rank = hvd.rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    # Each commit's and each chain read's seconds (rank 0 writes, the
    # serving ranks read); the verification reads after the leg are not
    # counted.
    io_s = {"commit": [], "read": []}

    def timed(kind, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            io_s[kind].append(time.perf_counter() - t0)
            return out
        return call

    read_chain_state = checkpoint.read_chain_state
    checkpoint.save_chain = timed("commit", checkpoint.save_chain)
    checkpoint.read_chain_state = timed("read", read_chain_state)
    base = _publish_leg(hvd, rank, directory, False)
    pub = _publish_leg(hvd, rank, directory, True)
    # Every commit is on disk; the serving ranks' last poll streams the
    # tip if the loop did not.
    hvd.allreduce(torch.ones(1, device=dev), name="publish.committed")
    if rank >= 2:
        from horovod_tpu_torch.publish import ParameterPublisher
        last = ParameterPublisher(directory, "serve")
        last.last_published_epoch = max([e for e, _ in pub[3]] + [-1])
        out = last.poll()
        if out is not None:
            pub[3].append((last.last_published_epoch, out))
    snap = hvd.metrics()
    hists = snap["histograms"]
    verified = {}
    for epoch, out in pub[3]:
        want = read_chain_state(directory, epoch)
        verified[epoch] = sorted(out) == sorted(want) and all(
            np.asarray(out[k]).dtype == np.asarray(v).dtype
            and np.asarray(out[k]).shape == np.shape(v)
            and np.array_equal(np.asarray(out[k]).reshape(-1).view(np.uint8),
                               np.asarray(v).reshape(-1).view(np.uint8))
            for k, v in want.items())
        del want
    lat = hists.get("publish.latency_seconds", {})
    stale = hists.get("publish.staleness_seconds#process_set=serve", {})
    _elastic_emit(
        "publish", rank=rank, base_losses=base[0], losses=pub[0],
        base_s=base[1], pub_s=pub[1], base_launches=base[2],
        launches=pub[2], epochs=[e for e, _ in pub[3]], verified=verified,
        publishes=snap["counters"].get("publish.count", 0),
        bytes=snap["counters"].get("publish.bytes", 0),
        latency_s=[lat.get("sum", 0.0), lat.get("count", 0)],
        staleness_s=[stale.get("sum", 0.0), stale.get("count", 0)],
        io_s=io_s,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        rss_gib=_peak_rss_gib(), device=dev.index)
    del pub
    hvd.allreduce(torch.ones(1, device=dev), name="publish.end")
    hvd.shutdown()


def phase_sets_nccl():
    """Phase 38: process sets and the parameter publisher on four cards
    (only with four or more; otherwise a line says it did not run), both
    jobs through the launcher."""
    import shutil
    if torch.cuda.device_count() < 4:
        print("sets nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    label = "sets nccl"
    root = CKPT_ROOT / "phase38"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        _, _, _, events, wall = _elastic_job(
            f"{label} (a)", root, ["-np", "4"],
            {"HOROVOD_TPU_PROCESS_SETS": "tenantA:0,1;tenantB:2,3",
             "CHIP_SMOKE_SET_MODE": "tenants"}, timeout=300,
            worker="--set-worker")
        tenants = sorted((e for e in events if e["kind"] == "tenant"),
                         key=lambda e: e["rank"])
        _check(len(tenants) == 4, f"{label} (a): {len(tenants)} reports")
        for e in tenants:
            mine = f"control.set_requests#process_set={e['tenant']}"
            _check(not e["bad"] and e["on_card"]
                   and set(e["counters"]) == {mine},
                   f"{label} (a) rank {e['rank']}: cases differing from "
                   f"execute_host {e['bad']}, results on the card "
                   f"{e['on_card']}, set counters {e['counters']}")
        print(f"{label} (a): two tenants, {len(SET_CASES)} cases each at "
              f"once under the same names, every result equal to "
              f"execute_host bit for bit; 4 MiB set allreduce ms by rank "
              f"{[round(e['allreduce_ms'], 3) for e in tenants]}; job "
              f"{wall:.1f} s")
        _, _, _, events, wall = _elastic_job(
            f"{label} (b)", root, ["-np", "4"],
            {"HOROVOD_TPU_PROCESS_SETS": "serve:2,3",
             "CHIP_SMOKE_SET_MODE": "publish"}, timeout=900,
            worker="--set-worker")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    pubs = sorted((e for e in events if e["kind"] == "publish"),
                  key=lambda e: e["rank"])
    _check(len(pubs) == 4, f"{label} (b): {len(pubs)} reports")
    steps = PUBLISH_STEPS
    for e in pubs:
        # The first step of a leg warms up: the means and medians leave it
        # out.
        base_ms = statistics.mean(e["base_s"][1:]) * 1e3
        pub_ms = statistics.mean(e["pub_s"][1:]) * 1e3
        io = {k: [round(x, 2) for x in v] for k, v in e["io_s"].items() if v}
        print(f"{label} (b) rank {e['rank']} (cuda:{e['device']}): step ms "
              f"baseline {[round(t * 1e3, 1) for t in e['base_s']]} (mean "
              f"{base_ms:.1f}, median "
              f"{statistics.median(e['base_s'][1:]) * 1e3:.1f} after the "
              f"first), publishing {[round(t * 1e3, 1) for t in e['pub_s']]}"
              f" (mean {pub_ms:.1f}, median "
              f"{statistics.median(e['pub_s'][1:]) * 1e3:.1f}): "
              f"{(pub_ms - base_ms) / base_ms * 100:+.1f}% on the mean; "
              f"seconds of commits and chain reads {io}; peak device "
              f"memory {e['peak_gib']:.2f} GiB, host RSS "
              f"{e['rss_gib']:.2f} GiB; P1-P3 {e['launches']}")
        _check(e["losses"] == e["base_losses"]
               and all(math.isfinite(x) for x in e["losses"]),
               f"{label} (b) rank {e['rank']}: the publishing leg's losses "
               f"{e['losses']} differ from the baseline's "
               f"{e['base_losses']}")
        for launches in (e["base_launches"], e["launches"]):
            _check(all(n == DEPTH * steps for n in launches.values()),
                   f"{label} (b) rank {e['rank']}: P1-P3 launched "
                   f"{launches}, expected {DEPTH * steps} each")
    for e in pubs[2:]:
        n_lat, n_st = e["latency_s"][1], e["staleness_s"][1]
        print(f"{label} (b) rank {e['rank']}: {e['publishes']} publishes of "
              f"epochs {e['epochs']}, {e['bytes']} bytes; mean latency "
              f"{e['latency_s'][0] / max(n_lat, 1):.2f} s, mean staleness "
              f"{e['staleness_s'][0] / max(n_st, 1):.2f} s; each "
              f"bit-identical to read_chain_state of its epoch: "
              f"{e['verified']}")
        _check(e["publishes"] >= 2 and len(e["epochs"]) >= 2
               and all(e["verified"].get(str(x), e["verified"].get(x))
                       for x in e["epochs"]),
               f"{label} (b) rank {e['rank']}: publishes {e['epochs']}, "
               f"verified {e['verified']}")
    for e in pubs[:2]:
        _check(e["publishes"] == 0 and not e["epochs"],
               f"{label} (b) rank {e['rank']} published {e['epochs']}")
    print(f"{label} (b): the publishing leg's losses bit-identical to the "
          f"baseline's on every rank; job {wall:.1f} s")
    return pubs


def _spawn(target, n: int, timeout: float = 300) -> dict:
    """Run ``target(rank, port, results)`` in ``n`` spawned processes;
    {rank: result}, or an "exit"/"timeout" entry when a worker fails or
    ``timeout`` seconds pass without every result."""
    import queue
    import torch.multiprocessing as mp
    port = _free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < len(procs):
            try:
                rank, ok = results.get(timeout=5)
                got[rank] = ok
                if isinstance(ok, str):     # a worker's traceback
                    break
            except queue.Empty:
                if time.monotonic() > deadline:
                    got["timeout"] = f"no result within {timeout} s"
                    break
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    got["exit"] = f"a worker exited with {dead}"
                    break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return got


def _category(name: str) -> str:
    for kernel in GENERAL + FLASH + (FUSED, "int8_quantize",
                                     "int8_dequantize"):
        if f"{kernel}_" in name:   # P6's dq cast kernel counts as P6
            return kernel
    low = name.lower()
    if "nccl" in low:
        return "NCCL"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                              "cublas")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "copy", "fill")):
        return "elementwise and copies"
    return "other"


def _profile_step(step, batch, category=None, kernels=None):
    """One more step under the port's profiler (``profiling.capture``):
    device time by kernel and category (``_category`` unless given), and
    the device's busy share of the (profiled) step.  The kernel rows are
    ``profiling.device_events``: kernels and copies, never the annotation
    ranges that span them (each NCCL call's "nccl:all_reduce", the
    optimizer's "Optimizer.step#SGD.step", ...).  ``kernels``, a list,
    receives (name, ms, launches) of every kernel.  Returns (wall ms,
    kernel ms), None when the profiler recorded no device time."""
    import shutil
    import tempfile
    from horovod_tpu_torch import profiling
    category = category or _category
    walls = []

    def run():
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    log_dir = profiling.capture(run, warmup=0, iters=1,
                                log_dir=tempfile.mkdtemp(prefix="smoke"))
    table: dict = {}
    for e in profiling.device_events(profiling.load_trace_events(log_dir)):
        ms, n = table.get(e["name"], (0.0, 0))
        table[e["name"]] = (ms + float(e.get("dur", 0.0)) / 1e3, n + 1)
    shutil.rmtree(log_dir, ignore_errors=True)
    rows = [(name, ms, n) for name, (ms, n) in table.items()]
    if kernels is not None:
        kernels.extend(rows)
    wall_ms, busy = walls[0], sum(ms for _, ms, _ in rows)
    if not rows:
        print("profile: the profiler recorded no device time")
        return None
    print(f"profile: one step {wall_ms:.1f} ms wall under the profiler, "
          f"{busy:.1f} ms of kernels, device busy "
          f"{busy / wall_ms:.3f}")
    cats: dict = {}
    for name, ms, _ in rows:
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {ms:.2f} ms ({ms / busy:.3f} of kernel time)")
    for name, ms, n in sorted(rows, key=lambda k: -k[1])[:12]:
        print(f"  top: {ms:8.2f} ms x{n:<4d} {name[:90]}")
    return wall_ms, busy


# Phase 32: the device span of two captured headline steps must lie
# between their kernel time and 1.2 x the event-timed step (the profiler's
# own cost stretches the captured steps a little).
PROFILE_SLACK = 1.2
# Ops whose FLOPs torch.profiler counts: the cuBLAS kernels they launch
# must report FLOPs.
FLOP_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _run_example(args, timeout: float = 300) -> str:
    """``python -m horovod_tpu_torch.examples.<args>`` from the checkout,
    on the card; its standard output (the phase fails on a non-zero
    exit)."""
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples." + args[0],
         *args[1:]], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=timeout)
    _check(proc.returncode == 0,
           f"example {args}: exit {proc.returncode}\n{proc.stdout[-2000:]}"
           f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def phase_profiler(depth: int):
    """Phase 32: ``profiling.capture`` of two headline steps (after two
    warm-up steps and three event-timed ones), ``device_time_ms(per=2)``
    between the kernel time a step and ``PROFILE_SLACK`` x the
    event-timed step and the span of both never above the capture's wall
    time; the top roofline rows, cuBLAS rows with FLOPs; then the mnist
    and synthetic-benchmark example twins on the card."""
    import shutil
    import tempfile
    from horovod_tpu_torch import profiling
    from horovod_tpu_torch.spmd import make_train_step
    t_start = time.perf_counter()
    model, tokens, loss_fn = _train_setup(depth)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model, loss_fn, opt)
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    event_ms = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        step(tokens)
        b.record()
        b.synchronize()
        event_ms.append(a.elapsed_time(b))
    step_ms = statistics.median(event_ms)
    log_dir = tempfile.mkdtemp(prefix="smoke_profile")
    t0 = time.perf_counter()
    profiling.capture(lambda: step(tokens), warmup=0, iters=2,
                      log_dir=log_dir)
    wall_ms = (time.perf_counter() - t0) * 1e3
    span = profiling.device_time_ms(log_dir)
    dev_ms = profiling.device_time_ms(log_dir, per=2)
    kernel_ms = sum(float(e.get("dur", 0.0)) for e in profiling.device_events(
        profiling.load_trace_events(log_dir))) / 1e3 / 2
    rows = profiling.per_op_rooflines(log_dir)
    shutil.rmtree(log_dir, ignore_errors=True)
    _check(dev_ms is not None, "profiler: the trace has no device events")
    print(f"profiler: device_time_ms(per=2) {dev_ms:.2f} ms, kernels "
          f"{kernel_ms:.2f} ms a step, event-timed step {step_ms:.2f} ms "
          f"(median of 3: " + ", ".join(f"{x:.2f}" for x in event_ms)
          + f"), capture wall {wall_ms:.1f} ms for two steps (span "
          f"{span:.2f} ms)")
    profiling.print_rooflines(rows, top=12)
    cublas = [r for r in rows if _category(r["op"]) == "matmul (cuBLAS)"]
    flops_rows = [r for r in cublas if r["tflops_per_sec"] > 0]
    print(f"profiler: {len(cublas)} cuBLAS rows, {len(flops_rows)} with "
          f"FLOPs, holding {sum(r['ms'] for r in flops_rows):.2f} of "
          f"{sum(r['ms'] for r in cublas):.2f} ms; their sources "
          f"{sorted({r['source'] for r in cublas})}")
    _check(kernel_ms <= dev_ms + 1e-6
           and dev_ms <= step_ms * PROFILE_SLACK,
           f"profiler: device time {dev_ms} ms a step outside [kernels "
           f"{kernel_ms}, {PROFILE_SLACK} x step {step_ms}]")
    _check(span <= wall_ms, f"profiler: span {span} ms > wall {wall_ms} ms")
    _check(bool(flops_rows) and all(r["tflops_per_sec"] > 0 for r in cublas
                                    if r["source"] in FLOP_OPS),
           f"profiler: cuBLAS rows without FLOPs: {cublas}")
    del model, opt, step
    _free()
    out = _run_example(["mnist", "--epochs", "1"])
    acc = float(re.search(r"test accuracy: ([0-9.]+)", out).group(1))
    print(f"profiler: examples.mnist --epochs 1 on the card: test accuracy "
          f"{acc:.4f}")
    _check(acc > 0.9, f"examples.mnist: accuracy {acc} <= 0.9")
    out = _run_example(["synthetic_benchmark", "--num-iters", "2",
                        "--num-batches-per-iter", "2"])
    line = [x for x in out.splitlines() if x.startswith("Img/sec per rank")]
    print(f"profiler: examples.synthetic_benchmark: "
          + " | ".join(out.strip().splitlines()[-3:]))
    _check(bool(line), f"examples.synthetic_benchmark printed {out!r}")
    print(f"profiler: phase {time.perf_counter() - t_start:.1f} s")


# ------------------------------------------------- the precision autopilot

# Phases 33-34 arm the autopilot with HOROVOD_TPU_PRECISION_TICKS=2: each
# eligible leaf gets AUTO_REPORTS healthy reports, two rungs (fp32 ->
# bf16 -> int8), as bench.py's _injit_auto_leg feeds it.  AUTO_SPIKE is
# far above HOROVOD_TPU_PRECISION_THRESHOLD's default 0.05: one such
# report demotes its bucket to fp32.
AUTO_TICKS, AUTO_REPORTS, AUTO_SPIKE = 2, 4, 0.9
AUTO_RANKS = 4


@contextlib.contextmanager
def _autopilot():
    """Within the block, ``HOROVOD_TPU_PRECISION=auto`` with
    ``AUTO_TICKS`` and a fresh process-local autopilot (yielded)."""
    from horovod_tpu_torch import precision
    os.environ.update(HOROVOD_TPU_PRECISION="auto",
                      HOROVOD_TPU_PRECISION_TICKS=str(AUTO_TICKS))
    precision.reset_autopilot()
    try:
        yield precision.get_autopilot()
    finally:
        for knob in ("HOROVOD_TPU_PRECISION", "HOROVOD_TPU_PRECISION_TICKS"):
            os.environ.pop(knob, None)
        precision.reset_autopilot()


def _auto_leaves(model):
    """(bucket name, parameter) of every trainable parameter, named as
    ``make_train_step(compression="auto")`` names them, and the names of
    the f32 int8-eligible ones (the leaves whose residual is measured)."""
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.spmd import bucket_names
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    leaves = list(zip(bucket_names([n for n, _ in named]),
                      [p for _, p in named]))
    eligible = [n for n, p in leaves if p.dtype == torch.float32
                and qc.int8_eligible(p.shape, p.dtype)]
    return leaves, eligible


def _plain_residual(g) -> float:
    """The int8-grid residual ``||g - Q(g)|| / ||g||`` of one f32 leaf, Q
    on the plain codec (no kernel launch), as
    ``optimizer._note_auto_residual`` measures it on P4 and P5."""
    g = g.reshape(-1)
    denom = float(torch.linalg.vector_norm(g))
    if denom <= 0.0:
        return 0.0
    return float(torch.linalg.vector_norm(g - _snap_plain(g))) / denom


def _uncounted(fn):
    """``fn()`` with the kernels' launch counts left as they were: for
    launches that compare a kernel with its plain version."""
    from horovod_tpu_torch.ops import _cuda
    saved = dict(_cuda.LAUNCHES)
    try:
        return fn()
    finally:
        _cuda.LAUNCHES.update(saved)


def _feed_ladder(eligible, grads, twin, label) -> int:
    """``AUTO_REPORTS`` residual reports of each eligible leaf's gradient
    (``grads[name]``): the autopilot's measured by the port
    (``optimizer._note_auto_residual``, one P4 and one P5 launch through
    ``snap_to_grid``), its ``policy.FleetPolicy`` twin's on the plain
    codec.  Each leaf's ``snap_to_grid`` is held against the plain codec
    bit for bit, outside the launch counts.  The number of port
    measurements."""
    from horovod_tpu_torch.ops import quantized_collectives as qc
    from horovod_tpu_torch.optimizer import _note_auto_residual
    measured = 0
    for name in eligible:
        g = grads[name].reshape(-1)
        _check(_uncounted(lambda: _bits_equal(qc.snap_to_grid(g),
                                              _snap_plain(g))),
               f"{label} {name}: snap_to_grid on P4/P5 differs from the "
               "plain codec")
        rel = _plain_residual(g)
        for _ in range(AUTO_REPORTS):
            _note_auto_residual(name, grads[name])
            twin.observe_precision(name, rel)
            measured += 1
    return measured


def _by_wire(route) -> dict:
    out = {}
    for wire in route:
        key = wire or "fp32"
        out[key] = out.get(key, 0) + 1
    return out


def phase_train_auto(depth: int, plain: dict) -> dict:
    """Phase 33: the headline step through ``make_train_step(compression=
    "auto")`` under ``HOROVOD_TPU_PRECISION=auto``; the ladder warmed
    from the first step's gradients, a residual spike at the end.  At
    world size 1 the step reduces nothing, so this phase holds the
    ladder, the route and its rebuilds; the P4/P5 launches it counts are
    the port's residual measurements, and phase 34 holds the reduction."""
    from horovod_tpu_torch import policy
    from horovod_tpu_torch.ops import _cuda
    from horovod_tpu_torch.spmd import make_train_step
    label = "train auto"
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2 ** 30
    with _autopilot() as pilot:
        twin = policy.FleetPolicy()
        model, tokens, loss_fn = _train_setup(depth)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, loss_fn, opt, compression="auto")
        leaves, eligible = _auto_leaves(model)
        _check(len(eligible) == 3 + 4 * depth,
               f"{label}: {len(eligible)} eligible f32 leaves, expected "
               f"{3 + 4 * depth}")
        losses, times = [], []

        def timed(batch):
            t0 = time.perf_counter()
            loss = step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())

        torch.cuda.synchronize()
        _cuda.reset_launches()
        timed(tokens)                        # warm-up 1, on the fp32 plan
        grads = {n: p.grad for n, p in leaves}
        measured = _feed_ladder(eligible, grads, twin, label)
        del grads
        warm = {n: pilot.level_for(n) for n, _ in leaves}
        for _ in range(WARMUP + TIMED - 1):
            timed(tokens)
        launches = dict(_cuda.LAUNCHES)
        route = dict(step.route)
        rebuilds, version = step.rebuilds, pilot.plan_version
        promotions, demotions = pilot.promotions, pilot.demotions
        mismatched = [n for n, _ in leaves
                      if pilot.level_for(n) != twin.precision_level(n)
                      or route[n] != twin.precision_wire(n)]
        # The spike: one report far over the threshold demotes the leaf
        # on that report; the next call rebuilds its route.
        spiked = eligible[0]
        level_before = pilot.level_for(spiked)
        pilot.note_residual(spiked, AUTO_SPIKE)
        twin.observe_precision(spiked, AUTO_SPIKE)
        level_after = pilot.level_for(spiked)
        step(tokens)
        torch.cuda.synchronize()
        spike = {"leaf": spiked, "level": (level_before, level_after),
                 "demotions": pilot.demotions - demotions,
                 "rebuilt": step.rebuilds - rebuilds,
                 "wire": step.route[spiked],
                 "twin_level": twin.precision_level(spiked)}
    step_s = statistics.median(times[WARMUP:])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = WARMUP + TIMED
    per = {k: launches[k] / measured for k in ("int8_quantize",
                                               "int8_dequantize")}
    print(f"{label}: depth {depth}, make_train_step(compression='auto'), "
          f"HOROVOD_TPU_PRECISION=auto, TICKS {AUTO_TICKS}; losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + " (phase 7: " + ", ".join(f"{x:.4f}" for x in plain["losses"])
          + ")")
    print(f"{label}: buckets by wire {_by_wire(route.values())} of "
          f"{len(route)}; promotions {promotions}, demotions {demotions}, "
          f"rebuilds {rebuilds}, plan_version {version}; {measured} "
          f"residual measurements ({AUTO_REPORTS} of each of "
          f"{len(eligible)} eligible f32 leaves), P4/P5 launches a "
          f"measurement {per}")
    print(f"{label}: step {step_s * 1e3:.1f} ms against "
          f"{plain['step_s'] * 1e3:.1f} ms (phase 7; median of {TIMED}; "
          f"all " + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms), "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GiB ({held_gb:.2f} of it held by earlier "
          f"phases) against {plain['peak_gb']:.2f}, launches {launches}")
    print(f"{label}: spike {AUTO_SPIKE} on {spike['leaf']}: level "
          f"{spike['level'][0]} -> {spike['level'][1]} (twin "
          f"{spike['twin_level']}), demotions +{spike['demotions']}, next "
          f"call rebuilt {spike['rebuilt']} time(s), its wire "
          f"{spike['wire'] or 'fp32'}; {_clocks()}")
    _check(not mismatched, f"{label}: rungs differ from the FleetPolicy "
           f"twin's: {mismatched[:5]}")
    _check(1 not in warm.values(),
           f"{label}: a leaf stands at bf16 for the timed steps")
    _check(losses == plain["losses"],
           f"{label}: losses {losses} differ from phase 7's "
           f"{plain['losses']}")
    _check(rebuilds == 2 and version == promotions,
           f"{label}: rebuilds {rebuilds}, plan_version {version}, "
           f"promotions {promotions}")
    for name in FLASH:
        _check(launches[name] == depth * steps,
               f"{label}: {name} launched {launches[name]} times, expected "
               f"{depth * steps}")
    for name in ("int8_quantize", "int8_dequantize"):
        _check(launches[name] == measured,
               f"{label}: {name} launched {launches[name]} times, expected "
               f"one a measurement ({measured})")
    _check(spike["level"][1] == 0 and spike["twin_level"] == 0
           and spike["demotions"] == 1 and spike["rebuilt"] == 1
           and spike["wire"] == "",
           f"{label}: the spike did not demote and rebuild: {spike}")
    del model, opt, step
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "measured": measured, "route": route}


def _auto_reduce_ms(grads, route) -> dict:
    """The auto leg's reduction alone on ``grads``, ms (median of the last
    3 of 4): the int8 leaves through ``_reduce_auto``'s per-leaf rings and
    through the static int8 leg's bucketed rings, the other leaves
    through its fused casts, and the whole."""
    import torch.distributed as dist
    from horovod_tpu_torch import scheduler, spmd
    from horovod_tpu_torch.ops import quantized_collectives as qc
    ring = [i for i, (g, w) in enumerate(zip(grads, route))
            if w == "int8" and qc.int8_eligible(g.shape, g.dtype)]
    rest = [i for i in range(len(grads)) if i not in set(ring)]

    def auto(idx):
        return lambda: spmd._reduce_auto(
            [grads[i] for i in idx], [route[i] for i in idx], average=True,
            fuse=True, bucket_bytes=scheduler.bucket_bytes_from_env(),
            overlap=False, group=None, mesh=None)

    def timed(fn):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return round(statistics.median(times[1:]) * 1e3, 2)

    return {"int8 per leaf": timed(auto(ring)),
            "int8 bucketed": timed(lambda: spmd.reduce_gradients(
                [grads[i] for i in ring], compression="int8")),
            "rest fused": timed(auto(rest)),
            "whole": timed(auto(range(len(grads)))),
            "leaves": {"int8": len(ring), "rest": len(rest)}}


def _auto_nccl_worker(rank: int, port: int, results) -> None:
    """Phase 34 on one of four cards: the headline model on this rank's
    own batch through the static wires and "auto", the auto leg's first
    update against its per-leaf twin, then the eager route under
    "auto" against the raw eager route."""
    try:
        os.environ.update({
            "HOROVOD_TPU_SIZE": str(AUTO_RANKS),
            "HOROVOD_TPU_RANK": str(rank), "HOROVOD_TPU_LOCAL_SIZE": "1",
            "HOROVOD_TPU_COORD_ADDR": f"127.0.0.1:{port + 1}",
            "HOROVOD_TPU_PRECISION": "auto",
            "HOROVOD_TPU_PRECISION_TICKS": str(AUTO_TICKS)})
        os.environ.pop("HOROVOD_TPU_LOCAL_RANK", None)
        import torch.distributed as dist
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import basics, policy, precision, scheduler
        from horovod_tpu_torch import spmd
        from horovod_tpu_torch.core import ResponseType
        from horovod_tpu_torch.ops import _cuda, injit
        from horovod_tpu_torch.ops import quantized_collectives as qc
        from horovod_tpu_torch.spmd import make_train_step
        hvd.init(init_method=f"tcp://127.0.0.1:{port}")
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev).manual_seed(SEED + 40 + rank)
        tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                               device=dev)
        out = {"device": dev.index}
        pilot = precision.get_autopilot()

        def run(step, n, after_first=None):
            losses, times = [], []
            for i in range(n):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                loss = step(tokens)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
                if i == 0 and after_first is not None:
                    after_first()
            return {"losses": losses, "times_ms": [t * 1e3 for t in times],
                    "step_ms": statistics.median(times[2:]) * 1e3}

        for wire in ("fp32", "bf16", "int8"):
            _free()
            model, _, loss_fn = _train_setup(DEPTH)
            sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            step = make_train_step(model, loss_fn, sgd,
                                   compression="none" if wire == "fp32"
                                   else wire)
            out[wire] = run(step, 5)
            del model, sgd, step
        # The auto leg's twin: the same first step, each leaf reduced by
        # the route its rung names through the port's per-leaf functions.
        # Its gradients warm the ladder first: the residual of each
        # eligible leaf's reduced (rank-equal) gradient.
        _free()
        twin_model, _, loss_fn = _train_setup(DEPTH)
        twin_sgd = torch.optim.SGD(twin_model.parameters(), lr=0.01,
                                   momentum=0.9)
        loss_fn(twin_model, tokens).backward()
        leaves, eligible = _auto_leaves(twin_model)
        fleet = policy.FleetPolicy()
        _cuda.reset_launches()
        reduced = {n: injit.allreduce(p.grad, average=True)
                   for n, p in leaves if n in eligible}
        measured = _feed_ladder(eligible, reduced, fleet,
                                f"auto nccl rank {rank}")
        del reduced
        codec = {k: _cuda.LAUNCHES[k] for k in ("int8_quantize",
                                                "int8_dequantize")}
        route = {n: pilot.wire_dtype_for(n) for n, _ in leaves}
        casts = {}
        with torch.no_grad():
            for n, p in leaves:
                g, wire = p.grad, route[n]
                if wire == "int8" and qc.int8_eligible(g.shape, g.dtype):
                    p.grad = qc.quantized_ring_allreduce(
                        g.reshape(-1).to(torch.float32), average=True
                    ).reshape(g.shape).to(g.dtype)
                else:
                    dtype = torch.bfloat16 if wire == "bf16" else g.dtype
                    casts.setdefault(dtype, []).append(p)
            # The other leaves, each cast dtype's in one flat all-reduce
            # in parameter order: the scheduler's one bucket for them.
            for dtype, ps in casts.items():
                flat = torch.cat([p.grad.reshape(-1).to(dtype) for p in ps])
                _check(flat.numel() * flat.element_size()
                       <= scheduler.bucket_bytes_from_env(),
                       f"auto nccl rank {rank}: the {dtype} casts fill more "
                       "than one bucket")
                dist.all_reduce(flat)
                flat.div_(AUTO_RANKS)
                off = 0
                for p in ps:
                    k = p.grad.numel()
                    p.grad = flat[off:off + k].view(p.grad.shape).to(
                        p.grad.dtype)
                    off += k
        twin_sgd.step()
        _free()
        model, _, loss_fn = _train_setup(DEPTH)
        sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, loss_fn, sgd, compression="auto")
        first = {}

        def compare():
            first["same"] = all(
                _bits_equal(a.detach(), b.detach()) for a, b in
                zip(model.parameters(), twin_model.parameters()))

        _cuda.reset_launches()
        auto = run(step, 5, compare)
        auto["launches"] = dict(_cuda.LAUNCHES)
        del twin_model, twin_sgd
        auto["reduce_ms"] = _auto_reduce_ms(
            [p.grad.detach().clone() for p in model.parameters()
             if p.requires_grad], [step.route[n] for n, _ in leaves])
        plans = [None] * AUTO_RANKS
        dist.all_gather_object(plans, step.route)
        out["auto"] = dict(
            auto, first_update_same=first["same"],
            plan_same=all(pl == plans[0] for pl in plans),
            buckets_by_wire=_by_wire(step.route.values()),
            rebuilds=step.rebuilds, promotions=pilot.promotions,
            demotions=pilot.demotions, plan_version=pilot.plan_version,
            rungs_match=all(pilot.level_for(n) == fleet.precision_level(n)
                            for n, _ in leaves),
            measured=measured, codec_launches=codec)
        del model, sgd, step
        # The eager route with overlap, raw and then under "auto": the
        # residual reports ride the request frames, the coordinator stamps
        # each response, and NCCL moves the buckets raw all the same.
        ex = basics.controller()._executor
        plain_execute = ex.execute
        for label, comp in (("eager raw", "none"), ("eager auto", "auto")):
            _free()
            model, _, loss_fn = _train_setup(DEPTH)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                eager=True, overlap=True, compression=comp)
            seen = []

            def execute(resp, entries, seen=seen):
                if resp.response_type == ResponseType.ALLREDUCE:
                    seen.append((tuple(resp.tensor_names), resp.wire_dtype))
                return plain_execute(resp, entries)

            ex.execute = execute

            def eager_step(batch, opt=opt, model=model):
                opt.zero_grad()
                loss = loss_fn(model, batch)
                loss.backward()
                opt.step()
                return injit.allreduce(loss.detach(), average=True)

            _cuda.reset_launches()
            run_ = run(eager_step, 5)
            ex.execute = plain_execute
            views = [None] * AUTO_RANKS
            dist.all_gather_object(views, seen)
            out[label] = dict(run_, responses=_by_wire(w for _, w in seen),
                              stamps_same=all(v == views[0] for v in views),
                              launches=dict(_cuda.LAUNCHES))
            del model, opt, eager_step
        torch.cuda.synchronize()
        hvd.shutdown()
        results.put((rank, out))
    except BaseException as e:   # reported to the parent, which fails
        results.put((rank, repr(e)))
        raise


def phase_auto_nccl():
    """Phase 34: the precision autopilot on four cards (only with four or
    more; otherwise a line says it did not run)."""
    if torch.cuda.device_count() < AUTO_RANKS:
        print("auto nccl: not run (it needs four CUDA devices, this "
              f"machine has {torch.cuda.device_count()})")
        return None
    got = _spawn(_auto_nccl_worker, AUTO_RANKS, timeout=900)
    _check(all(isinstance(got.get(r), dict) for r in range(AUTO_RANKS)),
           f"auto nccl failed: {got}")
    flops = _model_flops(DEPTH)
    for r in range(AUTO_RANKS):
        o = got[r]
        for leg in ("fp32", "bf16", "int8", "auto", "eager raw",
                    "eager auto"):
            run = o[leg]
            step_s = run["step_ms"] / 1e3
            extra = ""
            if leg == "auto":
                extra = (f"; buckets by wire {run['buckets_by_wire']}, "
                         f"promotions {run['promotions']}, demotions "
                         f"{run['demotions']}, rebuilds {run['rebuilds']}, "
                         f"plan_version {run['plan_version']}, "
                         f"{run['measured']} measurements, codec launches "
                         f"{run['codec_launches']}; first update vs the "
                         f"per-leaf twin bit-identical "
                         f"{run['first_update_same']}; one plan on every "
                         f"rank {run['plan_same']}; launches "
                         f"{run['launches']}; the reduction alone, ms "
                         f"{run['reduce_ms']}")
            elif leg.startswith("eager"):
                extra = (f"; responses by wire dtype {run['responses']}, "
                         f"the same stamps on every rank "
                         f"{run['stamps_same']}; launches {run['launches']}")
            print(f"auto nccl rank {r} (cuda:{o['device']}), {leg}: step "
                  f"{run['step_ms']:.1f} ms (median of 3; all "
                  f"{[round(t, 1) for t in run['times_ms']]}), "
                  f"{BATCH * SEQ / step_s:.0f} tokens/s/GPU, MFU "
                  f"{flops / step_s / PEAK_BF16_FLOPS:.3f}, losses "
                  f"{[round(x, 5) for x in run['losses']]}{extra}")
        a = o["auto"]
        _check(a["first_update_same"], f"rank {r}: the auto leg's first "
               "update differs from its per-leaf twin's")
        _check(min(a["launches"][k] for k in ("int8_quantize",
                                              "int8_dequantize")) > 0,
               f"rank {r}: the auto leg launched no P4/P5: "
               f"{a['launches']}")
        _check(a["losses"][0] == o["fp32"]["losses"][0],
               f"rank {r}: auto first loss {a['losses'][0]} vs fp32 "
               f"{o['fp32']['losses'][0]}")
        _check(a["plan_same"] and a["rungs_match"],
               f"rank {r}: plan not the same on every rank, or rungs "
               "differ from the FleetPolicy twin's")
        _check(all(math.isfinite(x) for leg in ("fp32", "bf16", "int8",
                                                "auto")
                   for x in o[leg]["losses"]), f"rank {r}: non-finite loss")
        _check(o["eager auto"]["losses"] == o["eager raw"]["losses"],
               f"rank {r}: eager auto losses {o['eager auto']['losses']} "
               f"differ from the raw eager route's "
               f"{o['eager raw']['losses']}")
        _check(o["eager auto"]["stamps_same"] and o["eager raw"][
            "stamps_same"], f"rank {r}: ranks saw different wire stamps")
        _check(o["eager auto"]["launches"]["int8_quantize"] > 0,
               f"rank {r}: the eager auto route measured no residual")
    best = min(got[0][w]["step_ms"] for w in ("fp32", "bf16", "int8"))
    print(f"auto nccl: auto_vs_best_static "
          f"{got[0]['auto']['step_ms'] / best:.4f} (rank 0: auto "
          f"{got[0]['auto']['step_ms']:.1f} ms, best static {best:.1f} ms; "
          "printed, not gated)")
    return got


# Every TPU kernel of the JAX package (each function that reaches
# pl.pallas_call), in PERF.md's order, with the port kernel that replaces
# it.
TPU_KERNELS = (
    ("flash_fwd", "horovod_tpu/ops/flash_attention.py:255"),
    ("flash_fwd", "horovod_tpu/ops/flash_attention.py:351"),
    ("flash_fwd", "horovod_tpu/ops/flash_attention.py:418"),
    ("flash_bwd_dkdv", "horovod_tpu/ops/flash_attention.py:675"),
    ("flash_bwd_dq", "horovod_tpu/ops/flash_attention.py:730"),
    ("flash_bwd_dkdv", "horovod_tpu/ops/flash_attention.py:955"),
    ("flash_bwd_dq", "horovod_tpu/ops/flash_attention.py:1013"),
    (FUSED, "horovod_tpu/ops/flash_attention.py:776"),
    (FUSED, "horovod_tpu/ops/flash_attention.py:1152"),
    ("int8_quantize", "horovod_tpu/ops/quantized_collectives.py:166"),
    ("int8_dequantize", "horovod_tpu/ops/quantized_collectives.py:176"),
)
SOURCES = {
    "flash_fwd": "horovod_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dkdv": "horovod_tpu_torch/csrc/flash_bwd_dkdv.cu",
    "flash_bwd_dq": "horovod_tpu_torch/csrc/flash_bwd_dq.cu",
    FUSED: "horovod_tpu_torch/csrc/flash_bwd_fused.cu",
    "int8_quantize": "horovod_tpu_torch/csrc/int8_codec.cu",
    "int8_dequantize": "horovod_tpu_torch/csrc/int8_codec.cu",
    "general": "horovod_tpu_torch/csrc/flash_general.cu",
    "wide": "horovod_tpu_torch/csrc/flash_wide.cu",
}
SDPA_BWD = "scaled_dot_product_attention backward (dq, dk and dv)"


def main() -> None:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this needs a CUDA GPU")
    if sys.argv[1:] == ["--elastic-worker"]:
        _elastic_worker()      # one process of phase 28's launched job
        return
    if sys.argv[1:] == ["--set-worker"]:
        # One process of phase 38's launched jobs.
        {"tenants": _sets_tenants_worker, "publish": _sets_publish_worker}[
            os.environ["CHIP_SMOKE_SET_MODE"]]()
        return
    gpu = _gpu_line()
    usage = phase_device()
    import horovod_tpu_torch as hvd
    hvd.init()
    k = phase_kernels()
    phase_fused_kernel(k)
    general = phase_general()
    wide = phase_wide(usage)
    # Phases 22-26 run here, before this process holds much on card 0,
    # which rank 0 of the four-card group shares: the ring at batch 1
    # peaks at 50 GiB there, and after phase 21 this process held about
    # 30 GiB (four H100 80GB HBM3 at 700 W).
    _free()
    ulysses_shape = phase_parallel_one_card()
    _free()
    par = phase_parallel_nccl()
    _free()
    # Phases 27-28 and 34 also run while this process holds little on
    # card 0: phase 27 keeps two full-width training states there, and
    # rank 0 of phase 28's and phase 34's jobs shares the card (run last,
    # after this process held ~19 GiB there, phase 34's int8 and auto
    # legs took 454 and 687 ms a step against 255 and 300 alone; four
    # H100 80GB HBM3 at 700.00 W).
    phase_checkpoint(DEPTH)
    _free()
    phase_elastic_nccl()
    _free()
    auto_nccl = phase_auto_nccl()
    _free()
    # Phases 35-37 also run while this process holds little on card 0.
    phase_evict_nccl()
    _free()
    phase_autoscale_nccl()
    _free()
    phase_topo_nccl()
    _free()
    phase_sets_nccl()
    _free()
    f32_launches = phase_models_f32()
    _free()
    phase_reference()
    plain = phase_train(DEPTH)
    _free()
    one = phase_train(DEPTH, one_pass=True)
    check_one_pass(one, plain)
    _free()
    phase_xent(DEPTH, plain)
    phase_routing()
    _free()
    codec = phase_codec()
    phase_ring()
    int8 = phase_train_int8(DEPTH, plain)
    phase_nccl_ring()
    _free()
    phase_resnet_steps_per_call()
    phase_resnet_cpu()
    phase_resnet()
    _free()
    phase_inception_cpu()
    _free()
    phase_zoo_train("inception_v3")
    _free()
    phase_vgg16_cpu()
    _free()
    phase_zoo_train("vgg16")
    _free()
    phase_hierarchical_nccl()
    phase_eager()
    phase_eager_nccl()
    phase_train_eager(DEPTH, plain, int8)
    phase_eager_train_nccl()
    _free()
    phase_profiler(DEPTH)
    _free()
    phase_train_auto(DEPTH, plain)
    t, e = k["times"], k["errs"]
    flash = {
        "flash_fwd": (t["fwd"], t["fwd_plain"], e["o"], t["sdpa_fwd"],
                      "scaled_dot_product_attention forward",
                      plain["launches"]),
        "flash_bwd_dkdv": (t["dkdv"], t["dkdv_plain"], e["dkdv_abs"],
                           t["sdpa_bwd"], SDPA_BWD, plain["launches"]),
        "flash_bwd_dq": (t["dq"], t["dq_plain"], e["dq_abs"], t["sdpa_bwd"],
                         SDPA_BWD, plain["launches"]),
        FUSED: (t[FUSED], t[FUSED + "_plain"], e[FUSED], t["sdpa_bwd"],
                SDPA_BWD, one["launches"]),
    }
    rows = []
    for name, rep in TPU_KERNELS:
        if name in flash:
            ms, plain_ms, err, lib, call, launches = flash[name]
            flops, nbytes = k["work"][name]
            row = _kernel_row(name, rep, SOURCES[name], launches[name], err,
                              ms, plain_ms, flops, nbytes, lib, call,
                              usage[name])
            if name in ulysses_shape:
                # The same kernel at the shape ulysses_flash gives it on
                # four cards, and its launches there (one rank's).
                row.update({f"{k}_ulysses_flash": v
                            for k, v in ulysses_shape[name].items()})
                row["launches_ulysses_flash"] = (
                    par[0]["sp"]["launches"][name] if par else None)
                row["launches_pipeline"] = (
                    par[0]["pp"]["launches"][name] if par else None)
            rows.append(row)
            continue
        lib, call = None, None
        if name == "int8_dequantize":
            lib = codec["times"]["int8_dequantize_library"]
            call = "torch.mul (int8 x f32 promotion)"
        flops, nbytes = codec["work"][name]
        rows.append(dict(_kernel_row(
            name, rep, SOURCES[name], int8["launches"][name], codec["err"],
            codec["times"][name], codec["times"][name + "_plain"], flops,
            nbytes, lib, call, usage[name], peak_flops=PEAK_F32_FLOPS),
            # Under "auto", phase 34's auto leg and its eager route
            # (rank 0, 5 steps; null on fewer than four cards).
            launches_auto=(auto_nccl[0]["auto"]["launches"][name]
                           if auto_nccl else None),
            launches_auto_eager=(auto_nccl[0]["eager auto"]["launches"][name]
                                 if auto_nccl else None)))
    # The general family: the same TPU kernels, for the inputs P1-P3 do
    # not take; timed in f32 at the training shape, launched by the f32
    # models.
    gt, ge = general["times"], general["errs"]
    for name, rep, plain_key, err, lib, call in (
            ("flash_fwd_general", "horovod_tpu/ops/flash_attention.py:255",
             "fwd_plain", ge["o_abs"], gt["sdpa_fwd"],
             "scaled_dot_product_attention forward, f32"),
            ("flash_bwd_dkdv_general",
             "horovod_tpu/ops/flash_attention.py:675", "dkdv_plain",
             ge["grad_abs"], gt["sdpa_bwd"], SDPA_BWD + ", f32"),
            ("flash_bwd_dq_general", "horovod_tpu/ops/flash_attention.py:730",
             "dq_plain", ge["grad_abs"], gt["sdpa_bwd"], SDPA_BWD + ", f32")):
        flops, nbytes = general["work"][name]
        rows.append(dict(_kernel_row(
            name, rep, SOURCES["general"], f32_launches[name], err, gt[name],
            gt[plain_key], flops, nbytes, lib, call, usage[name],
            peak_flops=PEAK_TF32_FLOPS / 3),   # three TF32 products a term
            bound_ffma_ms=general["bounds"][name]["ffma"]))
    # The wide route: the same TPU kernels at head sizes above 256, timed
    # in f32 at WIDE_FULL_CASE (and WIDE_CASE beside it), launched by the
    # f32 model at D 384.
    wt, we = wide["full"]["times"], wide["full"]["errs"]
    st, sd = wide["small"]["times"], wide["small"]["device"]
    for name, rep, plain_key, err, lib, call, status in (
            ("flash_fwd_wide", "horovod_tpu/ops/flash_attention.py:255",
             "fwd_plain", we["o_abs"], "sdpa_fwd",
             "scaled_dot_product_attention forward, f32",
             "redesigned PR 12"),
            ("flash_bwd_dkdv_wide", "horovod_tpu/ops/flash_attention.py:675",
             "dkdv_plain", we["grad_abs"], "sdpa_bwd", SDPA_BWD + ", f32",
             "redesigned PR 12"),
            ("flash_bwd_dq_wide", "horovod_tpu/ops/flash_attention.py:730",
             "dq_plain", we["grad_abs"], "sdpa_bwd", SDPA_BWD + ", f32",
             "redesigned PR 13")):
        flops, nbytes = wide["full"]["work"][name]
        # f32 attention's least time is on the tensor cores at three TF32
        # products a term, as for G1-G3; the FFMA time beside it.
        rows.append(dict(_kernel_row(
            name, rep, SOURCES["wide"], f32_launches[name], err, wt[name],
            wt[plain_key], flops, nbytes, wt[lib], call, usage[name],
            peak_flops=PEAK_TF32_FLOPS / 3),
            bound_ffma_ms=flops / PEAK_F32_FLOPS * 1e3, status=status,
            shape="WIDE_FULL_CASE", ms_wide_case=st[name],
            device_ms_wide_case=sd[name],
            plain_ms_wide_case=st[plain_key], library_ms_wide_case=st[lib]))
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
