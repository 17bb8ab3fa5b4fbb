"""horovod_tpu_torch -- the PyTorch/CUDA port of ``horovod_tpu``.

Same framework, one process per NVIDIA GPU: topology from the launcher's
environment, gradients averaged over ``torch.distributed`` (NCCL), and the
JAX package's Pallas kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``).  The JAX package stays the reference; this package imports
nothing of it, nor JAX.

Ported so far: basics and topology with host groups, compression (cast
and int8), the bucket scheduler, the data-parallel train step
(:mod:`.spmd`: BatchNorm statistics synced across ranks, several steps a
call, eval, and the two-tier reduction over host groups of
:mod:`.parallel.mesh` and :mod:`.parallel.hierarchical`), the
``DistributedOptimizer`` surface (:mod:`.optimizer`) with the int8 gradient
wire and error feedback (:mod:`.ops.quantized_collectives`), the
TransformerLM and ResNet models (:mod:`.models`), flash attention
(:mod:`.ops.flash_attention`), the fused softmax cross-entropy
(:mod:`.ops.losses`), the negotiated eager collectives
(:mod:`.ops.eager` over the controller of :mod:`.core`) with the eager
gradient route through them (``DistributedOptimizer(eager=True)``,
bucketed overlap by :mod:`.scheduler`'s planner, sparse gradients by
:mod:`.sparse`), the training callbacks (:mod:`.callbacks`), the
observatory (:mod:`.observe`), the input pipeline (:mod:`.data`) and the
parallelism library (:mod:`.parallel`: ``build_mesh``, the collectives
with JAX's transposes, ring and Ulysses attention, tensor, pipeline and
expert parallelism, and TransformerLM's sequence- and tensor-parallel
modes), and resilience: checkpoint chains readable by both packages and
model save/load (:mod:`.checkpoint`), the async checkpoint stream
(:mod:`.ckpt_stream`), the launcher (:mod:`.run`) and elastic membership
(:mod:`.elastic`), and the multi-tenant planes: process sets
(:mod:`.process_set`, each over one host's processes) and the
parameter publisher (:mod:`.publish`)::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # cuda:local_rank, NCCL
    step = hvd.spmd.make_train_step(model, loss_fn, optimizer)
    loss = step(batch)
    step = hvd.spmd.make_train_step(model, loss_fn, optimizer,
                                    mesh=hvd.hierarchical_mesh())

    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.01,
                                                   momentum=0.9),
                                   compression=hvd.Compression.int8,
                                   error_feedback=True)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt.zero_grad(); loss_fn(model, batch).backward(); opt.step()

    opt = hvd.DistributedOptimizer(sgd, eager=True, overlap=True)
    for batch in hvd.ShardedLoader(batches):    # on this rank's GPU
        opt.zero_grad(); loss_fn(model, batch).backward(); opt.step()

    h = hvd.allreduce_async(metric, name="metric")   # negotiated, fused
    metric = hvd.synchronize(h)

    hvd.save_model(ckpt_dir, model, opt, epoch, optimizer=opt)   # rank 0
    model, opt, epoch = hvd.load_model(ckpt_dir, model)   # from the dir
    # python -m horovod_tpu_torch.run -np 3 --elastic --num-standby 1 \
    #     --snapshot-every-steps 2 -- python train.py
    hvd.elastic.run_elastic(train, directory=ckpt_dir, like=state)

    # HOROVOD_TPU_PROCESS_SETS="train:0,1;serve:2,3" on every process
    out = hvd.allreduce(x, name="eval", process_set="serve")
    state = hvd.ParameterPublisher(ckpt_dir, "serve").poll()  # 2 and 3
"""

from horovod_tpu_torch.basics import (      # noqa: F401
    NotInitializedError, controller, get_topology, hierarchical_mesh, init,
    is_initialized, local_rank, local_size, mpi_threads_supported,
    process_count, process_index, rank, shutdown, size, wire_dtype,
)
# The module itself is callable: hvd.metrics() is the merged snapshot
# (basics.metrics), hvd.metrics.registry the controller-side registry.
from horovod_tpu_torch import metrics       # noqa: F401
from horovod_tpu_torch.compression import Compression   # noqa: F401
from horovod_tpu_torch import spmd                        # noqa: F401
# Callable like metrics: hvd.observe() is the observatory's snapshot.
from horovod_tpu_torch import callbacks, data, observe, sparse  # noqa: F401
from horovod_tpu_torch.data import ShardedLoader            # noqa: F401
from horovod_tpu_torch.sparse import IndexedSlices         # noqa: F401
from horovod_tpu_torch.optimizer import (   # noqa: F401
    DistributedOptimizer, allreduce_, allreduce_gradients,
    broadcast_optimizer_state, broadcast_parameters,
)

from horovod_tpu_torch.ops.eager import (   # noqa: F401
    CollectiveError, HorovodAbortedError, HorovodRetryableError, PerRank,
    allgather, allgather_async, allreduce, allreduce_async, broadcast,
    broadcast_async, poll, scatter_ranks, synchronize,
)
# Resilience: checkpoint chains and model save/load, the async checkpoint
# stream and elastic membership (``python -m horovod_tpu_torch.run`` is
# the launcher).
from horovod_tpu_torch import checkpoint, ckpt_stream, elastic  # noqa: F401
from horovod_tpu_torch.checkpoint import load_model, save_model  # noqa: F401
# Multi-tenant process sets and the parameter-publish serving plane.
from horovod_tpu_torch.process_set import (      # noqa: F401
    ProcessSet, add_process_set, process_set_by_name,
    reconfigure_process_set, remove_process_set,
)
from horovod_tpu_torch.publish import ParameterPublisher   # noqa: F401

__version__ = "0.1.0"
