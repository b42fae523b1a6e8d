"""The Horovod surface of the port: ``import horovod_tpu_torch.distributed
as hvd``.

The counterpart of ``horovod_tpu.jax`` for data-parallel training over
``torch.distributed`` (NCCL on the card, gloo on the CPU): lifecycle
(:func:`init`, :func:`size`, :func:`rank`, ...), the Horovod
collectives (synchronous, asynchronous with a :class:`Handle`, and in
place), the SPMD harness (:func:`spmd`, :func:`spmd_fn`,
:func:`spmd_run`: inside it ``rank()`` is the index along the region's
axis and the collectives run over the axis and carry gradients), the fused
buckets with their hierarchical ladder and its int8/fp8 inter-host
codecs (:func:`resolve_hierarchical`, :func:`ef_residual_specs`,
:func:`hier_wire_summary`), :func:`DistributedOptimizer`, the
functional gradient API (:func:`grad`, :func:`value_and_grad`,
:func:`allreduce_gradients_transform`), the ZeRO-1
:func:`sharded_distributed_optimizer`, and the multi-step windows
:func:`run_steps` / :func:`windowed` (CUDA graph replays on the card).
"""

from horovod_tpu_torch import _HVD_NAMES
from horovod_tpu_torch.common.basics import (check_extension, init,
                                             is_initialized,
                                             local_rank, local_size, mesh,
                                             mpi_threads_supported,
                                             process_count, process_rank,
                                             rank, shutdown, size)
from horovod_tpu_torch.distributed.compression import (Compression,
                                                       is_dcn_wire)
from horovod_tpu_torch.distributed.fusion import (ef_residual_specs,
                                                  fused_reduce,
                                                  hier_bucket_layout,
                                                  hier_wire_summary,
                                                  plan_buckets,
                                                  plan_summary,
                                                  resolve_hierarchical)
from horovod_tpu_torch.distributed.mpi_ops import (
    Average, Handle, Max, Min, Product, Sum, allgather, allgather_async,
    allgatherv, allreduce, allreduce_, allreduce_async, allreduce_async_,
    allreduce_sparse, alltoall, broadcast, broadcast_, broadcast_async,
    broadcast_async_, broadcast_object, grouped_allreduce, poll,
    reducescatter, synchronize)
from horovod_tpu_torch.distributed.optimizer import (
    DistributedOptimizer, allreduce_gradients_transform,
    broadcast_optimizer_state, broadcast_parameters,
    ef_state_partition_specs, grad, value_and_grad)
from horovod_tpu_torch.distributed.window import run_steps, windowed
from horovod_tpu_torch.distributed.zero import (shard_info,
                                                sharded_distributed_optimizer)
from horovod_tpu_torch.parallel.spmd import spmd, spmd_fn, spmd_run

# The reference's TF-parity aliases.
broadcast_variables = broadcast_parameters
broadcast_global_variables = broadcast_parameters

# One list for this module and the package's top level, which offers the
# same names without importing torch.
__all__ = list(_HVD_NAMES)
