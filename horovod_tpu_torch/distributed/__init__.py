"""The Horovod surface of the port: ``import horovod_tpu_torch.distributed
as hvd``.

The counterpart of ``horovod_tpu.jax`` for data-parallel training over
``torch.distributed`` (NCCL on the card, gloo on the CPU): lifecycle
(:func:`init`, :func:`size`, :func:`rank`, ...), collectives, the fused
buckets with their hierarchical ladder and its int8/fp8 inter-host
codecs (:func:`resolve_hierarchical`, :func:`ef_residual_specs`,
:func:`hier_wire_summary`), :func:`DistributedOptimizer`, the ZeRO-1
:func:`sharded_distributed_optimizer`, and the multi-step windows
:func:`run_steps` / :func:`windowed` (CUDA graph replays on the card).
"""

from horovod_tpu_torch.common.basics import (init, is_initialized,
                                             local_rank, rank, shutdown,
                                             size)
from horovod_tpu_torch.distributed.compression import (Compression,
                                                       is_dcn_wire)
from horovod_tpu_torch.distributed.fusion import (ef_residual_specs,
                                                  fused_reduce,
                                                  hier_bucket_layout,
                                                  hier_wire_summary,
                                                  plan_buckets,
                                                  plan_summary,
                                                  resolve_hierarchical)
from horovod_tpu_torch.distributed.mpi_ops import (Average, Max, Min,
                                                   Product, Sum, allgather,
                                                   allreduce,
                                                   allreduce_async,
                                                   broadcast,
                                                   broadcast_object,
                                                   synchronize)
from horovod_tpu_torch.distributed.optimizer import (
    DistributedOptimizer, broadcast_optimizer_state, broadcast_parameters)
from horovod_tpu_torch.distributed.window import run_steps, windowed
from horovod_tpu_torch.distributed.zero import (shard_info,
                                                sharded_distributed_optimizer)

__all__ = [
    "init", "shutdown", "is_initialized", "size", "rank", "local_rank",
    "Compression", "Sum", "Average", "Min", "Max", "Product", "allreduce",
    "allreduce_async", "synchronize", "broadcast", "broadcast_object",
    "allgather", "fused_reduce", "plan_buckets", "plan_summary",
    "is_dcn_wire", "resolve_hierarchical", "hier_bucket_layout",
    "ef_residual_specs", "hier_wire_summary",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "sharded_distributed_optimizer",
    "shard_info", "run_steps", "windowed",
]
