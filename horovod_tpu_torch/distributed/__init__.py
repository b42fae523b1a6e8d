"""The Horovod surface of the port: ``import horovod_tpu_torch.distributed
as hvd``.

The counterpart of ``horovod_tpu.jax`` for data-parallel training over
``torch.distributed`` (NCCL on the card, gloo on the CPU): lifecycle
(:func:`init`, :func:`size`, :func:`rank`, ...), collectives, the fused
buckets, :func:`DistributedOptimizer`, the ZeRO-1
:func:`sharded_distributed_optimizer`, and the multi-step windows
:func:`run_steps` / :func:`windowed` (CUDA graph replays on the card).
"""

from horovod_tpu_torch.common.basics import (init, is_initialized,
                                             local_rank, rank, shutdown,
                                             size)
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.fusion import (fused_reduce,
                                                  plan_buckets,
                                                  plan_summary)
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
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "sharded_distributed_optimizer",
    "shard_info", "run_steps", "windowed",
]
