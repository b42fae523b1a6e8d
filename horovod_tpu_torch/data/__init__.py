"""Data sharding and device prefetch: the port of ``horovod_tpu.data``.

Each rank reads a disjoint ``1/size`` slice of the dataset, reshuffled per
epoch (:mod:`~horovod_tpu_torch.data.sharding`, a copy of the JAX
package's numpy code), and the next batch's host-to-device copy runs
while the current step computes (:mod:`~horovod_tpu_torch.data.prefetch`),
in windows of K stacked batches for ``distributed.window.run_steps``.
"""

from horovod_tpu_torch.data.prefetch import (prefetch_to_device,
                                             prefetch_windows,
                                             window_batches)
from horovod_tpu_torch.data.sharding import (DistributedSampler,
                                             iterate_sharded,
                                             shard_indices)

__all__ = [
    "DistributedSampler",
    "shard_indices",
    "iterate_sharded",
    "prefetch_to_device",
    "prefetch_windows",
    "window_batches",
]
