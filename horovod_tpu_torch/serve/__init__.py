"""Continuous-batching LM inference serving on PyTorch/CUDA
(`horovod_tpu_torch.serve`), the port of ``horovod_tpu.serve``.

* :mod:`~horovod_tpu_torch.serve.kvcache` — paged KV cache: fixed-size
  pages, a refcounted free-list allocator, per-request page tables,
  admission-control page math;
* :mod:`~horovod_tpu_torch.serve.engine` — the continuous-batching step
  loop (chunked prefill + decode lanes, in-flight join/leave, greedy +
  temperature/top-k sampling, greedy streams equal to ``lm_decode``),
  with the decode lane on the paged-attention kernel
  (``ServeConfig(attention="paged")``) or the gather reference;
* :mod:`~horovod_tpu_torch.serve.scheduler` — request lifecycle and the
  SLO-knobbed scheduler;
* :mod:`~horovod_tpu_torch.serve.prefix` — the copy-on-write prefix
  cache's radix index (``ServeConfig(prefix_caching=True)``);
* :mod:`~horovod_tpu_torch.serve.sampling` — per-slot sampling and the
  speculative-decoding draws and acceptance rule
  (``ServeConfig(speculate_k=k)``);
* :mod:`~horovod_tpu_torch.serve.metrics` — TTFT / per-token latency /
  page-occupancy accounting.

The fleet, tensor-parallel serving and disaggregated serving are still
to port (ROADMAP.md, Queue 1).
"""

from horovod_tpu_torch.serve.config import ServeConfig
from horovod_tpu_torch.serve.engine import ServeEngine
from horovod_tpu_torch.serve.kvcache import (OutOfPages, PageAllocator,
                                             PagedKVCache)
from horovod_tpu_torch.serve.prefix import (PrefixIndex, aligned_prefix_len,
                                            prefix_route_key,
                                            rendezvous_rank)
from horovod_tpu_torch.serve.scheduler import (Request, RequestState,
                                               Scheduler)

__all__ = [
    "OutOfPages",
    "PageAllocator",
    "PagedKVCache",
    "PrefixIndex",
    "Request",
    "RequestState",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "aligned_prefix_len",
    "prefix_route_key",
    "rendezvous_rank",
]
