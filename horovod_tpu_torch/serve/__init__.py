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
  page-occupancy accounting;
* :mod:`~horovod_tpu_torch.serve.fleet` — :class:`ServeFleet`: N engines
  behind the least-loaded, prefix-aware router
  (:mod:`~horovod_tpu_torch.serve.router`), in this process or as
  worker processes (:mod:`~horovod_tpu_torch.serve.worker`) over the
  framed RPC transport (:mod:`~horovod_tpu_torch.serve.transport`, Unix
  socket or TCP, with :mod:`~horovod_tpu_torch.serve.netfault`'s
  injectable faults), with drain-and-redispatch, the heartbeat
  watchdog, budgeted relaunches, load shedding, and versioned weights
  pushed over the wire (:mod:`~horovod_tpu_torch.serve.params_wire` on
  :mod:`~horovod_tpu_torch.serve.chunk_stream`); sized by
  :class:`FleetConfig`;
* disaggregated prefill/decode pools (``FleetConfig(pools=...)``):
  :mod:`~horovod_tpu_torch.serve.disagg` ships each prefilled request's
  K/V pages from the prefill pool to the decode pool
  (:mod:`~horovod_tpu_torch.serve.kv_wire`, the ``HVKV`` blob of
  :meth:`PagedKVCache.export_pages`), in process or through the
  workers' ``kv_*`` RPCs. Like the reference, the package exports no
  name of its own for it.

* tensor-parallel serving (``ServeConfig(mesh="dp=1,tp=N")``): one
  engine over the N ranks of a ``torch.distributed`` world, rank 0 the
  controller and the others :meth:`ServeEngine.follow`-ing
  (:func:`~horovod_tpu_torch.serve.engine.resolve_tp_mesh`); in a fleet
  or a pool on the worker transports each such replica is one worker
  and its followers (:mod:`~horovod_tpu_torch.serve.tp_replica`).
"""

from horovod_tpu_torch._lazy import lazy_getattr

#: Public name -> the submodule that defines it, imported on first use
#: (PEP 562): ``python -m horovod_tpu_torch.serve.worker`` then binds
#: its socket before anything imports torch.
_EXPORTS = {
    "ChecksumError": "transport",
    "ConnectionLost": "transport",
    "DeadlineExceeded": "transport",
    "FaultableSocket": "netfault",
    "FleetConfig": "config",
    "FrameError": "transport",
    "NetFaults": "netfault",
    "OutOfPages": "kvcache",
    "PageAllocator": "kvcache",
    "PagedKVCache": "kvcache",
    "PrefixIndex": "prefix",
    "ProcessReplica": "fleet",
    "Replica": "fleet",
    "RemoteCallError": "transport",
    "Request": "scheduler",
    "RequestState": "scheduler",
    "Scheduler": "scheduler",
    "ServeConfig": "config",
    "ServeEngine": "engine",
    "ServeFleet": "fleet",
    "TcpReplica": "fleet",
    "TransportError": "transport",
    "aligned_prefix_len": "prefix",
    "prefix_route_key": "prefix",
    "rendezvous_rank": "prefix",
}

__all__ = sorted(_EXPORTS)


__getattr__ = lazy_getattr(__name__, _EXPORTS)
