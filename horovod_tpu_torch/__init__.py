"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package stays the reference; this package mirrors its module
layout (``ops/``, ``models/``, ``serve/``, ``common/``) so each
counterpart is found by path. It imports torch and numpy only, never
jax and nothing of ``horovod_tpu``.

Conventions:

* parameters are plain dicts of tensors with the JAX pytree's structure
  and layouts;
* every entry point takes an explicit ``device=``; ``None`` means the
  card and raises without one (:mod:`horovod_tpu_torch._device`);
* every kernel that the JAX package writes in Pallas is a hand-written
  Hopper kernel here (``csrc/``, built by :mod:`horovod_tpu_torch._build`),
  with its plain PyTorch version beside it: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises.

Ported so far: the serving path — the dense LM
(:mod:`~horovod_tpu_torch.models.parallel_lm`), the continuous-batching
engine (:mod:`~horovod_tpu_torch.serve`) and its paged-attention decode
kernel (:mod:`~horovod_tpu_torch.ops.paged_attention`); and data-parallel
LM training — the flax ``TransformerLM``
(:mod:`~horovod_tpu_torch.models.transformer`) on the flash-attention
kernels (:mod:`~horovod_tpu_torch.ops.attention`), the Horovod surface
over ``torch.distributed`` (:mod:`~horovod_tpu_torch.distributed`), the
training step (:mod:`~horovod_tpu_torch.models.train`) and its bench
lane (``python -m horovod_tpu_torch.bench``); and image training — the
ResNet family (:mod:`~horovod_tpu_torch.models.resnet`) on the fused
1x1-conv + BatchNorm-statistics kernel
(:mod:`~horovod_tpu_torch.ops.conv_bn`) and the bench's image lane; and
the parallelism layer (:mod:`~horovod_tpu_torch.parallel`: the mesh,
tensor, sequence and pipeline parallelism); and the Horovod job — the
functional gradient API and the launcher (:mod:`~horovod_tpu_torch.run`,
``hvdrun-torch``).

As ``import horovod_tpu as hvd`` does, ``import horovod_tpu_torch as hvd``
offers the Horovod surface at the top level: every name of
:mod:`horovod_tpu_torch.distributed` (``hvd.init``, ``hvd.allreduce``,
``hvd.value_and_grad``, ...). The names load on first use (PEP 562), so
importing the package loads no torch: the serving worker binds its
socket first.
"""

from horovod_tpu_torch._lazy import lazy_getattr

__version__ = "0.2.0"

#: The names of :mod:`horovod_tpu_torch.distributed` (its ``__all__``),
#: offered here too. Kept in this torch-free module so that looking a
#: submodule up (``from horovod_tpu_torch import serve``) never imports
#: torch.
_HVD_NAMES = (
    "init", "shutdown", "is_initialized", "size", "rank", "local_rank",
    "local_size", "process_rank", "process_count", "mesh",
    "mpi_threads_supported", "check_extension",
    "Compression", "Sum", "Average", "Min", "Max", "Product", "Handle",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allreduce_sparse", "grouped_allreduce", "allgather",
    "allgather_async", "allgatherv", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "alltoall", "reducescatter",
    "poll", "synchronize", "broadcast_object", "spmd", "spmd_fn",
    "spmd_run", "fused_reduce", "plan_buckets", "plan_summary",
    "is_dcn_wire", "resolve_hierarchical", "hier_bucket_layout",
    "ef_residual_specs", "hier_wire_summary",
    "DistributedOptimizer", "broadcast_parameters", "broadcast_variables",
    "broadcast_global_variables",
    "broadcast_optimizer_state", "sharded_distributed_optimizer",
    "shard_info", "run_steps", "windowed", "window", "zero",
    "grad", "value_and_grad", "allreduce_gradients_transform",
    "ef_state_partition_specs",
)

__all__ = ["__version__", "resolve_device", *_HVD_NAMES]

# Imported on first use, so a module that must not load torch early (the
# serving worker binds its socket first) can be run from this package.
__getattr__ = lazy_getattr(__name__, {"resolve_device": "_device",
                                      **dict.fromkeys(_HVD_NAMES,
                                                      "distributed")})
