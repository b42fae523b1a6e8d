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
tensor, sequence and pipeline parallelism).
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # Imported on first use (PEP 562), so a module that must not load
    # torch early (the serving worker binds its socket first) can be
    # run from this package.
    if name == "resolve_device":
        from horovod_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
