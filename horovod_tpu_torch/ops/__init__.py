"""Kernels of the port and their plain PyTorch versions.

The names of ``horovod_tpu.ops``, each imported from its submodule on
first use (PEP 562). The kernels' wrappers, plain versions and launch
counters stay in their submodules (``attention``, ``paged_attention``,
``conv_bn``, ``xent``).
"""

from horovod_tpu_torch._lazy import lazy_getattr

#: Public name -> the submodule that defines it.
_EXPORTS = {
    "conv1x1_bn_stats": "conv_bn",
    "conv1x1_prologue_bn_stats": "conv_bn",
    "dot_product_attention": "attention",
    "flash_attention": "attention",
    "flash_grid_info": "attention",
    "fused_cross_entropy": "xent",
    "tp_vocab_cross_entropy": "xent",
}

__all__ = sorted(_EXPORTS)


__getattr__ = lazy_getattr(__name__, _EXPORTS)
