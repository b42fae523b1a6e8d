"""Models of the port: the names of ``horovod_tpu.models`` that the port
has, each imported from its submodule on first use (PEP 562).

The rest of the JAX package's zoo (MNIST, VGG, Inception V3, ViT, the
``build`` registry over all of them and ``make_eval_step``) is
ROADMAP.md Queue 1 item 6. The train state (``TrainState``,
``apply_gradients``, ``state_partition_specs``) is a live view of a
module and its optimizer (``train.py``). The port's own entry points
(``resnet.build``, ``transformer.params_from_flax``, ...) stay in their
submodules.
"""

from horovod_tpu_torch._lazy import lazy_getattr

#: Public name -> the submodule that defines it (``None``: the name is
#: the submodule).
_EXPORTS = {
    "ResNet": "resnet",
    "ResNet18": "resnet",
    "ResNet34": "resnet",
    "ResNet50": "resnet",
    "ResNet101": "resnet",
    "ResNet152": "resnet",
    "TrainState": "train",
    "TransformerBlock": "transformer",
    "TransformerLM": "transformer",
    "apply_gradients": "train",
    "create_train_state": "train",
    "cross_entropy_loss": "train",
    "make_train_step": "train",
    "make_windowed_train_step": "train",
    "parallel_lm": None,
    "state_partition_specs": "train",
}

__all__ = sorted(_EXPORTS)


__getattr__ = lazy_getattr(__name__, _EXPORTS)
