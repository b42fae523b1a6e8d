"""Models of the port: every name of ``horovod_tpu.models``, each
imported from its submodule on first use (PEP 562).

The zoo is the reference's benchmark set (Inception V3, ResNet, VGG, the
models of Horovod's published scaling table) with MNIST, ViT and the
Transformer LM: ``build(name, **kwargs)`` makes any of them by its
torchvision-style name. Each model takes NHWC images (token ids for the
LM), random weights from a numpy ``seed`` and an explicit ``device``
(``None`` is the card), and its submodule's ``params_from_flax`` carries
a flax variable tree across. The train state (``TrainState``,
``apply_gradients``, ``state_partition_specs``) is a live view of a
module and its optimizer (``train.py``); ``make_eval_step`` scores a
batch with it.
"""

import importlib

from horovod_tpu_torch._lazy import lazy_getattr

#: Public name -> the submodule that defines it (``None``: the name is
#: the submodule).
_EXPORTS = {
    "InceptionV3": "inception",
    "MNISTNet": "mnist",
    "ResNet": "resnet",
    "ResNet18": "resnet",
    "ResNet34": "resnet",
    "ResNet50": "resnet",
    "ResNet101": "resnet",
    "ResNet152": "resnet",
    "TrainState": "train",
    "TransformerBlock": "transformer",
    "TransformerLM": "transformer",
    "VGG": "vgg",
    "VGG11": "vgg",
    "VGG13": "vgg",
    "VGG16": "vgg",
    "VGG19": "vgg",
    "ViT_B16": "vit",
    "ViT_S16": "vit",
    "VisionTransformer": "vit",
    "apply_gradients": "train",
    "create_train_state": "train",
    "cross_entropy_loss": "train",
    "make_eval_step": "train",
    "make_train_step": "train",
    "make_windowed_train_step": "train",
    "parallel_lm": None,
    "state_partition_specs": "train",
}

#: The zoo by name, as the JAX package's ``models._FAMILY`` (its names and
#: aliases): name -> (submodule, constructor).
_FAMILY = {
    "resnet18": ("resnet", "ResNet18"),
    "resnet34": ("resnet", "ResNet34"),
    "resnet50": ("resnet", "ResNet50"),
    "resnet101": ("resnet", "ResNet101"),
    "resnet152": ("resnet", "ResNet152"),
    "vgg11": ("vgg", "VGG11"),
    "vgg13": ("vgg", "VGG13"),
    "vgg16": ("vgg", "VGG16"),
    "vgg19": ("vgg", "VGG19"),
    "inception_v3": ("inception", "InceptionV3"),
    "inception3": ("inception", "InceptionV3"),
    "transformer_lm": ("transformer", "TransformerLM"),
    "vit_s16": ("vit", "ViT_S16"),
    "vit_b16": ("vit", "ViT_B16"),
}


def constructor(name: str):
    """The constructor :func:`build` calls for ``name`` (any case)."""
    try:
        mod, attr = _FAMILY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; have {sorted(_FAMILY)}") from None
    return getattr(importlib.import_module(f"{__name__}.{mod}"), attr)


def build(name: str, **kwargs):
    """Construct any zoo model by torchvision-style name (the reference
    benchmark selected models via ``getattr(torchvision.models, ...)``,
    examples/pytorch_synthetic_benchmark.py:55): ``build("vgg16",
    num_classes=10, device="cpu")``. An unknown name raises the JAX
    package's ``ValueError``."""
    return constructor(name)(**kwargs)


__all__ = sorted([*_EXPORTS, "build"])


__getattr__ = lazy_getattr(__name__, _EXPORTS)
