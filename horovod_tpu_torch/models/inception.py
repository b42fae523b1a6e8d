"""Inception V3: the port of ``horovod_tpu.models.inception``.

The reference's headline scaling workload, in the torchvision/slim layer
plan, without the aux head: NHWC images (299^2 published) in, float32
logits out, bfloat16 compute with float32 parameters and BatchNorm
statistics. Every convolution is the ResNets' shared
:class:`~horovod_tpu_torch.models.resnet.ConvBN` (``epsilon=1e-3``,
``momentum=0.9``) followed by a ReLU, so with ``fused_bn=True`` each of
its 40 training-mode 1x1 ConvBNs runs through kernel K5
(:mod:`horovod_tpu_torch.ops.conv_bn`) without the prologue: Inception's
1x1 outputs feed convolutions of other shapes. Pools are flax's
(``max_pool`` ``"VALID"``, ``avg_pool`` ``"SAME"`` counting the padding);
the spatial mean accumulates in float32 and rounds to the compute dtype,
then Dropout 0.5 and a float32 Dense.

Each block keeps its ConvBNs in a list in the order flax names them
(``ConvBN_i``, numbered as the modules are constructed: in
``c(64, (5, 5))(c(48, (1, 1))(x))`` the outer conv comes first), which
:func:`flax_parameter_map` reads. Weights are random from a numpy
``seed`` at flax's initialisers' scales; :func:`params_from_flax` carries
a flax variable tree across.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.resnet import (Dropout, avg_pool_same,
                                             lecun_normal_, load_flax,
                                             max_pool)


class ConvBN(nn.Module):
    """Conv + BatchNorm + ReLU through the shared ``resnet.ConvBN``
    (flax: ``ConvBN_i/ConvBN_0``)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding="SAME", dtype: torch.dtype = torch.bfloat16,
                 fuse: bool = False):
        super().__init__()
        self.conv_bn = resnet.ConvBN(
            in_features, features, kernel, strides, padding=padding,
            momentum=0.9, epsilon=1e-3, dtype=dtype, fuse=fuse)

    def forward(self, x):
        return torch.relu(self.conv_bn(x))


class _Block(nn.Module):
    """A block's ConvBNs, built from ``(features, kernel, strides,
    padding, input)`` specs in flax's naming order; ``input`` is the spec
    index of the producer (``None``: the block's input)."""

    def __init__(self, cin: int, specs, conv):
        super().__init__()
        self.convs = nn.ModuleList(
            conv(cin if src is None else specs[src][0], features, kernel,
                 strides, padding)
            for features, kernel, strides, padding, src in specs)

    def chain(self, x, *order):
        """The convs ``order`` applied in turn to ``x``."""
        for i in order:
            x = self.convs[i](x)
        return x


def _one(features, src=None, padding="SAME"):
    return (features, (1, 1), (1, 1), padding, src)


def _conv(features, kernel, src, strides=(1, 1), padding="SAME"):
    return (features, kernel, strides, padding, src)


S2V = ((2, 2), "VALID")


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, conv):
        super().__init__(cin, [
            _one(64), _conv(64, (5, 5), 2), _one(48),
            _conv(96, (3, 3), 4), _conv(96, (3, 3), 5), _one(64),
            _one(pool_features)], conv)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self.chain(x, 0), self.chain(x, 2, 1),
                          self.chain(x, 5, 4, 3),
                          self.chain(avg_pool_same(x), 6)], dim=1)


class InceptionB(_Block):
    def __init__(self, cin: int, conv):
        super().__init__(cin, [
            _conv(384, (3, 3), None, *S2V), _conv(96, (3, 3), 2, *S2V),
            _conv(96, (3, 3), 3), _one(64)], conv)
        self.out_features = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([self.chain(x, 0), self.chain(x, 3, 2, 1),
                          max_pool(x, 3, 2)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin: int, c7: int, conv):
        super().__init__(cin, [
            _one(192), _one(c7), _conv(c7, (1, 7), 1),
            _conv(192, (7, 1), 2), _one(c7), _conv(c7, (7, 1), 4),
            _conv(c7, (1, 7), 5), _conv(c7, (7, 1), 6),
            _conv(192, (1, 7), 7), _one(192)], conv)
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([self.chain(x, 0), self.chain(x, 1, 2, 3),
                          self.chain(x, 4, 5, 6, 7, 8),
                          self.chain(avg_pool_same(x), 9)], dim=1)


class InceptionD(_Block):
    def __init__(self, cin: int, conv):
        super().__init__(cin, [
            _conv(320, (3, 3), 1, *S2V), _one(192), _one(192),
            _conv(192, (1, 7), 2), _conv(192, (7, 1), 3),
            _conv(192, (3, 3), 4, *S2V)], conv)
        self.out_features = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([self.chain(x, 1, 0), self.chain(x, 2, 3, 4, 5),
                          max_pool(x, 3, 2)], dim=1)


class InceptionE(_Block):
    def __init__(self, cin: int, conv):
        super().__init__(cin, [
            _one(320), _one(384), _conv(384, (1, 3), 1),
            _conv(384, (3, 1), 1), _one(448), _conv(384, (3, 3), 4),
            _conv(384, (1, 3), 5), _conv(384, (3, 1), 5), _one(192)], conv)
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b2 = self.convs[1](x)
        b3 = self.chain(x, 4, 5)
        return torch.cat([self.convs[0](x), self.convs[2](b2),
                          self.convs[3](b2), self.convs[6](b3),
                          self.convs[7](b3),
                          self.chain(avg_pool_same(x), 8)], dim=1)


class InceptionV3(nn.Module):
    """Standard Inception V3 (torchvision layer plan, no aux head): NHWC
    images ``[B, H, W, 3]`` (75^2 at least) -> float32 logits ``[B,
    num_classes]``. ``fused_bn`` sends every training-mode 1x1 ConvBN
    through K5 (40 a forward). ``model.train()`` / ``.eval()`` play
    flax's ``train`` flag. ``device=None`` is the card and raises
    without one."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, fused_bn: bool = False,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.fused_bn = fused_bn

        def conv(cin, features, kernel, strides=(1, 1), padding="SAME"):
            return ConvBN(cin, features, kernel, strides, padding,
                          dtype=dtype, fuse=fused_bn)

        self.stem = nn.ModuleList([
            conv(3, 32, (3, 3), (2, 2), "VALID"),
            conv(32, 32, (3, 3), padding="VALID"),
            conv(32, 64, (3, 3)),
            conv(64, 80, (1, 1), padding="VALID"),
            conv(80, 192, (3, 3), padding="VALID")])
        blocks, cin = [], 192
        for cls, arg in ((InceptionA, 32), (InceptionA, 64),
                         (InceptionA, 64), (InceptionB, None),
                         (InceptionC, 128), (InceptionC, 160),
                         (InceptionC, 160), (InceptionC, 192),
                         (InceptionD, None), (InceptionE, None),
                         (InceptionE, None)):
            blk = cls(cin, conv) if arg is None else cls(cin, arg, conv)
            blocks.append(blk)
            cin = blk.out_features
        self.blocks = nn.ModuleList(blocks)
        self.drop = Dropout(0.5, seed=seed)
        self.head = nn.Linear(cin, num_classes)
        rng = np.random.default_rng(seed)
        for mod in self.modules():
            if isinstance(mod, resnet.ConvBN):
                lecun_normal_(rng, mod.weight, mod.weight[0].numel())
        lecun_normal_(rng, self.head.weight, cin)
        self.head.bias.data.zero_()
        self.to(dev)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # channels_last NCHW
        s = self.stem
        x = max_pool(s[2](s[1](s[0](x))), 3, 2)
        x = max_pool(s[4](s[3](x)), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        acc = torch.promote_types(torch.float32, x.dtype)
        x = self.drop(x.to(acc).mean((2, 3)).to(self.dtype))
        return torch.nn.functional.linear(x.float(), self.head.weight,
                                          self.head.bias)


def flax_parameter_map(model: InceptionV3):
    """``(flax path, tensor, layout)`` of every parameter and running
    statistic of ``model`` in the flax variable tree's names
    (``ConvBN_i/ConvBN_0``, ``InceptionA_0/ConvBN_j/ConvBN_0``, ...,
    ``Dense_0``; paths start with the collection, the layouts those of
    ``resnet.flax_parameter_map``)."""
    pairs = []

    def conv_bn(prefix, cb):
        cb = cb.conv_bn
        pairs.extend([
            (("params", *prefix, "ConvBN_0", "kernel"), cb.weight, "hwio"),
            (("params", *prefix, "ConvBN_0", "scale"), cb.scale, None),
            (("params", *prefix, "ConvBN_0", "bias"), cb.bias, None),
            (("batch_stats", *prefix, "ConvBN_0", "mean"), cb.mean, None),
            (("batch_stats", *prefix, "ConvBN_0", "var"), cb.var, None)])

    for i, cb in enumerate(model.stem):
        conv_bn((f"ConvBN_{i}",), cb)
    seen = {}
    for blk in model.blocks:
        name = type(blk).__name__
        seen[name] = seen.get(name, -1) + 1
        for j, cb in enumerate(blk.convs):
            conv_bn((f"{name}_{seen[name]}", f"ConvBN_{j}"), cb)
    pairs += [(("params", "Dense_0", "kernel"), model.head.weight, "t"),
              (("params", "Dense_0", "bias"), model.head.bias, None)]
    return pairs


def params_from_flax(variables, model: InceptionV3) -> InceptionV3:
    """Load a flax Inception V3's variables ``{"params": ...,
    "batch_stats": ...}``, mapped to numpy, into ``model`` in place;
    returns ``model``."""
    return load_flax(variables, flax_parameter_map(model), model)


#: Inception V3's 1x1 ConvBN layers at the published input (299^2) and
#: the bench's 64 images, bf16: (input side, K, N, launches a training
#: step). 40 launches, none with the prologue, all at stride 1.
INCEPTION_V3_K5 = [
    (73, 64, 80, 1),
    (35, 192, 64, 2), (35, 192, 48, 1), (35, 192, 32, 1),
    (35, 256, 64, 3), (35, 256, 48, 1),
    (35, 288, 64, 4), (35, 288, 48, 1),
    (17, 768, 192, 12), (17, 768, 128, 2), (17, 768, 160, 4),
    (8, 1280, 320, 1), (8, 1280, 384, 1), (8, 1280, 448, 1),
    (8, 1280, 192, 1),
    (8, 2048, 320, 1), (8, 2048, 384, 1), (8, 2048, 448, 1),
    (8, 2048, 192, 1),
]
