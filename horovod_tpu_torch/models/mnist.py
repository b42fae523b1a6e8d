"""MNIST convnet: the port of ``horovod_tpu.models.mnist``.

The smoke-test model of the reference's ``examples/pytorch_mnist.py``:
Conv(10, 5x5, VALID) -> relu -> max_pool 2 -> Conv(20, 5x5) -> Dropout 0.5
-> relu -> max_pool 2 -> flatten -> Dense 50 -> relu -> Dropout 0.5 ->
Dense 10, everything in float32 by default. The model takes NHWC images
``[B, H, W, 1]`` as the flax module does; inside, activations are NCHW, so
the flatten before ``Dense_0`` permutes back to NHWC first: flax's
``Dense_0`` kernel reads its rows in (h, w, c) order.

Weights are random from a numpy ``seed`` at flax's initialisers' scales
(kernels ``normal / sqrt(fan_in)``, biases 0); the dense width is fixed by
``image_size`` (flax infers it from the input at init).
:func:`params_from_flax` carries a flax parameter tree across.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.models.resnet import (Dropout, conv2d_bias,
                                             flatten_nhwc, lecun_normal_,
                                             load_flax, max_pool)
from horovod_tpu_torch.models.transformer import _dense


class MNISTNet(nn.Module):
    """Conv(10, 5x5) -> pool -> Conv(20, 5x5) -> pool -> 50 -> 10, NHWC
    images in, float32 logits out. ``model.train()`` / ``.eval()`` play
    flax's ``train`` flag. ``device=None`` is the card and raises without
    one."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 image_size: int = 28, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        side = ((image_size - 4) // 2 - 4) // 2
        self.conv1 = nn.Conv2d(1, 10, 5)
        self.conv2 = nn.Conv2d(10, 20, 5)
        self.drop1 = Dropout(0.5, seed=(seed, 0))
        self.fc1 = nn.Linear(side * side * 20, 50)
        self.drop2 = Dropout(0.5, seed=(seed, 1))
        self.fc2 = nn.Linear(50, 10)
        rng = np.random.default_rng(seed)
        for conv in (self.conv1, self.conv2):
            lecun_normal_(rng, conv.weight, conv.weight[0].numel())
            conv.bias.data.zero_()
        for fc in (self.fc1, self.fc2):
            lecun_normal_(rng, fc.weight, fc.in_features)
            fc.bias.data.zero_()
        self.to(dev)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = conv2d_bias(self.conv1, x, self.dtype)
        x = max_pool(torch.relu(x), 2, 2)
        x = self.drop1(conv2d_bias(self.conv2, x, self.dtype))
        x = max_pool(torch.relu(x), 2, 2)
        x = torch.relu(_dense(self.fc1, flatten_nhwc(x), self.dtype))
        x = self.drop2(x)
        return _dense(self.fc2, x, torch.float32)


def flax_parameter_map(model: MNISTNet):
    """``(flax path, parameter, layout)`` for every parameter: ``"hwio"``
    for a conv kernel (flax HWIO, torch OIHW), ``"t"`` for a Dense kernel
    (flax ``[in, out]``, ``nn.Linear`` ``[out, in]``), else ``None``."""
    pairs = []
    for name, mod, layout in (("Conv_0", model.conv1, "hwio"),
                              ("Conv_1", model.conv2, "hwio"),
                              ("Dense_0", model.fc1, "t"),
                              ("Dense_1", model.fc2, "t")):
        pairs += [((name, "kernel"), mod.weight, layout),
                  ((name, "bias"), mod.bias, None)]
    return pairs


def params_from_flax(tree, model: MNISTNet) -> MNISTNet:
    """Load a flax ``MNISTNet`` parameter tree (``variables["params"]``,
    mapped to numpy) into ``model`` in place; returns ``model``."""
    return load_flax(tree, flax_parameter_map(model), model)
