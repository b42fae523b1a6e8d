"""VGG family (11/13/16/19) with BatchNorm: the port of
``horovod_tpu.models.vgg``.

VGG-16 is the reference's hardest scaling workload (its ~138M parameters
make the gradient exchange large against the compute). The numerics
follow the flax module:

* bias-free 3x3 ``"SAME"`` convs in the compute dtype (bfloat16 by
  default), float32 parameters;
* flax's own ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
  dtype=float32)`` (:class:`BatchNorm`), not the ResNets' ConvBN: the
  statistics in float32 with the variance ``max(0, E[y^2] - E[y]^2)``,
  the apply ``(y - mean) * (rsqrt(var + eps) * scale) + bias`` in float32
  with a float32 output (the next conv casts it back), running averages
  ``0.9*old + 0.1*new`` of the biased variance;
* 2x2 max-pools, then the flatten in NHWC order (flax's ``Dense_0``
  reads (h, w, c) rows; 7*7*512 = 25,088 wide at 224^2), two Dense 4096
  layers with ReLU and Dropout 0.5, and a float32 head.

Weights are random from a numpy ``seed`` at flax's initialisers' scales;
the flatten's width is fixed by ``image_size`` (flax infers it at init).
:func:`params_from_flax` carries a flax variable tree across.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.models.resnet import (Dropout, conv2d, flatten_nhwc,
                                             lecun_normal_, load_flax,
                                             max_pool)
from horovod_tpu_torch.models.transformer import _dense

#: Convolution plans: ints are conv filter counts, "M" a 2x2 max-pool
#: (the classic configurations A/B/D/E).
_PLANS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype=float32)`` over the
    channels of an NCHW tensor; ``self.training`` plays flax's ``not
    use_running_average``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        xf = x.to(torch.promote_types(torch.float32, x.dtype))
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class VGG(nn.Module):
    """VGG with BatchNorm: NHWC images ``[B, H, W, 3]`` -> float32 logits
    ``[B, num_classes]``. ``model.train()`` / ``.eval()`` play flax's
    ``train`` flag. ``device=None`` is the card and raises without one."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, hidden: int = 4096,
                 image_size: int = 224, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.plan = _PLANS[depth]
        side, cin = image_size, 3
        # Built without storage and allocated on ``dev`` uninitialised:
        # ``_init_weights`` writes every tensor (torch's own initialisers
        # over VGG-16's 138M parameters would be thrown away).
        with torch.device("meta"):
            convs, norms = [], []
            for step in self.plan:
                if step == "M":
                    side //= 2
                else:
                    convs.append(nn.Conv2d(cin, step, 3, bias=False))
                    norms.append(BatchNorm(step))
                    cin = step
            self.convs = nn.ModuleList(convs)
            self.norms = nn.ModuleList(norms)
            self.dense = nn.ModuleList([
                nn.Linear(side * side * cin, hidden),
                nn.Linear(hidden, hidden),
                nn.Linear(hidden, num_classes)])
        self.drops = nn.ModuleList([Dropout(0.5, seed=(seed, i))
                                    for i in range(2)])
        self.to_empty(device=dev)
        self._init_weights(seed)

    def _init_weights(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        for conv in self.convs:
            lecun_normal_(rng, conv.weight, conv.weight[0].numel())
        for fc in self.dense:
            lecun_normal_(rng, fc.weight, fc.in_features)
            fc.bias.data.zero_()
        for bn in self.norms:
            bn.scale.data.fill_(1.0)
            bn.bias.data.zero_()
            bn.mean.zero_()
            bn.var.fill_(1.0)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # channels_last NCHW
        i = 0
        for step in self.plan:
            if step == "M":
                x = max_pool(x, 2, 2)
                continue
            k = self.convs[i].weight.to(self.dtype,
                                        memory_format=torch.channels_last)
            x = torch.relu(self.norms[i](conv2d(x.to(self.dtype), k)))
            i += 1
        x = flatten_nhwc(x)
        for fc, drop in zip(self.dense[:2], self.drops):
            x = drop(torch.relu(_dense(fc, x, self.dtype)))
        return _dense(self.dense[2], x, torch.float32)


VGG11 = functools.partial(VGG, depth=11)
VGG13 = functools.partial(VGG, depth=13)
VGG16 = functools.partial(VGG, depth=16)
VGG19 = functools.partial(VGG, depth=19)


def flax_parameter_map(model: VGG):
    """``(flax path, tensor, layout)`` of every parameter and running
    statistic of ``model`` in the flax variable tree's names (``Conv_i``,
    ``BatchNorm_i``, ``Dense_i``; paths start with the collection, the
    layouts those of ``resnet.flax_parameter_map``)."""
    pairs = []
    for i, (conv, bn) in enumerate(zip(model.convs, model.norms)):
        pairs += [(("params", f"Conv_{i}", "kernel"), conv.weight, "hwio"),
                  (("params", f"BatchNorm_{i}", "scale"), bn.scale, None),
                  (("params", f"BatchNorm_{i}", "bias"), bn.bias, None),
                  (("batch_stats", f"BatchNorm_{i}", "mean"), bn.mean, None),
                  (("batch_stats", f"BatchNorm_{i}", "var"), bn.var, None)]
    for i, fc in enumerate(model.dense):
        pairs += [(("params", f"Dense_{i}", "kernel"), fc.weight, "t"),
                  (("params", f"Dense_{i}", "bias"), fc.bias, None)]
    return pairs


def params_from_flax(variables, model: VGG) -> VGG:
    """Load a flax VGG's variables ``{"params": ..., "batch_stats":
    ...}``, mapped to numpy, into ``model`` in place; returns ``model``."""
    return load_flax(variables, flax_parameter_map(model), model)
