"""ResNet family (18/34/50/101/152): the port of ``horovod_tpu.models.resnet``.

The image-training workload of the bench lane (``--model resnet50``), with
the numerics of the flax modules step by step:

* **NHWC at the boundary.** The model takes ``[B, H, W, 3]`` images as
  the JAX lane does. Inside, activations are NCHW tensors in
  ``torch.channels_last`` memory format, which is NHWC in memory: cuDNN
  takes the 3x3/7x7 convolutions in its fast layout, and a 1x1 conv's
  input is an ``[M, C]`` row-major view for kernel K5.
* **bfloat16 compute, float32 parameters and statistics.** Conv kernels
  are cast to the compute type and the conv output is rounded to it
  (``preferred_element_type=dtype``); the BatchNorm apply and the residual
  add run in it; the spatial mean accumulates in float32 and rounds to
  it; the head is a float32 Dense.
* **The JAX package's own BatchNorm** (``ConvBN``), not
  ``nn.BatchNorm2d``: statistics in the fast form ``E[y^2] - E[y]^2``
  over the rounded ``y`` in float32; running averages ``0.9*old +
  0.1*new`` with the *biased* batch variance; apply as ``mul = scale *
  rsqrt(var + eps)``, ``add = bias - mean*mul``, then ``y*mul + add`` in
  the compute type. Torch's BatchNorm keeps the unbiased running variance
  and counts its momentum the other way round.
* **``"SAME"`` padding as flax computes it**: ``(0, 1)`` for an even
  input under a 3-wide window at stride 2 (PyTorch's ``padding=1`` would
  be ``(1, 1)``), so such convs and the stem's max-pool pad explicitly.
* **``fused_bn=True``** routes every training-mode 1x1 ConvBN through
  :mod:`horovod_tpu_torch.ops.conv_bn` (K5): the statistics come out of
  the matmul epilogue, and in a bottleneck block the 3x3's BatchNorm
  apply + ReLU moves into the last 1x1's prologue (``emit_raw``). Eval
  mode never fuses. ResNet-50 at any width makes 36 K5 calls per
  training forward: 16 with the prologue, 20 without.

Weights are random from a numpy ``seed`` at flax's initialisers' scales
(conv kernels ``normal * sqrt(1 / fan_in)``, BatchNorm scale 1 — 0 for
the last BatchNorm of each block, so every block starts as the identity —
and biases 0); :func:`params_from_flax` carries a flax variable tree
(``params`` and ``batch_stats``) across. Running statistics are buffers,
per rank, never reduced (the JAX lane without ``axis_name``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.ops.conv_bn import (conv1x1_bn_stats,
                                           conv1x1_prologue_bn_stats)

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """flax/lax ``"SAME"``: the output has ``ceil(size / stride)`` rows and
    the padding is split with the larger half after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(padding: Padding, shape, window, strides):
    if padding == "SAME":
        return [same_pads(shape[i], window[i], strides[i]) for i in (0, 1)]
    if isinstance(padding, str):
        raise ValueError(f"padding {padding!r}: the ResNets use \"SAME\" "
                         "or explicit (low, high) pairs")
    return [tuple(p) for p in padding]


def max_pool_same(x, window: int = 3, stride: int = 2):
    """flax ``nn.max_pool(x, (w, w), (s, s), "SAME")`` on an NCHW tensor:
    ``-inf`` padding with flax's split."""
    (t, b), (l, r) = (same_pads(x.shape[2], window, stride),
                      same_pads(x.shape[3], window, stride))
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=-math.inf).contiguous(
            memory_format=torch.channels_last)
    return F.max_pool2d(x, window, stride)


class ConvBN(nn.Module):
    """Bias-free convolution + BatchNorm as one module (flax ``ConvBN``).

    ``forward(x, prologue=None)`` takes an NCHW tensor; ``prologue`` is the
    producing layer's ``(mul, add)``, and ``x`` then its raw output: the
    normalise + ReLU runs in K5's prologue (fused 1x1) or as an explicit
    elementwise pass. ``emit_raw=True`` returns ``(raw y, mul, add)``.
    ``self.training`` plays flax's ``not use_running_average``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int] = (1, 1),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 axis_name: Optional[str] = None, zero_scale: bool = False,
                 fuse: bool = False, emit_raw: bool = False):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "cross-replica BatchNorm (axis_name) is not ported yet "
                "(ROADMAP.md Queue 1, sync-BN)")
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.fuse = fuse
        self.emit_raw = emit_raw
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.scale = nn.Parameter(torch.full((features,),
                                             0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _conv(self, x, k):
        (t, b), (l, r) = _pads(self.padding, x.shape[2:], self.kernel_size,
                               self.strides)
        if (t, l) == (b, r):
            return F.conv2d(x, k, stride=self.strides, padding=(t, l))
        x = F.pad(x, (l, r, t, b)).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, k, stride=self.strides)

    def _prologue(self, x, prologue):
        mul, add = prologue
        return torch.relu(x * mul.to(self.dtype)[:, None, None]
                          + add.to(self.dtype)[:, None, None])

    def forward(self, x, prologue=None):
        x = x.to(self.dtype)
        k = self.weight.to(self.dtype, memory_format=torch.channels_last)
        fused = (self.fuse and self.training
                 and self.kernel_size == (1, 1)
                 and isinstance(self.padding, str))
        if not self.training:
            y = self._conv(x if prologue is None
                           else self._prologue(x, prologue), k)
            mean, var = self.mean, self.var
        else:
            if fused:
                xn = x.permute(0, 2, 3, 1)            # NHWC view
                w = k[:, :, 0, 0].t()                 # [Cin, Cout] view
                if prologue is None:
                    y, s1, s2 = conv1x1_bn_stats(xn, w, self.strides)
                else:
                    y, s1, s2 = conv1x1_prologue_bn_stats(
                        xn, prologue[0], prologue[1], w, self.strides)
                n = y.shape[0] * y.shape[1] * y.shape[2]
                mean = s1 / n
                var = s2 / n - mean * mean
                y = y.permute(0, 3, 1, 2)             # NCHW, channels_last
            else:
                y = self._conv(x if prologue is None
                               else self._prologue(x, prologue), k)
                yf = y.to(torch.promote_types(torch.float32, y.dtype))
                mean = yf.mean((0, 2, 3))
                var = (yf * yf).mean((0, 2, 3)) - mean * mean
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = self.scale * torch.rsqrt(var + self.epsilon)
        add = self.bias - mean * mul
        if self.emit_raw:
            return y, mul, add
        return (y * mul.to(self.dtype)[:, None, None]
                + add.to(self.dtype)[:, None, None])


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 residual block (ResNet-18/34)."""

    def __init__(self, in_features: int, filters: int, conv_bn,
                 strides: Tuple[int, int] = (1, 1),
                 prologue_fuse: bool = False):
        super().__init__()
        self.out_features = filters
        self.convs = nn.ModuleList([
            conv_bn(in_features, filters, (3, 3), strides),
            conv_bn(filters, filters, (3, 3), zero_scale=True)])
        self.proj = (conv_bn(in_features, filters, (1, 1), strides)
                     if in_features != filters or tuple(strides) != (1, 1)
                     else None)

    def forward(self, x):
        y = self.convs[1](torch.relu(self.convs[0](x)))
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block (ResNet-50/101/152).

    ``prologue_fuse``: the 3x3's normalised + ReLU'd output feeds only the
    last 1x1, so its BatchNorm apply moves into that 1x1's K5 prologue."""

    def __init__(self, in_features: int, filters: int, conv_bn,
                 strides: Tuple[int, int] = (1, 1),
                 prologue_fuse: bool = False):
        super().__init__()
        self.out_features = filters * 4
        self.prologue_fuse = prologue_fuse
        self.convs = nn.ModuleList([
            conv_bn(in_features, filters, (1, 1)),
            conv_bn(filters, filters, (3, 3), strides,
                    emit_raw=prologue_fuse),
            conv_bn(filters, filters * 4, (1, 1), zero_scale=True)])
        self.proj = (conv_bn(in_features, filters * 4, (1, 1), strides)
                     if in_features != filters * 4
                     or tuple(strides) != (1, 1) else None)

    def forward(self, x):
        y = torch.relu(self.convs[0](x))
        if self.prologue_fuse:
            raw, mul, add = self.convs[1](y)
            y = self.convs[2](raw, prologue=(mul, add))
        else:
            y = self.convs[2](torch.relu(self.convs[1](y)))
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """ImageNet-style ResNet: NHWC images ``[B, H, W, 3]`` -> float32
    logits ``[B, num_classes]``. ``model.train()`` / ``model.eval()`` play
    flax's ``train`` flag. ``axis_name`` (cross-replica BatchNorm) raises.
    ``device=None`` is the card and raises without one."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 axis_name: Optional[str] = None, fused_bn: bool = False,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.fused_bn = fused_bn
        conv_bn = functools.partial(ConvBN, dtype=dtype, axis_name=axis_name,
                                    fuse=fused_bn)
        self.stem = conv_bn(3, num_filters, (7, 7), (2, 2),
                            padding=[(3, 3), (3, 3)])
        prologue_fuse = fused_bn and block_cls is BottleneckResNetBlock
        blocks, cin = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blk = block_cls(cin, num_filters * 2 ** i, conv_bn, strides,
                                prologue_fuse=prologue_fuse)
                blocks.append(blk)
                cin = blk.out_features
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        self._init_weights(seed)
        self.to(dev)

    def _init_weights(self, seed: int) -> None:
        rng = np.random.default_rng(seed)

        def normal(p, fan_in):
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            p.data.copy_(torch.from_numpy(w * np.float32(fan_in ** -0.5)))

        for mod in self.modules():
            if isinstance(mod, ConvBN):
                normal(mod.weight, mod.weight[0].numel())
            elif isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features)
                mod.bias.data.zero_()

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)       # channels_last NCHW
        x = max_pool_same(torch.relu(self.stem(x)))
        for blk in self.blocks:
            x = blk(x)
        acc = torch.promote_types(torch.float32, x.dtype)
        x = x.to(acc).mean((2, 3)).to(self.dtype)
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)

_FAMILY = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}


def build(name: str, **kwargs) -> ResNet:
    """A ResNet by torchvision-style name (``build("resnet50",
    fused_bn=True, device="cpu")``)."""
    try:
        return _FAMILY[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"Unknown ResNet variant {name!r}; have "
                         f"{sorted(_FAMILY)}") from None


def flax_parameter_map(model: ResNet):
    """``(flax path, tensor, layout)`` for every parameter and running
    statistic of ``model`` in the flax variable tree's names: paths start
    with the collection (``params`` or ``batch_stats``); ``layout`` is
    ``"hwio"`` for a conv kernel (flax HWIO, the port OIHW), ``"t"`` for the
    head's ``[in, out]`` kernel (``nn.Linear`` keeps ``[out, in]``), else
    ``None``."""
    pairs = []

    def conv_bn(prefix, cb):
        pairs.extend([
            (("params", *prefix, "kernel"), cb.weight, "hwio"),
            (("params", *prefix, "scale"), cb.scale, None),
            (("params", *prefix, "bias"), cb.bias, None),
            (("batch_stats", *prefix, "mean"), cb.mean, None),
            (("batch_stats", *prefix, "var"), cb.var, None)])

    conv_bn(("stem",), model.stem)
    for i, blk in enumerate(model.blocks):
        name = f"{type(blk).__name__}_{i}"
        for j, cb in enumerate(blk.convs):
            conv_bn((name, f"ConvBN_{j}"), cb)
        if blk.proj is not None:
            conv_bn((name, "proj"), blk.proj)
    pairs += [(("params", "head", "kernel"), model.head.weight, "t"),
              (("params", "head", "bias"), model.head.bias, None)]
    return pairs


def to_port_layout(arr, layout):
    """A flax array in the port's layout (see :func:`flax_parameter_map`)."""
    if layout == "hwio":
        return np.transpose(arr, (3, 2, 0, 1))
    if layout == "t":
        return arr.T
    return arr


def _flax_leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flax_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_flax(variables, model: ResNet) -> ResNet:
    """Load a flax ResNet's variables ``{"params": ..., "batch_stats":
    ...}``, mapped to numpy (``jax.tree_util.tree_map(np.asarray, v)``),
    into ``model`` in place; returns ``model``. Raises when the tree's
    paths or shapes are not the model's."""
    leaves = dict(_flax_leaves(variables))
    pairs = flax_parameter_map(model)
    want = {path for path, _, _ in pairs}
    if set(leaves) != want:
        raise ValueError(
            f"flax variables do not match the model: missing "
            f"{sorted(want - set(leaves))[:4]}, unexpected "
            f"{sorted(set(leaves) - want)[:4]}")
    with torch.no_grad():
        for path, t, layout in pairs:
            arr = to_port_layout(np.asarray(leaves[path], np.float32), layout)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                                 f"model {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, copy=True)))
    return model
