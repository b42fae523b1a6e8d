"""Vision Transformer: the port of ``horovod_tpu.models.vit``.

Patchify with one strided convolution with a bias (``patch_embed``, a
per-patch linear projection), flatten the patches in (h, w) order,
prepend the float32 ``cls`` token (zeros at init), add the learned
float32 ``pos_embed`` (``[1, L + 1, E]`` at the init ``image_size``),
Dropout, then ``depth`` of the port's pre-norm
:class:`~horovod_tpu_torch.models.transformer.TransformerBlock` with
non-causal dense attention (``dot_product_attention(causal=False)``, as
the reference: no kernel), a float32 LayerNorm (eps 1e-6) and a float32
``head`` on token 0. bfloat16 compute by default, float32 parameters.

Weights are random from a numpy ``seed`` at flax's initialisers' scales
(kernels ``normal / sqrt(fan_in)``, ``pos_embed`` ``normal * 0.02``,
biases and ``cls`` 0, LayerNorm scales 1); :func:`params_from_flax`
carries a flax parameter tree across.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.models.resnet import (Dropout, conv2d_bias,
                                             lecun_normal_, load_flax)
from horovod_tpu_torch.models.transformer import (LayerNorm,
                                                  TransformerBlock, _dense,
                                                  block_parameter_map)
from horovod_tpu_torch.ops.attention import dot_product_attention


class VisionTransformer(nn.Module):
    """ViT encoder: NHWC images ``[B, H, W, 3]`` -> float32 logits
    ``[B, num_classes]``. The image size must be a multiple of the patch
    size, and ``image_size`` is the one ``pos_embed`` is made for.
    ``device=None`` is the card and raises without one."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
                 image_size: int = 224, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.patch_size = patch_size
        E = embed_dim
        tokens = (image_size // patch_size) ** 2 + 1
        bidirectional = functools.partial(dot_product_attention,
                                          causal=False)
        # Built without storage and allocated on ``dev`` uninitialised:
        # ``_init_weights`` writes every parameter.
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(3, E, patch_size,
                                         stride=patch_size)
            self.cls = nn.Parameter(torch.empty(1, 1, E))
            self.pos_embed = nn.Parameter(torch.empty(1, tokens, E))
            self.blocks = nn.ModuleList(
                TransformerBlock(E, num_heads, dtype=dtype,
                                 attn_fn=bidirectional, dropout=dropout)
                for _ in range(depth))
            self.norm = LayerNorm(E)
            self.head = nn.Linear(E, num_classes)
        self.drop = Dropout(dropout, seed=seed)
        self.to_empty(device=dev)
        self._init_weights(seed)

    def _init_weights(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        lecun_normal_(rng, self.patch_embed.weight,
                      self.patch_embed.weight[0].numel())
        self.cls.data.zero_()
        pos = rng.standard_normal(tuple(self.pos_embed.shape),
                                  dtype=np.float32) * np.float32(0.02)
        self.pos_embed.data.copy_(torch.from_numpy(pos))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(rng, mod.weight, mod.in_features)
            elif isinstance(mod, LayerNorm):
                mod.scale.data.fill_(1.0)
            if isinstance(mod, (nn.Linear, nn.Conv2d, LayerNorm)) \
                    and mod.bias is not None:
                mod.bias.data.zero_()

    def forward(self, x):
        B, H, W = x.shape[:3]
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size {H}x{W} not divisible by patch "
                             f"size {p}")
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = conv2d_bias(self.patch_embed, x, self.dtype, stride=p)
        x = x.flatten(2).transpose(1, 2)                 # [B, L, E]
        cls = self.cls.to(self.dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.drop(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return _dense(self.head, x[:, 0], torch.float32)


ViT_S16 = functools.partial(VisionTransformer, patch_size=16, embed_dim=384,
                            depth=12, num_heads=6)
ViT_B16 = functools.partial(VisionTransformer, patch_size=16, embed_dim=768,
                            depth=12, num_heads=12)


def flax_parameter_map(model: VisionTransformer):
    """``(flax path, parameter, layout)`` of every parameter in the flax
    tree's names (``patch_embed``, ``cls``, ``pos_embed``,
    ``TransformerBlock_i``, ``LayerNorm_0``, ``head``; the layouts those
    of ``resnet.flax_parameter_map``)."""
    pairs = [(("patch_embed", "kernel"), model.patch_embed.weight, "hwio"),
             (("patch_embed", "bias"), model.patch_embed.bias, None),
             (("cls",), model.cls, None),
             (("pos_embed",), model.pos_embed, None)]
    for i, blk in enumerate(model.blocks):
        pairs += [(path, t, "t" if transposed else None) for path, t,
                  transposed in block_parameter_map(f"TransformerBlock_{i}",
                                                    blk)]
    pairs += [(("LayerNorm_0", "scale"), model.norm.scale, None),
              (("LayerNorm_0", "bias"), model.norm.bias, None),
              (("head", "kernel"), model.head.weight, "t"),
              (("head", "bias"), model.head.bias, None)]
    return pairs


def params_from_flax(tree, model: VisionTransformer) -> VisionTransformer:
    """Load a flax ViT parameter tree (``variables["params"]``, mapped to
    numpy) into ``model`` in place; returns ``model``."""
    return load_flax(tree, flax_parameter_map(model), model)
