"""Decoder-only Transformer LM: the port of ``horovod_tpu.models.transformer``.

A GPT-style causal LM whose attention is pluggable (``attn_fn``), so the
same network trains on dense attention or on the flash kernels K1-K3
(``functools.partial(flash_attention, causal=True)``). The numerics follow
the flax modules step by step:

* ``nn.LayerNorm(dtype=float32)``: statistics in float32 with the fast
  variance ``E[x^2] - E[x]^2`` clipped at 0, ``epsilon = 1e-6``,
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, float32 out;
* ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to the compute
  dtype, the product rounded to it, then the bias added in it;
* ``nn.Embed(dtype=dtype)``: the table cast first, then gathered, so the
  residual stream is in the compute dtype;
* ``nn.gelu``: the tanh approximation;
* the QKV split is ``split(qkv, 3, -1)`` then a reshape to ``(H, D)``;
* ``lm_head`` is a float32 product on the float32 final LayerNorm (on the
  card a full-float32 product, by the no-TF32 policy of ``_device``).

Parameters are float32 (flax's ``param_dtype``); the compute dtype
defaults to bfloat16. :func:`params_from_flax` carries a flax parameter
tree across.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.ops.attention import dot_product_attention


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        mu2 = (x32 * x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        return (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=dtype)``: the product rounded to ``dtype``,
    then the bias added in ``dtype``."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


class TransformerBlock(nn.Module):
    """Pre-norm block: LayerNorm -> fused QKV (no bias) -> attention ->
    projection + residual; LayerNorm -> MLP (gelu) -> residual.

    ``attn_fn(q, k, v) -> out`` over ``[B, L, H, D]`` owns causality;
    ``None`` is dense causal attention at ``q_offset``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, mlp_ratio: int = 4,
                 attn_fn: Optional[Callable] = None, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.dropout = dropout
        E = embed_dim
        self.ln1 = LayerNorm(E)
        self.qkv = nn.Linear(E, 3 * E, bias=False)
        self.proj = nn.Linear(E, E)
        self.ln2 = LayerNorm(E)
        self.up = nn.Linear(E, mlp_ratio * E)
        self.down = nn.Linear(mlp_ratio * E, E)

    def forward(self, x, q_offset: int = 0):
        E = x.shape[-1]
        H = self.num_heads
        qkv = _dense(self.qkv, self.ln1(x), self.dtype)
        q, k, v = qkv.split(E, dim=-1)
        shape = (*q.shape[:-1], H, E // H)
        if self.attn_fn is None:
            attn = dot_product_attention(q.reshape(shape), k.reshape(shape),
                                         v.reshape(shape), causal=True,
                                         q_offset=q_offset)
        else:
            attn = self.attn_fn(q.reshape(shape), k.reshape(shape),
                                v.reshape(shape))
        x = x + _dense(self.proj, attn.reshape(q.shape), self.dtype)
        h = _dense(self.up, self.ln2(x), self.dtype)
        h = F.gelu(h, approximate="tanh")
        if self.dropout:
            h = F.dropout(h, self.dropout, training=self.training)
        return x + _dense(self.down, h, self.dtype)


class TransformerLM(nn.Module):
    """Causal LM: token ids ``[B, L]`` -> float32 logits ``[B, L, vocab]``.

    The knobs of the flax module, with its defaults. ``remat`` recomputes
    each block in the backward pass (``torch.utils.checkpoint``);
    ``scan_layers`` is XLA's compile-time layer scan, which eager PyTorch
    has no counterpart for, and raises. Weights are random from the numpy
    ``seed`` (flax's initialisers' scales: Dense kernels ``normal /
    sqrt(fan_in)``, embeddings ``normal / sqrt(rows)``, LayerNorm scale
    1 and biases 0; ``jax.random``'s numbers cannot be reproduced).
    ``device=None`` is the card and raises without one."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, embed_dim: int = 512,
                 max_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[Callable] = None, dropout: float = 0.0,
                 scan_layers: bool = False, remat: bool = False,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if scan_layers:
            raise NotImplementedError(
                "scan_layers is XLA's compile-time layer scan and has no "
                "eager PyTorch counterpart (ROADMAP.md Queue 1)")
        dev = resolve_device(device)
        self.dtype = dtype
        self.remat = remat
        # Built without storage and allocated on ``dev`` uninitialised:
        # ``_init_weights`` writes every parameter, so torch's default
        # initialisers (seconds on the CPU at GPT-2 width) would be
        # thrown away.
        with torch.device("meta"):
            self.embed = nn.Embedding(vocab_size, embed_dim)
            self.pos_embed = nn.Embedding(max_len, embed_dim)
            self.blocks = nn.ModuleList(
                TransformerBlock(embed_dim, num_heads, dtype=dtype,
                                 attn_fn=attn_fn, dropout=dropout)
                for _ in range(num_layers))
            self.ln_f = LayerNorm(embed_dim)
            self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)
        self.to_empty(device=dev)
        self._init_weights(seed)

    def _init_weights(self, seed: int) -> None:
        rng = np.random.default_rng(seed)

        def normal(p, std):
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            p.data.copy_(torch.from_numpy(w * np.float32(std)))

        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                normal(mod.weight, 1.0 / math.sqrt(mod.num_embeddings))
            elif isinstance(mod, nn.Linear):
                normal(mod.weight, 1.0 / math.sqrt(mod.in_features))
                if mod.bias is not None:
                    mod.bias.data.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.data.fill_(1.0)
                mod.bias.data.zero_()

    def forward(self, tokens, pos_offset: int = 0,
                return_hidden: bool = False):
        """``pos_offset``: global position of ``tokens[:, 0]``.
        ``return_hidden`` returns the float32 final-LayerNorm hidden
        states ``[B, L, E]`` instead of the logits."""
        L = tokens.shape[1]
        x = F.embedding(tokens, self.embed.weight.to(self.dtype))
        pos = pos_offset + torch.arange(L, device=tokens.device)
        x = x + F.embedding(pos, self.pos_embed.weight.to(self.dtype))[None]
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # Without dropout a block draws no random numbers, so the
                # RNG state need not be saved: reading the CUDA
                # generator's state is refused inside a CUDA graph
                # capture (distributed/window.py).
                x = checkpoint(blk, x, pos_offset, use_reentrant=False,
                               preserve_rng_state=bool(blk.dropout))
            else:
                x = blk(x, pos_offset)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return F.linear(x, self.lm_head.weight)


def block_parameter_map(p: str, blk: TransformerBlock):
    """``(flax path, parameter, transposed)`` of one
    :class:`TransformerBlock` under the flax name ``p``."""
    return [((p, "LayerNorm_0", "scale"), blk.ln1.scale, False),
            ((p, "LayerNorm_0", "bias"), blk.ln1.bias, False),
            ((p, "Dense_0", "kernel"), blk.qkv.weight, True),
            ((p, "Dense_1", "kernel"), blk.proj.weight, True),
            ((p, "Dense_1", "bias"), blk.proj.bias, False),
            ((p, "LayerNorm_1", "scale"), blk.ln2.scale, False),
            ((p, "LayerNorm_1", "bias"), blk.ln2.bias, False),
            ((p, "Dense_2", "kernel"), blk.up.weight, True),
            ((p, "Dense_2", "bias"), blk.up.bias, False),
            ((p, "Dense_3", "kernel"), blk.down.weight, True),
            ((p, "Dense_3", "bias"), blk.down.bias, False)]


def flax_parameter_map(model: TransformerLM):
    """``(flax path, parameter, transposed)`` for every parameter of
    ``model``, in the flax tree's names: a flax ``kernel [in, out]`` is
    the transpose of ``nn.Linear.weight [out, in]``."""
    pairs = [(("Embed_0", "embedding"), model.embed.weight, False),
             (("Embed_1", "embedding"), model.pos_embed.weight, False)]
    for i, blk in enumerate(model.blocks):
        pairs += block_parameter_map(f"TransformerBlock_{i}", blk)
    pairs += [(("LayerNorm_0", "scale"), model.ln_f.scale, False),
              (("LayerNorm_0", "bias"), model.ln_f.bias, False),
              (("lm_head", "kernel"), model.lm_head.weight, True)]
    return pairs


def _flax_leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flax_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_flax(tree, model: TransformerLM) -> TransformerLM:
    """Load a flax ``TransformerLM`` parameter tree, mapped to numpy
    (``jax.tree_util.tree_map(np.asarray, params)``), into ``model`` in
    place; returns ``model``. Raises when the tree's paths or shapes are
    not the model's."""
    leaves = dict(_flax_leaves(tree))
    pairs = flax_parameter_map(model)
    want = {path for path, _, _ in pairs}
    if set(leaves) != want:
        raise ValueError(
            f"flax tree does not match the model: missing "
            f"{sorted(want - set(leaves))}, unexpected "
            f"{sorted(set(leaves) - want)}")
    with torch.no_grad():
        for path, param, transposed in pairs:
            arr = np.asarray(leaves[path], dtype=np.float32)
            if transposed:
                arr = arr.T
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                                 f"model {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr, copy=True)))
    return model
