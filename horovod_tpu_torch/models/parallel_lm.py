"""GPT-style LM, dense path: the port of ``horovod_tpu.models.parallel_lm``
with ``sp=tp=None``.

Plain functions over a parameter dict of tensors whose structure and
layouts are exactly the JAX pytree's (``wqkv [E, 3, H, Dh]``, ``wo [H,
Dh, E]``, ``wup [E, F]``, ``wdn [F, E]``), so :func:`params_from_numpy`
carries JAX weights across unchanged. The numerics follow the JAX
functions step by step: LayerNorm statistics in float32 with the
population variance, the normalised value cast back to the input dtype
before ``* g + b``; the tanh-approximated GELU (``jax.nn.gelu``'s
default); the attention scale ``1 / math.sqrt(D)``; greedy selection as
``argmax`` of the float32 logits (the first maximum in both frameworks).

The dense training losses (``next_token_nll`` and the chunked
``next_token_nll_fused``) are here; tensor, sequence and pipeline
parallelism and the MoE variant are ported by later slices (ROADMAP.md
Queue 1, parallelism).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.ops.attention import dot_product_attention


def init_lm_params(seed: int, vocab: int, max_len: int, layers: int,
                   heads: int, head_dim: int, ffn: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Dict:
    """Dense parameter dict with random weights from a numpy seed:
    ``normal / sqrt(fan_in)`` like the JAX initialiser (whose
    ``jax.random`` numbers the port cannot reproduce), LayerNorm gains
    one and biases zero. ``device=None`` is the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    embed_dim = heads * head_dim

    def dense(shape, fan_in):
        w = rng.standard_normal(shape, dtype=np.float32) / math.sqrt(fan_in)
        return torch.from_numpy(w).to(device=dev, dtype=dtype)

    def const(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    params: Dict[str, Any] = {
        "embed": dense((vocab, embed_dim), embed_dim),
        "pos": dense((max_len, embed_dim), embed_dim),
        "layers": [],
        "ln_f": {"g": const(embed_dim, 1.0), "b": const(embed_dim, 0.0)},
        "head": dense((embed_dim, vocab), embed_dim),
    }
    for _ in range(layers):
        params["layers"].append({
            "ln1": {"g": const(embed_dim, 1.0), "b": const(embed_dim, 0.0)},
            "wqkv": dense((embed_dim, 3, heads, head_dim), embed_dim),
            "wo": dense((heads, head_dim, embed_dim), embed_dim),
            "bo": const(embed_dim, 0.0),
            "ln2": {"g": const(embed_dim, 1.0), "b": const(embed_dim, 0.0)},
            "wup": dense((embed_dim, ffn), embed_dim),
            "bup": const(ffn, 0.0),
            "wdn": dense((ffn, embed_dim), ffn),
            "bdn": const(embed_dim, 0.0),
        })
    return params


def params_from_numpy(tree, device: DeviceLike, dtype=None):
    """A JAX parameter pytree, already mapped to numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's dict
    of tensors with the same structure. ``dtype`` casts every leaf."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        t = torch.tensor(np.asarray(x), device=dev)
        return t if dtype is None else t.to(dtype)

    return conv(tree)


def params_to(params, device: torch.device):
    """The same parameter dict with every tensor on ``device`` (leaves
    already there are returned as they are)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return params.to(device)


def _layernorm(x, g, b):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype) * g + b


def _project_qkv(layer, x):
    """ln1 -> fused QKV projection: ``[B, L, E] -> 3 x [B, L, H, D]``."""
    a = _layernorm(x, layer["ln1"]["g"], layer["ln1"]["b"])
    qkv = torch.einsum("ble,ethd->blthd", a, layer["wqkv"])
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attn_out_residual(layer, attn, x):
    """Output projection + residual."""
    proj = torch.einsum("blhd,hde->ble", attn, layer["wo"])
    return x + proj + layer["bo"]


def _ffn_residual(layer, x):
    m = _layernorm(x, layer["ln2"]["g"], layer["ln2"]["b"])
    h = F.gelu(m @ layer["wup"] + layer["bup"], approximate="tanh")
    return x + h @ layer["wdn"] + layer["bdn"]


def _final_hidden(params, x):
    return _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def _logits(params, x):
    """Final LayerNorm + vocab projection -> full-vocab logits."""
    return _final_hidden(params, x) @ params["head"]


def lm_apply(params: Dict, tokens, return_hidden: bool = False):
    """Token ids ``[B, L]`` -> logits ``[B, L, vocab]`` (or the final
    hidden state ``[B, L, E]`` with ``return_hidden``)."""
    B, L = tokens.shape
    x = params["embed"][tokens] + params["pos"][:L][None]
    for layer in params["layers"]:
        q, k, v = _project_qkv(layer, x)
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = dot_product_attention(q, k, v, causal=True, scale=scale)
        x = _attn_out_residual(layer, attn, x)
        x = _ffn_residual(layer, x)
    if return_hidden:
        return _final_hidden(params, x)
    return _logits(params, x)


def lm_prefill(params: Dict, prompt):
    """Full forward over the prompt ``[B, Lp]``, capturing each layer's
    K/V into fixed-size ``[B, Lmax, H, D]`` caches (Lmax = the position
    table). Returns ``(caches, logits_last [B, vocab])``."""
    B, Lp = prompt.shape
    Lmax = params["pos"].shape[0]
    x = params["embed"][prompt] + params["pos"][None, :Lp]
    caches = []
    for layer in params["layers"]:
        q, k, v = _project_qkv(layer, x)
        scale = 1.0 / math.sqrt(q.shape[-1])
        pad = (0, 0, 0, 0, 0, Lmax - Lp)
        caches.append({"k": F.pad(k, pad), "v": F.pad(v, pad)})
        attn = dot_product_attention(q, k, v, causal=True, scale=scale)
        x = _attn_out_residual(layer, attn, x)
        x = _ffn_residual(layer, x)
    return caches, _logits(params, x[:, -1:])[:, 0]


def lm_decode_step(params: Dict, caches, tok, t: int):
    """One KV-cache decode step: write ``tok``'s K/V at position ``t``,
    attend the new token against the masked cache, return ``(new_caches,
    logits [B, vocab])``. ``tok`` is ``[B]`` integer; the input caches
    are left unchanged (the new ones are copies, as in JAX)."""
    x = params["embed"][tok][:, None] + params["pos"][t:t + 1][None]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        q, k, v = _project_qkv(layer, x)                 # [B, 1, H, D]
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, t] = k[:, 0]
        cv[:, t] = v[:, 0]
        new_caches.append({"k": ck, "v": cv})
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = dot_product_attention(q, ck, cv, causal=True, scale=scale,
                                     q_offset=t)
        x = _attn_out_residual(layer, attn, x)
        x = _ffn_residual(layer, x)
    return new_caches, _logits(params, x)[:, 0]


def lm_decode(params: Dict, prompt, steps: int, temperature: float = 0.0,
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None):
    """Autoregressive generation with a static-shape KV cache: prefill,
    then ``steps`` single-token decode steps. ``prompt`` is ``[B, Lp]``
    token ids (any integer array); the parameters and the prompt are
    moved to ``device`` (``None`` = the card). ``temperature=0`` is
    greedy argmax; otherwise categorical sampling with ``generator``
    (a ``torch.Generator`` on ``device``). Returns the generated ids
    ``[B, steps]``."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                             device=dev)
    B, Lp = prompt.shape
    Lmax = params["pos"].shape[0]
    if Lp + steps > Lmax:
        raise ValueError(
            f"prompt ({Lp}) + steps ({steps}) exceeds the position table "
            f"({Lmax})")
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")

    with torch.no_grad():
        caches, logits = lm_prefill(params, prompt)
        toks = []
        for i in range(steps):
            lg = logits.float()
            if temperature > 0:
                tok = torch.multinomial(torch.softmax(lg / temperature, -1),
                                        1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(lg, dim=-1)
            toks.append(tok)
            if i + 1 < steps:   # the last token is never fed back
                caches, logits = lm_decode_step(params, caches, tok, Lp + i)
    return torch.stack(toks, dim=1)


def _dense_only(sp, tp, vocab_parallel=False):
    if sp is not None or tp is not None or vocab_parallel:
        raise NotImplementedError(
            "sequence- and tensor-parallel losses shard the sequence or "
            "the head over a mesh axis, which the port does not have yet "
            "(ROADMAP.md Queue 1, parallelism); pass sp=None, tp=None")


def _shifted_targets(tokens, sp: Optional[str] = None):
    """Next-token targets and validity weights for the dense path
    (``sp=None``): ``targets [B, L]`` are the tokens shifted left by one
    (the last position wraps to the first token, any valid id) and
    ``valid [B, L]`` float32 masks out the last position."""
    _dense_only(sp, None)
    B, L = tokens.shape
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = (torch.arange(L, device=tokens.device) < L - 1).float()
    return tgt, valid[None, :].expand(B, L)


def next_token_nll(logits, tokens, sp: Optional[str] = None):
    """Mean next-token negative log-likelihood of ``logits [B, L, V]``
    against ``tokens [B, L]``, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt, valid = _shifted_targets(tokens, sp)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    return (nll * valid).sum() / valid.sum()


def next_token_nll_fused(params: Dict, hidden, tokens,
                         sp: Optional[str] = None, tp: Optional[str] = None,
                         vocab_parallel: bool = False, t_chunk: int = 512):
    """:func:`next_token_nll` without the ``[B, L, V]`` logits:
    ``hidden`` is :func:`lm_apply`'s ``return_hidden=True`` output, and
    the vocab projection happens chunk by chunk inside
    :func:`~horovod_tpu_torch.ops.xent.fused_cross_entropy`."""
    from horovod_tpu_torch.ops.xent import fused_cross_entropy

    _dense_only(sp, tp, vocab_parallel)
    B, L = tokens.shape
    tgt, valid = _shifted_targets(tokens)
    e = hidden.shape[-1]
    w2 = valid.reshape(B * L)
    # params["head"] is [E, V]; the fused loss takes nn.Linear's [V, E].
    return fused_cross_entropy(hidden.reshape(B * L, e), params["head"].t(),
                               tgt.reshape(B * L), t_chunk, weights=w2,
                               denom=w2.sum())
