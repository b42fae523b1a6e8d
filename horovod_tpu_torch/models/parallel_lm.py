"""GPT-style LM: the port of ``horovod_tpu.models.parallel_lm``: dense,
tensor-, sequence- and pipeline-parallel.

Plain functions over a parameter dict of tensors whose structure and
layouts are exactly the JAX pytree's (``wqkv [E, 3, H, Dh]``, ``wo [H,
Dh, E]``, ``wup [E, F]``, ``wdn [F, E]``), so :func:`params_from_numpy`
carries JAX weights across unchanged. The numerics follow the JAX
functions step by step: LayerNorm statistics in float32 with the
population variance, the normalised value cast back to the input dtype
before ``* g + b``; the tanh-approximated GELU (``jax.nn.gelu``'s
default); the attention scale ``1 / math.sqrt(D)``; greedy selection as
``argmax`` of the float32 logits (the first maximum in both frameworks).

The training losses (``next_token_nll`` and the chunked
``next_token_nll_fused``) and the speculative-decoding functions
(``draft_params``, ``lm_verify_window``, ``lm_decode_spec``) are here.

**Tensor parallelism** (``tp`` = a tensor axis of the bound
:class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`): heads and MLP
features shard Megatron-style over ``torch.distributed``. Each rank
holds the shard :func:`shard_lm_params` cuts from the dense dict along
:func:`lm_param_specs` (the JAX ``device_put(NamedSharding)``), and
calls the same functions with ``tp=axis``: column-parallel QKV and
up-projections (no communication), row-parallel output and down
projections (one all-reduce each). With ``vocab_parallel`` the head is
column-sharded too and :func:`next_token_nll_fused` takes the
vocab-parallel loss. :func:`reduce_grads` pairs with it.

**Sequence parallelism** (``sp`` = a sequence axis): each rank holds
``tokens[:, r * L : (r + 1) * L]`` and the whole weights; every layer's
attention is :func:`~horovod_tpu_torch.parallel.ring_attention.
ring_attention` at global positions, the losses pass each shard's first
token back to the previous rank for its last target and normalise by the
axis's token count, and :func:`reduce_grads` sums over ``sp``. It
composes with ``tp`` (a ``dp x sp x tp`` mesh).

**Pipeline parallelism**: :func:`stack_layers` stacks the layers into
``[n_layers, ...]`` leaves, :func:`lm_pp_specs` shards them over the
stage axis (``shard_lm_params`` takes a rank's ``[1, ...]`` stage), and
:func:`lm_apply_pp` runs one block a stage under
:func:`~horovod_tpu_torch.parallel.pipeline.pipeline_apply`;
:func:`pp_reduce_rest_grads` sums the embedding tables' gradients over
the stages.

**Expert parallelism** (the Switch-MoE variant): :func:`init_moe_lm_params`
replaces each block's dense MLP by a router (``gate [E_dim, experts]``,
replicated) and stacked expert MLPs (``experts``, leading dim
``experts``); :func:`moe_lm_param_specs` shards the stacks over the
expert axis (``shard_lm_params`` gives rank ``r`` experts ``[r * E / P,
(r + 1) * E / P)``). :func:`lm_apply_moe` runs the blocks with
:func:`~horovod_tpu_torch.parallel.moe.moe_layer` over ``ep`` (each rank
its own batch shard; two all-to-alls a layer) or, with ``ep=None``, the
same routing with every expert local, and returns the logits and the
Switch auxiliary loss; :func:`moe_reduce_grads` pairs with it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves, tree_map

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.ops.attention import dot_product_attention
from horovod_tpu_torch.parallel._collectives import axis_group, ppermute
from horovod_tpu_torch.parallel.ring_attention import ring_attention
from horovod_tpu_torch.parallel.tp import (_all_reduce, shard_columns,
                                           shard_rows,
                                           sum_across, tp_mlp,
                                           tp_region_input,
                                           tp_region_output,
                                           vocab_parallel_logits)


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


def lm_param_specs(layers: int, tp_axis: Optional[str],
                   vocab_parallel: bool = False):
    """The partition specs of :func:`init_lm_params`' dict: per leaf a
    tuple with one physical axis name (or ``None``) per dimension, entry
    for entry the JAX ``PartitionSpec`` (``()`` = replicated). Heads and
    MLP features shard over ``tp_axis``; ``vocab_parallel`` also shards
    the head ``[E, V]`` by columns (pair it with
    :func:`next_token_nll_fused`'s vocab-parallel loss or the serving
    lanes' vocab all-gather). ``tp_axis=None`` replicates everything."""
    t = tp_axis
    layer_spec = {
        "ln1": {"g": (), "b": ()},
        "wqkv": (None, None, t, None),
        "wo": (t, None, None),
        "bo": (),
        "ln2": {"g": (), "b": ()},
        "wup": (None, t),
        "bup": (t,),
        "wdn": (t, None),
        "bdn": (),
    }
    return {
        "embed": (),
        "pos": (),
        "layers": [dict(layer_spec) for _ in range(layers)],
        "ln_f": {"g": (), "b": ()},
        "head": (None, t) if vocab_parallel else (),
    }


def _shard_leaf(x, spec, tp: int, index: int):
    """One leaf's shard: every dimension whose spec entry names an axis
    splits into ``tp`` parts (the last dimension by
    :func:`~horovod_tpu_torch.parallel.tp.shard_columns`, the first by
    :func:`~horovod_tpu_torch.parallel.tp.shard_rows`, a middle one
    alike), returned as a tensor of its own."""
    x = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim == x.dim() - 1:
            x = shard_columns(x, tp, index)
        elif dim == 0:
            x = shard_rows(x, tp, index)
        else:
            x = shard_columns(x.movedim(dim, -1), tp, index).movedim(-1,
                                                                     dim)
    return x.contiguous() if not x.is_contiguous() else x.clone()


def shard_lm_params(params, specs, tp: int, index: int):
    """Rank ``index``'s shard of the dense dict ``params`` (tensors, or
    numpy arrays as :func:`params_from_numpy` takes them) along
    ``specs`` (:func:`lm_param_specs`) over a tensor axis of size
    ``tp``: the counterpart of the JAX package's ``device_put`` with a
    ``NamedSharding``. Each leaf of the result is a tensor of its own on
    the leaf's device (the dense tensors can be freed)."""
    if isinstance(params, dict):
        return {k: shard_lm_params(v, specs[k], tp, index)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_lm_params(v, s, tp, index)
                for v, s in zip(params, specs)]
    return _shard_leaf(params, specs, tp, index)


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


def _project_qkv(layer, x, tp=None):
    """ln1 -> (Megatron ``f``) -> fused QKV projection onto the local
    heads: ``[B, L, E] -> 3 x [B, L, H/P, D]``."""
    a = _layernorm(x, layer["ln1"]["g"], layer["ln1"]["b"])
    if tp:
        # The upstream gradients sum the head shards' cotangents.
        a = tp_region_input(a, tp)
    qkv = torch.einsum("ble,ethd->blthd", a, layer["wqkv"])
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attn_out_residual(layer, attn, x, tp=None):
    """Row-parallel output projection (Megatron ``g``) + residual."""
    proj = torch.einsum("blhd,hde->ble", attn, layer["wo"])
    if tp:
        proj = tp_region_output(proj, tp)
    return x + proj + layer["bo"]


def _ffn_residual(layer, x, tp=None):
    m = _layernorm(x, layer["ln2"]["g"], layer["ln2"]["b"])
    if tp:
        m = tp_region_input(m, tp)
        return x + tp_mlp(m, layer["wup"], layer["bup"], layer["wdn"],
                          layer["bdn"], axis=tp)
    h = F.gelu(m @ layer["wup"] + layer["bup"], approximate="tanh")
    return x + h @ layer["wdn"] + layer["bdn"]


def _final_hidden(params, x):
    return _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def _logits(params, x, tp=None, vocab_parallel: bool = False):
    """Final LayerNorm + vocab projection -> full-vocab logits. With
    ``vocab_parallel`` the head arrives column-sharded ``[E, V/P]`` and
    the full row is assembled by one all-gather
    (:func:`~horovod_tpu_torch.parallel.tp.vocab_parallel_logits`)."""
    h = _final_hidden(params, x)
    if vocab_parallel:
        if not tp:
            raise ValueError("vocab_parallel logits need a tp axis")
        return vocab_parallel_logits(h, params["head"], axis=tp)
    return h @ params["head"]


def lm_apply(params: Dict, tokens, sp: Optional[str] = None,
             tp: Optional[str] = None, return_hidden: bool = False):
    """Token ids ``[B, L]`` -> logits ``[B, L, vocab]`` (or the final
    hidden state ``[B, L, E]`` with ``return_hidden``, for
    :func:`next_token_nll_fused`). ``tp`` names the tensor axis: the
    params are this rank's :func:`shard_lm_params` shard. ``sp`` names
    the sequence axis: ``tokens`` are this rank's ``[B, L_local]`` shard
    (global positions from ``rank * L_local``) and every layer runs ring
    attention over the axis."""
    B, L = tokens.shape
    offset = axis_group(sp, role="seq")[2] * L if sp else 0
    x = params["embed"][tokens] + params["pos"][offset:offset + L][None]
    for layer in params["layers"]:
        q, k, v = _project_qkv(layer, x, tp)
        scale = 1.0 / math.sqrt(q.shape[-1])
        if sp:
            attn = ring_attention(q, k, v, axis=sp, causal=True,
                                  scale=scale)
        else:
            attn = dot_product_attention(q, k, v, causal=True,
                                         scale=scale)
        x = _attn_out_residual(layer, attn, x, tp)
        x = _ffn_residual(layer, x, tp)
    if return_hidden:
        return _final_hidden(params, x)
    return _logits(params, x)


def lm_prefill(params: Dict, prompt, tp: Optional[str] = None):
    """Full forward over the prompt ``[B, Lp]``, capturing each layer's
    K/V into fixed-size ``[B, Lmax, H, D]`` caches (Lmax = the position
    table). Returns ``(caches, logits_last [B, vocab])``."""
    B, Lp = prompt.shape
    Lmax = params["pos"].shape[0]
    x = params["embed"][prompt] + params["pos"][None, :Lp]
    caches = []
    for layer in params["layers"]:
        q, k, v = _project_qkv(layer, x, tp)
        scale = 1.0 / math.sqrt(q.shape[-1])
        pad = (0, 0, 0, 0, 0, Lmax - Lp)
        caches.append({"k": F.pad(k, pad), "v": F.pad(v, pad)})
        attn = dot_product_attention(q, k, v, causal=True, scale=scale)
        x = _attn_out_residual(layer, attn, x, tp)
        x = _ffn_residual(layer, x, tp)
    return caches, _logits(params, x[:, -1:])[:, 0]


def lm_decode_step(params: Dict, caches, tok, t: int,
                   tp: Optional[str] = None):
    """One KV-cache decode step: write ``tok``'s K/V at position ``t``,
    attend the new token against the masked cache, return ``(new_caches,
    logits [B, vocab])``. ``tok`` is ``[B]`` integer; the input caches
    are left unchanged (the new ones are copies, as in JAX)."""
    x = params["embed"][tok][:, None] + params["pos"][t:t + 1][None]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        q, k, v = _project_qkv(layer, x, tp)             # [B, 1, H, D]
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, t] = k[:, 0]
        cv[:, t] = v[:, 0]
        new_caches.append({"k": ck, "v": cv})
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = dot_product_attention(q, ck, cv, causal=True, scale=scale,
                                     q_offset=t)
        x = _attn_out_residual(layer, attn, x, tp)
        x = _ffn_residual(layer, x, tp)
    return new_caches, _logits(params, x)[:, 0]


def lm_decode(params: Dict, prompt, steps: int, temperature: float = 0.0,
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None, tp: Optional[str] = None):
    """Autoregressive generation with a static-shape KV cache: prefill,
    then ``steps`` single-token decode steps. ``prompt`` is ``[B, Lp]``
    token ids (any integer array); the parameters and the prompt are
    moved to ``device`` (``None`` = the card). ``temperature=0`` is
    greedy argmax; otherwise categorical sampling with ``generator``
    (a ``torch.Generator`` on ``device``). Returns the generated ids
    ``[B, steps]``. ``tp`` names the tensor axis when ``params`` is a
    rank's :func:`shard_lm_params` shard (every rank of the axis calls
    it with the same prompt and draws)."""
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
        caches, logits = lm_prefill(params, prompt, tp)
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
                caches, logits = lm_decode_step(params, caches, tok, Lp + i,
                                                tp)
    return torch.stack(toks, dim=1)


def draft_params(params: Dict, layers: int) -> Dict:
    """Layer-skip self-draft: the target's FIRST ``layers`` transformer
    layers sharing the target's embed/pos/ln_f/head — the speculative
    draft as a view of the target's dict (a list slice of the layer
    dicts; no tensor is copied). The draft's K/V for layer ``l <
    layers`` are computed by exactly the target's first ``l+1`` layers,
    so the draft shares the target's KV cache rows and its weights; the
    result plugs straight into :func:`lm_decode_step` /
    :func:`lm_prefill`."""
    n = len(params["layers"])
    if not 1 <= layers <= n:
        raise ValueError(
            f"draft_params: layers={layers} outside 1..{n} (the target "
            "has that many transformer layers)")
    return {"embed": params["embed"], "pos": params["pos"],
            "layers": params["layers"][:layers],
            "ln_f": params["ln_f"], "head": params["head"]}


def lm_verify_window(params: Dict, caches, toks, t: int,
                     tp: Optional[str] = None):
    """Speculative-decoding verify pass: ONE rectangular-causal step
    over a ``w``-token window — write the window's K/V rows at positions
    ``t..t+w-1`` and return the logits at all ``w`` positions, so a
    draft's ``w-1`` proposals are verified by one target pass.

    ``toks`` is ``[B, w]`` integer (row 0 = the last emitted token, rows
    1..w-1 = the proposals), ``t`` the window's first absolute position;
    caches are :func:`lm_prefill`'s, left unchanged (the new ones are
    copies). Returns ``(new_caches, logits [B, w, vocab])``. Queries at
    ``t..t+w-1`` attend the masked cache with ``q_offset=t``, so greedy
    argmaxes match ``w`` sequential :func:`lm_decode_step` calls, and
    ``w=1`` is :func:`lm_decode_step` op for op."""
    w = toks.shape[1]
    x = params["embed"][toks] + params["pos"][t:t + w][None]
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        q, k, v = _project_qkv(layer, x, tp)             # [B, w, H, D]
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, t:t + w] = k
        cv[:, t:t + w] = v
        new_caches.append({"k": ck, "v": cv})
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = dot_product_attention(q, ck, cv, causal=True, scale=scale,
                                     q_offset=t)
        x = _attn_out_residual(layer, attn, x, tp)
        x = _ffn_residual(layer, x, tp)
    return new_caches, _logits(params, x)


def lm_decode_spec(params: Dict, prompt, steps: int, *, k: int,
                   draft_layers: int, device: DeviceLike = None,
                   tp: Optional[str] = None):
    """Greedy speculative decoding, the model-level reference of the
    serving engine's speculative lane: the layer-skip draft
    (:func:`draft_params`) proposes up to ``k`` tokens a tick, the target
    verifies them plus one bonus position in one
    :func:`lm_verify_window` pass, and the longest prefix where draft
    and target argmaxes agree is kept, plus the target's token at the
    first mismatch (or the bonus when every proposal matched).

    Every emitted token is ``argmax(float32 target logits | emitted
    prefix)``, so the result equals greedy :func:`lm_decode`'s whatever
    the draft proposed. ``prompt`` is ``[1, Lp]`` (single-row: the accept
    rule makes rows diverge in length). Returns the generated ids
    ``[1, steps]``."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                             device=dev)
    B, Lp = prompt.shape
    if B != 1:
        raise ValueError(
            f"lm_decode_spec is single-row (got B={B}): acceptance "
            "lengths diverge per row")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    Lmax = params["pos"].shape[0]
    if Lp + steps > Lmax:
        raise ValueError(
            f"prompt ({Lp}) + steps ({steps}) exceeds the position table "
            f"({Lmax})")
    dparams = draft_params(params, draft_layers)

    def argmax(logits):
        return int(torch.argmax(logits.float(), dim=-1)[0])

    with torch.no_grad():
        caches, logits_last = lm_prefill(params, prompt, tp)
        out = [argmax(logits_last)]
        while len(out) < steps:
            t = Lp + len(out) - 1
            # Budget clamp: never verify past the generation budget.
            k_eff = min(k, steps - len(out) - 1)
            # The draft steps over the target's first draft_layers
            # caches (layer-skip shares rows) on copies; the verify pass
            # writes the rows that persist.
            dcaches = caches[:draft_layers]
            tok, d = out[-1], []
            for i in range(k_eff):
                dcaches, dlg = lm_decode_step(
                    dparams, dcaches, torch.full((1,), tok, device=dev),
                    t + i, tp)
                tok = argmax(dlg)
                d.append(tok)
            window = torch.tensor([[out[-1]] + d], device=dev)
            caches, vlg = lm_verify_window(params, caches, window, t, tp)
            tgt = torch.argmax(vlg.float(), dim=-1)[0].tolist()
            for i, tok in enumerate(tgt):
                out.append(tok)
                if i < k_eff and d[i] != tok:
                    break   # correction emitted; the rest is stale
    return torch.tensor([out], device=dev)


def stack_layers(params: Dict):
    """Split the parameter dict for pipeline parallelism: the per-layer
    dicts stack into leaves with a leading ``[n_layers]`` dim (shard them
    with :func:`lm_pp_specs`, one block a stage), everything else stays
    as it is. Returns ``(rest, stacked_layers)``."""
    def stack(xs):
        if isinstance(xs[0], dict):
            return {k: stack([x[k] for x in xs]) for k in xs[0]}
        return torch.stack(xs)

    stacked = stack(params["layers"])
    rest = {k: v for k, v in params.items() if k != "layers"}
    return rest, stacked


def lm_pp_specs(rest: Dict, stacked):
    """The specs of :func:`lm_apply_pp`'s two dicts, in
    :func:`lm_param_specs`' form: ``rest`` replicated, every stacked leaf
    sharded on its leading (stage) dim over ``pp``, so
    ``shard_lm_params(stacked, spec, P, r)`` is stage ``r``'s ``[1,
    ...]`` slice (what ``shard_map`` hands the JAX function)."""
    def spec(tree, leaf):
        if isinstance(tree, dict):
            return {k: spec(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [spec(v, leaf) for v in tree]
        return leaf

    return spec(rest, ()), spec(stacked, ("pp",))


def lm_apply_pp(rest: Dict, stacked_layers, tokens, axis: str = "pp",
                microbatches: int = 2, remat: bool = False):
    """Pipeline-parallel forward: one transformer block a stage (the
    GPipe schedule of :func:`~horovod_tpu_torch.parallel.pipeline.
    pipeline_apply` over ``axis``). ``stacked_layers`` is this rank's
    stage, each leaf ``[1, ...]`` (``n_layers`` must equal the axis
    size); the embedding and the head run on every rank and the batch
    ``tokens [B, L]`` (the same on every rank) splits into
    ``microbatches``. Returns the logits ``[B, L, vocab]`` on every
    rank."""
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply

    B, L = tokens.shape
    M = microbatches
    if B % M != 0:
        raise ValueError(
            f"lm_apply_pp: batch {B} must divide into microbatches={M} "
            f"(each stage tick processes one microbatch of B/M sequences)")
    _, n_stages, _ = axis_group(axis, role="stage")
    leaves = tree_leaves(stacked_layers)
    if leaves and leaves[0].shape[0] != 1:
        raise ValueError(
            f"lm_apply_pp: per-rank stacked_layers leading dim is "
            f"{leaves[0].shape[0]}, expected 1 — pass n_layers == "
            f"'{axis}' axis size ({n_stages}) blocks, each rank its "
            f"lm_pp_specs stage (one transformer block a stage)")
    x = rest["embed"][tokens] + rest["pos"][None, :L]
    xm = x.reshape(M, B // M, L, x.shape[-1])

    def stage(layer, a):
        q, k, v = _project_qkv(layer, a, None)
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = dot_product_attention(q, k, v, causal=True, scale=scale)
        a = _attn_out_residual(layer, attn, a, None)
        return _ffn_residual(layer, a, None)

    out = pipeline_apply(stage, stacked_layers, xm, axis, remat=remat)
    return _logits(rest, out.reshape(B, L, x.shape[-1]))


def init_moe_lm_params(seed: int, vocab: int, max_len: int, layers: int,
                       heads: int, head_dim: int, ffn: int,
                       num_experts: int, dtype: torch.dtype = torch.float32,
                       device: DeviceLike = None) -> Dict:
    """Switch-MoE variant of :func:`init_lm_params`, with the JAX tree's
    keys and shapes: each block's dense MLP (``wup``, ``bup``, ``wdn``,
    ``bdn``) becomes a router ``gate [E_dim, num_experts]`` and
    ``experts`` ``{"up": [num_experts, E_dim, ffn], "bup": [num_experts,
    ffn], "dn": [num_experts, ffn, E_dim], "bdn": [num_experts,
    E_dim]}``, drawn from a numpy generator seeded ``(seed, 1000, i)``
    for block ``i`` (``normal / sqrt(fan_in)``, biases zero)."""
    dev = resolve_device(device)
    params = init_lm_params(seed, vocab, max_len, layers, heads, head_dim,
                            ffn, dtype, dev)
    embed_dim = heads * head_dim
    for i, layer in enumerate(params["layers"]):
        rng = np.random.default_rng((seed, 1000, i))

        def dense(shape, fan_in):
            w = rng.standard_normal(shape, dtype=np.float32) / math.sqrt(
                fan_in)
            return torch.from_numpy(w).to(device=dev, dtype=dtype)

        for key in ("wup", "bup", "wdn", "bdn"):
            del layer[key]
        layer["gate"] = dense((embed_dim, num_experts), embed_dim)
        layer["experts"] = {
            "up": dense((num_experts, embed_dim, ffn), embed_dim),
            "bup": torch.zeros((num_experts, ffn), dtype=dtype, device=dev),
            "dn": dense((num_experts, ffn, embed_dim), ffn),
            "bdn": torch.zeros((num_experts, embed_dim), dtype=dtype,
                               device=dev),
        }
    return params


def moe_lm_param_specs(layers: int, ep_axis: Optional[str]):
    """The specs of :func:`init_moe_lm_params`' dict in
    :func:`lm_param_specs`' form: the expert stacks shard their leading
    dim over ``ep_axis`` (the JAX ``P(ep)``), everything else is
    replicated."""
    e = ep_axis
    layer_spec = {
        "ln1": {"g": (), "b": ()},
        "wqkv": (),
        "wo": (),
        "bo": (),
        "ln2": {"g": (), "b": ()},
        "gate": (),
        "experts": {"up": (e,), "bup": (e,), "dn": (e,), "bdn": (e,)},
    }
    return {
        "embed": (),
        "pos": (),
        "layers": [dict(layer_spec) for _ in range(layers)],
        "ln_f": {"g": (), "b": ()},
        "head": (),
    }


def _expert_mlp(p, tokens):
    h = F.gelu(tokens @ p["up"] + p["bup"], approximate="tanh")
    return h @ p["dn"] + p["bdn"]


def lm_apply_moe(params: Dict, tokens, ep: Optional[str] = None,
                 capacity_factor: float = 1.25):
    """Switch-MoE LM forward: tokens ``[B_local, L] -> (logits,
    aux_loss)``.

    With ``ep`` (an expert axis of the bound mesh) the batch shards over
    the axis (data parallel for the dense parts), ``params`` is this
    rank's :func:`moe_lm_param_specs` shard, and each rank's experts
    process the tokens routed to them by two all-to-alls
    (:func:`~horovod_tpu_torch.parallel.moe.moe_layer`). ``ep=None`` runs
    the same routing with every expert local: the dense reference. The
    capacity is ``ceil(T * capacity_factor / E)`` over the call's ``T =
    B_local * L`` tokens. ``aux_loss`` is the Switch load-balancing loss,
    the mean over layers of this rank's (average it over the axis and
    add it, scaled, to the main loss)."""
    from horovod_tpu_torch.parallel import moe as _moe

    B, L = tokens.shape
    x = params["embed"][tokens] + params["pos"][None, :L]
    aux_total = 0.0
    for layer in params["layers"]:
        q, k, v = _project_qkv(layer, x, None)
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = dot_product_attention(q, k, v, causal=True, scale=scale)
        x = _attn_out_residual(layer, attn, x, None)

        m = _layernorm(x, layer["ln2"]["g"], layer["ln2"]["b"])
        flat = m.reshape(B * L, m.shape[-1])
        if ep:
            y, aux = _moe.moe_layer(flat, layer["gate"], _expert_mlp,
                                    layer["experts"], axis=ep,
                                    capacity_factor=capacity_factor,
                                    return_aux=True)
        else:
            num_experts = layer["experts"]["up"].shape[0]
            T = flat.shape[0]
            capacity = max(1, math.ceil(T * capacity_factor / num_experts))
            dispatch, combine, aux = _moe.top1_routing(
                flat, layer["gate"], num_experts, capacity)
            slots = torch.einsum("tec,td->ecd", dispatch, flat.float())
            out = torch.func.vmap(_expert_mlp)(layer["experts"],
                                               slots.to(flat.dtype))
            y = torch.einsum("tec,ecd->td", combine,
                             out.float()).to(flat.dtype)
        x = x + y.reshape(B, L, -1)
        aux_total = aux_total + aux

    return _logits(params, x), aux_total / len(params["layers"])


def moe_reduce_grads(grads: Dict, axis: str = "ep"):
    """The gradient reduction of :func:`lm_apply_moe`.

    Loss contract (the JAX function's): each rank differentiates its own
    mean nll over its token shard, and the global objective is the mean
    of those terms. Then:

    * replicated leaves (embeddings, attention, gates, head): MEAN over
      the axis;
    * expert shards: the all-to-all's backward already brought every
      rank's contribution to this rank's experts, so the gradient is the
      data-complete SUM: divide it by the axis size, with NO collective
      (a mean over the axis would mix the gradients of different
      experts).

    Returns a new dict; the inputs are left unchanged."""
    group, n, _ = axis_group(axis, role="expert")

    def mean(tree):
        return tree_map(lambda g: _reduced(g, group, n, mean=True), tree)

    def layer(layer_g):
        return {k: tree_map(lambda g: g / n, v) if k == "experts"
                else mean(v) for k, v in layer_g.items()}

    return {k: [layer(g) for g in v] if k == "layers" else mean(v)
            for k, v in grads.items()}


def _reduced(g, group, n: int, mean: bool):
    """``g``'s all-reduce over ``group`` (``None``: an axis of one, ``g``
    itself): the sum, or the mean."""
    if group is None:
        return g
    out = _all_reduce(g, group)
    return out / n if mean else out


def pp_reduce_rest_grads(g_rest: Dict, axis: str = "pp"):
    """The gradient reduction of :func:`lm_apply_pp`'s replicated
    parameters. The embedding and position tables are read only by stage
    0's injection, so their gradients are whole on the first stage and
    zero elsewhere: SUM them over ``axis``. The final LayerNorm and the
    head run on every rank over the pipeline's broadcast output, so
    their gradients are already whole and equal: left as they are.
    Returns a new dict."""
    group, n, _ = axis_group(axis, role="stage")
    out = dict(g_rest)
    for key in ("embed", "pos"):
        out[key] = _reduced(g_rest[key], group, n, mean=False)
    return out


def _shifted_targets(tokens, sp: Optional[str] = None):
    """Next-token targets and validity weights: ``targets [B, L]`` are
    the tokens shifted left by one and ``valid [B, L]`` float32 masks out
    the last global position. Without a sequence axis the last position
    wraps to the first token (any valid id); with ``sp`` each shard's
    last target is the next shard's first token, one ``ppermute`` of
    ``tokens[:, :1]`` to the previous rank."""
    B, L = tokens.shape
    if sp:
        _, n, index = axis_group(sp, role="seq")
        nxt = ppermute(tokens[:, :1].contiguous(), sp, -1)
        tgt = torch.cat([tokens[:, 1:], nxt], dim=1)
        gpos = index * L + torch.arange(L, device=tokens.device)
        valid = (gpos < n * L - 1).float()
    else:
        tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        valid = (torch.arange(L, device=tokens.device) < L - 1).float()
    return tgt, valid[None, :].expand(B, L)


def _count_over(cnt, sp: Optional[str]):
    """The token count summed over the sequence axis (no gradient)."""
    if not sp:
        return cnt
    group, n, _ = axis_group(sp, role="seq")
    return _reduced(cnt.detach(), group, n, mean=False)


def next_token_nll(logits, tokens, sp: Optional[str] = None):
    """Mean next-token negative log-likelihood of ``logits [B, L, V]``
    against ``tokens [B, L]``, in float32. With ``sp`` the mean is over
    the whole sequence of the axis, the same value on every rank."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt, valid = _shifted_targets(tokens, sp)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    local_sum = (nll * valid).sum()
    if sp:
        # sum_across, not a bare all-reduce: its backward is the
        # identity, so the gradient is not scaled by the axis size.
        return sum_across(local_sum, sp) / _count_over(valid.sum(), sp)
    return local_sum / valid.sum()


def next_token_nll_fused(params: Dict, hidden, tokens,
                         sp: Optional[str] = None, tp: Optional[str] = None,
                         vocab_parallel: bool = False, t_chunk: int = 512):
    """:func:`next_token_nll` without the ``[B, L, V]`` logits:
    ``hidden`` is :func:`lm_apply`'s ``return_hidden=True`` output, and
    the vocab projection happens chunk by chunk inside
    :func:`~horovod_tpu_torch.ops.xent.fused_cross_entropy`. With
    ``vocab_parallel`` the head arrives ``[E, V/P]``-sharded over ``tp``
    (:func:`lm_param_specs` ``vocab_parallel=True``) and
    :func:`~horovod_tpu_torch.ops.xent.tp_vocab_cross_entropy` assembles
    the normaliser over the axis: the same loss on every rank. With
    ``sp`` each shard's share of the loss is normalised by the axis's
    token count and summed over the axis."""
    from horovod_tpu_torch.ops.xent import (fused_cross_entropy,
                                            tp_vocab_cross_entropy)

    B, L = tokens.shape
    tgt, valid = _shifted_targets(tokens, sp)
    e = hidden.shape[-1]
    w2 = valid.reshape(B * L)
    denom = _count_over(w2.sum(), sp)
    # params["head"] is [E, V]; the fused losses take nn.Linear's [V, E].
    args = (hidden.reshape(B * L, e), params["head"].t(), tgt.reshape(B * L))
    if vocab_parallel:
        if not tp:
            raise ValueError("vocab_parallel needs a tp axis")
        local = tp_vocab_cross_entropy(*args, tp, t_chunk, weights=w2,
                                       denom=denom)
    else:
        local = fused_cross_entropy(*args, t_chunk, weights=w2,
                                    denom=denom)
    return sum_across(local, sp) if sp else local


def reduce_grads(grads, dp: Optional[str] = None, sp: Optional[str] = None):
    """The gradient reduction that pairs with :func:`next_token_nll` and
    :func:`next_token_nll_fused`, on a gradient dict of the params'
    structure (this rank's shard's gradients):

    * ``sp``: SUM over the sequence axis — the loss is already normalised
      by the axis's token count, so each rank's backward holds its own
      tokens' share of the gradient;
    * ``dp``: MEAN over the data axis of the bound mesh — the global
      loss is the mean of the data shards' means;
    * ``tp``: nothing — the tensor axis's ranks see the same data, so
      replicated leaves get the same gradients (the ``f``/``g``
      conjugates sum the shards' terms) and sharded leaves' gradients
      are exactly their slices.

    Returns a new dict; the inputs are left unchanged."""
    for axis, role, mean in ((sp, "seq", False), (dp, "data", True)):
        if axis:
            group, n, _ = axis_group(axis, role=role)
            grads = tree_map(lambda g: _reduced(g, group, n, mean), grads)
    return grads
