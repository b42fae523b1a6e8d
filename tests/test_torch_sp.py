"""The port's sequence parallelism (``horovod_tpu_torch.parallel``'s
``ppermute``/``all_to_all``, ``ring_attention``, ``ulysses_attention``,
and the ``sp`` half of ``models.parallel_lm``) in 4- and 8-rank gloo
worlds, against the JAX package under ``shard_map``.

One gloo world per size (started once for the module by the ``world``
fixture, on ``tests/test_torch_tp.py``'s ``start_world``) runs every
case and saves each rank's results; the JAX side runs in this process on
tests/conftest.py's 8-device virtual CPU mesh with the same numpy
inputs. Rank ``r`` of a sequence axis holds the ``r``-th sequence shard.

* ``ppermute`` (shifts 1 and -1) and the tiled ``all_to_all``: forward
  and gradient against ``lax.ppermute``/``lax.all_to_all``, exactly
  (data movement only);
* ``ring_attention`` at sp 4 and 8 (tests/test_parallel.py's cases):
  forward causal and not to atol 2e-5; gradients with the dead-block
  skip on and off to rtol 2e-4 / atol 2e-5 against the JAX gradients,
  and the two skip settings equal to each other;
* ``ulysses_attention``: forward causal and not to atol 2e-5; the
  "divisible" error at 8 ranks over 4 heads; ``use_flash=True`` (the
  plain K1-K3 on the CPU) forward and gradients against the JAX function
  with ``flash_attention(block_q=32, block_k=32)`` in interpret mode, to
  atol 1e-4;
* the LM (tests/test_parallel_lm.py's pins): ``lm_apply(sp=)`` at sp 4
  (rtol 2e-4 / atol 2e-5); ``dp=2,sp=2,tp=2`` forward, loss and the
  gradients after ``reduce_grads`` (loss rtol 2e-4, gradients rtol 3e-4
  / atol 3e-5), with ``next_token_nll`` and with the fused
  vocab-parallel loss; ZeRO over ``dp`` composed with ``sp`` at
  ``dp=2,sp=4``, five Adam steps (losses against plain dp-averaged Adam
  and against the JAX trajectory, rtol 5e-4);
* ``TransformerLM`` with a ring and with a Ulysses ``attn_fn`` and
  ``pos_offset``, against the flax ``TransformerLM`` under ``shard_map``
  on the same weights (atol 2e-5).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from horovod_tpu import parallel as jpar
from horovod_tpu.models import parallel_lm as jplm
from horovod_tpu.models.transformer import TransformerLM as JLM
from horovod_tpu.ops.attention import dot_product_attention as jdpa
from horovod_tpu.ops.attention import flash_attention as jflash
from horovod_tpu_torch.models import parallel_lm as tplm
from test_torch_tp import _leaves, _np_tree, start_world

WORLDS = [4, 8]
ATTN_TOL = dict(atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
FLASH_TOL = dict(atol=1e-4)
LM_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
# tests/test_parallel_lm.py's LM: 2 layers, 4 heads of 8, MLP 32, vocab
# 64, 64 positions; a batch of 4 x 16 tokens.
V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 4, 8, 32
B, L = 4, 16
T_CHUNK = 8
ZERO_STEPS = 5
# The flax model of the TransformerLM cases: 4 heads split over sp=4.
TCFG = dict(vocab_size=32, num_layers=2, num_heads=4, embed_dim=32,
            max_len=32)


# ------------------------------------------------------------- inputs


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


RING = (2, 64, 2, 8)            # L_local 16 at sp 4, 8 at sp 8
ULYSSES = (2, 32, 4, 8)         # H == 4
FLASH = (2, 128, 4, 16)         # flash blocks of 32 cover L


def _collective_input(n):
    """x [4n, 2n, 3] (rank r holds rows 4r..4r+3) and a cotangent per
    output: of ``ppermute`` ([4n, 2n, 3]) and of the all-to-all
    ``split 1 -> concat 0`` ([4n * n, 2, 3] assembled)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((4 * n, 2 * n, 3)).astype(np.float32)
    cp = rng.standard_normal((4 * n, 2 * n, 3)).astype(np.float32)
    ca = rng.standard_normal((4 * n * n, 2, 3)).astype(np.float32)
    return x, cp, ca


def _lm_params():
    """The LM's dense weights from a numpy seed, in the JAX pytree's
    layout (``normal / sqrt(fan_in)``, LayerNorm gains about one)."""
    rng = np.random.default_rng(41)
    e = H * DH

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def ln():
        return {"g": (1 + 0.1 * rng.standard_normal(e)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(e)).astype(np.float32)}

    return {
        "embed": dense((V, e), e), "pos": dense((LMAX, e), e),
        "layers": [{"ln1": ln(), "wqkv": dense((e, 3, H, DH), e),
                    "wo": dense((H, DH, e), e), "bo": dense((e,), e),
                    "ln2": ln(), "wup": dense((e, FFN), e),
                    "bup": dense((FFN,), e), "wdn": dense((FFN, e), FFN),
                    "bdn": dense((e,), FFN)} for _ in range(LAYERS)],
        "ln_f": ln(), "head": dense((e, V), e),
    }


def _tokens():
    return np.random.default_rng(42).integers(0, V, (B, L)).astype(np.int32)


def _flax_params():
    toks = np.zeros((1, 8), np.int32)
    params = JLM(**TCFG, dtype=jnp.float32).init(
        jax.random.PRNGKey(5), jnp.asarray(toks), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _tlm_tokens():
    return np.random.default_rng(43).integers(0, 32, (2, 32)).astype(
        np.int32)


def _seq(a, n, r, axis=1):
    c = a.shape[axis] // n
    return np.take(a, range(r * c, (r + 1) * c), axis=axis)


# ---------------------------------------------------------- the ranks


def _grads_of(fn, *inputs):
    """``fn`` on leaf copies of ``inputs``; backward of ``sum(out *
    cot)`` with the cotangent ``fn`` returns; the output and each
    input's gradient as numpy."""
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out, cot = fn(*ts)
    (out * torch.as_tensor(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _squared(out):
    """``out`` and the cotangent of ``sum(out ** 2)``."""
    return out, 2 * out.detach()


def _collective_cases(n, rank):
    from horovod_tpu_torch.parallel._collectives import all_to_all, ppermute

    x, cp, ca = _collective_input(n)
    xs = _seq(x, n, rank, 0)
    res = {}
    for shift in (1, -1):
        res[("ppermute", shift)] = _grads_of(
            lambda t: (ppermute(t, "sp", shift), _seq(cp, n, rank, 0)), xs)
    res["all_to_all"] = _grads_of(
        lambda t: (all_to_all(t, "sp", 1, 0), _seq(ca, n, rank, 0)), xs)
    return res


def _attention_cases(n, rank):
    from horovod_tpu_torch.parallel import ring_attention, ulysses_attention

    res = {}
    q, k, v = (_seq(a, n, rank) for a in _qkv(RING, 1))
    for causal, skip in ((False, None), (True, None), (True, True),
                         (True, False)):
        before = ring_attention.skipped
        res[("ring", causal, skip)] = _grads_of(
            lambda a, b, c: _squared(ring_attention(
                a, b, c, "sp", causal=causal, skip_dead_blocks=skip)),
            q, k, v) + (ring_attention.skipped - before,)
    if n == 4:
        q, k, v = (_seq(a, n, rank) for a in _qkv(ULYSSES, 2))
        for causal in (False, True):
            res[("ulysses", causal)] = _grads_of(
                lambda a, b, c: _squared(
                    ulysses_attention(a, b, c, "sp", causal=causal)),
                q, k, v)
        q, k, v = (_seq(a, n, rank) for a in _qkv(FLASH, 3))
        for causal in (False, True):
            res[("flash", causal)] = _grads_of(
                lambda a, b, c: _squared(
                    ulysses_attention(a, b, c, "sp", causal=causal,
                                      use_flash=True)),
                q, k, v)
    else:
        try:
            z = torch.zeros(1, 16 // n, 4, 8)
            ulysses_attention(z, z, z, "sp")
            res["divisible"] = None
        except ValueError as e:
            res["divisible"] = str(e)
    return res


def _lm_step(params, tokens, sp=None, tp=None, fused=False,
             vocab_parallel=False):
    """One loss and its gradients (before any reduction)."""
    tree = tplm.params_from_numpy(params, device="cpu")
    for x in _leaves(tree):
        x.requires_grad_(True)
    toks = torch.tensor(tokens, dtype=torch.long)
    if fused:
        hidden = tplm.lm_apply(tree, toks, sp=sp, tp=tp, return_hidden=True)
        loss = tplm.next_token_nll_fused(tree, hidden, toks, sp=sp, tp=tp,
                                         vocab_parallel=vocab_parallel,
                                         t_chunk=T_CHUNK)
    else:
        loss = tplm.next_token_nll(tplm.lm_apply(tree, toks, sp=sp, tp=tp),
                                   toks, sp=sp)
    loss.backward()

    def grads(t):
        if isinstance(t, dict):
            return {k: grads(v) for k, v in t.items()}
        if isinstance(t, list):
            return [grads(v) for v in t]
        return t.grad
    return loss, grads(tree)


def _zero_run(rank, lm, use_zero):
    """Five Adam(1e-2) steps of the sp LM over ``dp=2,sp=4``: ZeRO over
    ``dp`` (``reduce_grads(sp=)``) or plain Adam on ``reduce_grads(dp=,
    sp=)``. Returns the dp-mean losses."""
    import torch.distributed as dist

    from horovod_tpu_torch.distributed.zero import (
        shard_info, sharded_distributed_optimizer)

    dp_i, sp_i, = (int(x) for x in np.argwhere(lm.ranks == rank)[0])
    toks = torch.tensor(_seq(_tokens()[2 * dp_i:2 * dp_i + 2], 4, sp_i),
                        dtype=torch.long)
    tree = tplm.params_from_numpy(_lm_params(), device="cpu")
    leaves = _leaves(tree)
    for x in leaves:
        x.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-2)
    if use_zero:
        opt = sharded_distributed_optimizer(opt, axis_name="dp")
    losses = []
    for _ in range(ZERO_STEPS):
        opt.zero_grad()
        loss = tplm.next_token_nll(tplm.lm_apply(tree, toks, sp="sp"), toks,
                                   sp="sp")
        loss.backward()
        red = tplm.reduce_grads([x.grad for x in leaves],
                                dp=None if use_zero else "dp", sp="sp")
        for x, g in zip(leaves, red):
            x.grad = g
        opt.step()
        mean = loss.detach().clone()
        dist.all_reduce(mean, group=lm.mesh.get_group("dp"))
        losses.append(float(mean) / 2)
    return losses, (shard_info(opt) if use_zero else None)


def _lm_cases(n, rank):
    from functools import partial

    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      params_from_flax)
    from horovod_tpu_torch.parallel import (LogicalMesh, bind,
                                            ring_attention,
                                            ulysses_attention)

    params, tokens = _lm_params(), _tokens()
    res = {}
    if n == 4:
        with bind(LogicalMesh.from_config("sp=4")):
            toks = torch.tensor(_seq(tokens, 4, rank), dtype=torch.long)
            with torch.no_grad():
                res["sp_forward"] = tplm.lm_apply(
                    tplm.params_from_numpy(params, device="cpu"), toks,
                    sp="sp").numpy()
            t = _tlm_tokens()
            lt = t.shape[1] // 4
            for name, fn in (
                    ("ring", partial(ring_attention, axis="sp",
                                     causal=True)),
                    ("ulysses", partial(ulysses_attention, axis="sp",
                                        causal=True, use_flash=True))):
                model = params_from_flax(_flax_params(), TransformerLM(
                    **TCFG, dtype=torch.float32, attn_fn=fn, device="cpu"))
                with torch.no_grad():
                    res[("tlm", name)] = model(
                        torch.tensor(_seq(t, 4, rank), dtype=torch.long),
                        pos_offset=rank * lt).numpy()
        return res
    lm = LogicalMesh.from_config("dp=2,sp=2,tp=2")
    dp_i, sp_i, tp_i = (int(x) for x in np.argwhere(lm.ranks == rank)[0])
    toks = _seq(tokens[2 * dp_i:2 * dp_i + 2], 2, sp_i)
    with bind(lm):
        shard = tplm.shard_lm_params(
            params, tplm.lm_param_specs(LAYERS, "tp"), 2, tp_i)
        with torch.no_grad():
            res["dst_forward"] = tplm.lm_apply(
                tplm.params_from_numpy(shard, device="cpu"),
                torch.tensor(toks, dtype=torch.long), sp="sp",
                tp="tp").numpy()
        loss, g = _lm_step(_np_tree(shard), toks, sp="sp", tp="tp")
        res["dst_step"] = (float(loss), _np_tree(
            tplm.reduce_grads(g, dp="dp", sp="sp")))
        vshard = tplm.shard_lm_params(
            params, tplm.lm_param_specs(LAYERS, "tp", vocab_parallel=True),
            2, tp_i)
        loss, g = _lm_step(_np_tree(vshard), toks, sp="sp", tp="tp",
                           fused=True, vocab_parallel=True)
        res["dst_fused"] = (float(loss), _np_tree(
            tplm.reduce_grads(g, dp="dp", sp="sp")))
    res["dst_index"] = (dp_i, sp_i, tp_i)
    lm = LogicalMesh.from_config("dp=2,sp=4")
    with bind(lm):
        res["zero"] = _zero_run(rank, lm, True)
        res["plain"] = _zero_run(rank, lm, False)
    return res


def _worker(rank, n, init, out):
    """One rank of an ``n``-rank gloo world: every case, results saved."""
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    basics.init(device="cpu")
    with bind(LogicalMesh.from_config(f"sp={n}")):
        res = {"collectives": _collective_cases(n, rank),
               "attention": _attention_cases(n, rank)}
    res.update(_lm_cases(n, rank))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    basics.shutdown()
    dist.destroy_process_group()


def _start(n, tmp_path_factory):
    return n, start_world(n, str(tmp_path_factory.mktemp(f"sp{n}")),
                          "test_torch_sp")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _start(4, tmp_path_factory)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _start(8, tmp_path_factory)


@pytest.fixture(params=WORLDS, ids=lambda n: f"sp{n}")
def world(request):
    return request.getfixturevalue(f"world{request.param}")


# --------------------------------------------------------- the JAX side


def _jrun(fn, axes, in_specs, out_specs, *args, check_vma=True):
    n = int(np.prod(list(axes.values())))
    mesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs,
                                 check_vma=check_vma))(*args)


def _jax_attention_grads(attn, n, inputs, check_vma=True):
    """The sharded attention's output and the gradients of ``sum(out **
    2)`` over the whole sequence, as numpy."""
    q, k, v = (jnp.asarray(a) for a in inputs)
    fn = jax.shard_map(attn, mesh=jpar.make_mesh(
        {"sp": n}, devices=jax.devices()[:n]), in_specs=P(None, "sp"),
        out_specs=P(None, "sp"), check_vma=check_vma)
    out = jax.jit(fn)(q, k, v)
    g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                         (0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in g]


# ------------------------------------------------------- collectives


@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_matches_lax_ppermute(world, shift):
    n, ranks = world
    x, cp, _ = _collective_input(n)
    perm = [(i, (i + shift) % n) for i in range(n)]

    def region(a, c):
        y, vjp = jax.vjp(lambda t: lax.ppermute(t, "sp", perm), a)
        return y, vjp(c)[0]

    y, gx = (np.asarray(t) for t in _jrun(
        region, {"sp": n}, (P("sp"), P("sp")), (P("sp"), P("sp")),
        x, cp))
    for r, res in enumerate(ranks):
        out, (g,) = res["collectives"][("ppermute", shift)]
        np.testing.assert_array_equal(out, _seq(y, n, r, 0))
        np.testing.assert_array_equal(g, _seq(gx, n, r, 0))


def test_all_to_all_matches_lax_all_to_all(world):
    n, ranks = world
    x, _, ca = _collective_input(n)

    def region(a, c):
        y, vjp = jax.vjp(lambda t: lax.all_to_all(
            t, "sp", split_axis=1, concat_axis=0, tiled=True), a)
        return y, vjp(c)[0]

    y, gx = (np.asarray(t) for t in _jrun(
        region, {"sp": n}, (P("sp"), P("sp")), (P("sp"), P("sp")),
        x, ca))
    for r, res in enumerate(ranks):
        out, (g,) = res["collectives"]["all_to_all"]
        assert out.shape == (4 * n, 2, 3)
        np.testing.assert_array_equal(out, _seq(y, n, r, 0))
        np.testing.assert_array_equal(g, _seq(gx, n, r, 0))


# ----------------------------------------------------- ring attention


@pytest.mark.parametrize("causal,skip", [(False, None), (True, None),
                                         (True, True), (True, False)])
def test_ring_attention_matches_jax(world, causal, skip):
    n, ranks = world
    inputs = _qkv(RING, 1)
    want, wgrads = _jax_attention_grads(
        lambda a, b, c: jpar.ring_attention(
            a, b, c, "sp", causal=causal,
            skip_dead_blocks=causal and skip is not False),
        n, inputs, check_vma=False)
    np.testing.assert_allclose(
        want, np.asarray(jdpa(*map(jnp.asarray, inputs), causal=causal)),
        **ATTN_TOL)
    skipped = 0
    for r, res in enumerate(ranks):
        out, grads, nskip = res["attention"][("ring", causal, skip)]
        np.testing.assert_allclose(out, _seq(want, n, r), **ATTN_TOL)
        for got, w in zip(grads, wgrads):
            np.testing.assert_allclose(got, _seq(w, n, r), **GRAD_TOL)
        skipped += nskip
    # Rank r skips the blocks of ranks above it: n(n-1)/2 block-steps.
    assert skipped == (n * (n - 1) // 2 if causal and skip is not False
                       else 0)


def test_ring_dead_block_skip_changes_nothing(world):
    """The skip and the masked products give the same numbers."""
    _, ranks = world
    for res in ranks:
        on = res["attention"][("ring", True, True)]
        off = res["attention"][("ring", True, False)]
        np.testing.assert_allclose(on[0], off[0], rtol=1e-6, atol=1e-7)
        for a, b in zip(on[1], off[1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ Ulysses


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(world4, causal):
    n, ranks = world4
    inputs = _qkv(ULYSSES, 2)
    want, wgrads = _jax_attention_grads(
        lambda a, b, c: jpar.ulysses_attention(a, b, c, "sp",
                                               causal=causal),
        n, inputs)
    for r, res in enumerate(ranks):
        out, grads = res["attention"][("ulysses", causal)]
        np.testing.assert_allclose(out, _seq(want, n, r), **ATTN_TOL)
        for got, w in zip(grads, wgrads):
            np.testing.assert_allclose(got, _seq(w, n, r), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_flash_matches_jax_interpret(world4, causal):
    n, ranks = world4

    def flash(qh, kh, vh, causal, scale):
        return jflash(qh, kh, vh, causal=causal, scale=scale, block_q=32,
                      block_k=32, interpret=True)

    want, wgrads = _jax_attention_grads(
        lambda a, b, c: jpar.ulysses_attention(a, b, c, "sp", causal=causal,
                                               attn_fn=flash),
        n, _qkv(FLASH, 3), check_vma=False)
    for r, res in enumerate(ranks):
        out, grads = res["attention"][("flash", causal)]
        np.testing.assert_allclose(out, _seq(want, n, r), **FLASH_TOL)
        for got, w in zip(grads, wgrads):
            np.testing.assert_allclose(got, _seq(w, n, r), **FLASH_TOL)


def test_ulysses_head_divisibility_error(world8):
    _, ranks = world8
    with pytest.raises(ValueError, match="divisible"):
        _jrun(lambda a: jpar.ulysses_attention(a, a, a, "sp"), {"sp": 8},
              P(None, "sp"), P(None, "sp"), jnp.zeros((1, 16, 4, 8)))
    for res in ranks:
        assert res["attention"]["divisible"] == (
            "ulysses needs heads (4) divisible by axis size (8); use "
            "ring_attention for head counts below the mesh size")


# ------------------------------------------------------------- the LM


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _lm_params())


def test_sp_lm_forward_matches_jax_and_dense(world4):
    _, ranks = world4
    tokens = _tokens()
    want = np.asarray(_jrun(
        lambda p, t: jplm.lm_apply(p, t, sp="sp"), {"sp": 4},
        (jplm.lm_param_specs(LAYERS, None), P(None, "sp")),
        P(None, "sp", None), _jparams(), jnp.asarray(tokens)))
    with torch.no_grad():
        dense = tplm.lm_apply(tplm.params_from_numpy(
            _lm_params(), device="cpu"), torch.tensor(
                tokens, dtype=torch.long)).numpy()
    np.testing.assert_allclose(dense, want, **LM_TOL)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["sp_forward"], _seq(want, 4, r),
                                   **LM_TOL)


def _jax_dst(fused):
    """The JAX ``dp=2,sp=2,tp=2`` forward, and the loss (dp-mean) and
    reduced gradients of one step, assembled to dense shapes."""
    specs = jplm.lm_param_specs(LAYERS, "tp", vocab_parallel=fused)
    axes = {"dp": 2, "sp": 2, "tp": 2}
    batch = P("dp", "sp")

    def region(p, t):
        def loss_fn(p):
            if fused:
                h = jplm.lm_apply(p, t, sp="sp", tp="tp", return_hidden=True)
                return jplm.next_token_nll_fused(
                    p, h, t, sp="sp", tp="tp", vocab_parallel=True,
                    t_chunk=T_CHUNK)
            return jplm.next_token_nll(jplm.lm_apply(p, t, sp="sp", tp="tp"),
                                       t, sp="sp")
        loss, g = jax.value_and_grad(loss_fn)(p)
        return lax.pmean(loss, "dp"), jplm.reduce_grads(g, dp="dp", sp="sp")

    tokens = jnp.asarray(_tokens())
    loss, g = _jrun(region, axes, (specs, batch), (P(), specs), _jparams(),
                    tokens, check_vma=not fused)
    logits = None
    if not fused:
        logits = np.asarray(_jrun(
            lambda p, t: jplm.lm_apply(p, t, sp="sp", tp="tp"), axes,
            (specs, batch), P("dp", "sp", None), _jparams(), tokens))
    return logits, float(loss), jax.tree_util.tree_map(np.asarray, g)


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_dp_sp_tp_lm_step_matches_jax(world8, fused):
    """``dp=2,sp=2,tp=2``: each rank holds its data shard's sequence
    half and its tensor shard; ``reduce_grads(dp=, sp=)`` sums over the
    sequence group and averages over the data group."""
    _, ranks = world8
    logits, jloss, jgrads = _jax_dst(fused)
    specs = tplm.lm_param_specs(LAYERS, "tp", vocab_parallel=fused)
    losses = {}
    for r, res in enumerate(ranks):
        dp_i, sp_i, tp_i = res["dst_index"]
        if not fused:
            want = _seq(logits[2 * dp_i:2 * dp_i + 2], 2, sp_i)
            np.testing.assert_allclose(res["dst_forward"], want, **LM_TOL)
        loss, grads = res["dst_fused" if fused else "dst_step"]
        losses.setdefault(dp_i, set()).add(loss)
        want = tplm.shard_lm_params(jgrads, specs, 2, tp_i)
        for got, w in zip(_leaves(grads), _leaves(want)):
            np.testing.assert_allclose(got, w.numpy(), **STEP_TOL)
    # One loss for each data shard, the same on its four ranks.
    assert all(len(v) == 1 for v in losses.values())
    np.testing.assert_allclose(
        (losses[0].pop() + losses[1].pop()) / 2, jloss, rtol=2e-4)


def _jax_adam_losses():
    """Plain dp-averaged Adam(1e-2) over ``dp=2,sp=4``, five steps: the
    JAX trajectory of tests/test_parallel_lm.py's ZeRO case."""
    opt = optax.adam(1e-2)
    params = _jparams()
    specs = jplm.lm_param_specs(LAYERS, None)

    def step(p, s, t):
        def loss_fn(p):
            return jplm.next_token_nll(jplm.lm_apply(p, t, sp="sp"), t,
                                       sp="sp")
        loss, g = jax.value_and_grad(loss_fn)(p)
        g = jplm.reduce_grads(g, dp="dp", sp="sp")
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, lax.pmean(loss, "dp")

    mesh = jpar.make_mesh({"dp": 2, "sp": 4})
    fn = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(specs, P(), P("dp", "sp")),
                               out_specs=(specs, P(), P())))
    state, losses = opt.init(params), []
    tokens = jnp.asarray(_tokens())
    for _ in range(ZERO_STEPS):
        params, state, loss = fn(params, state, tokens)
        losses.append(float(loss))
    return losses


def test_zero_over_dp_composes_with_sp(world8):
    """ZeRO-1 with ``axis_name="dp"`` inside a ``dp=2,sp=4`` mesh: the
    state shards over the data axis's 2 ranks, and the losses follow
    plain dp-averaged Adam and the JAX trajectory."""
    _, ranks = world8
    jlosses = _jax_adam_losses()
    for res in ranks:
        zl, info = res["zero"]
        pl, _ = res["plain"]
        np.testing.assert_allclose(zl, pl, rtol=5e-4)
        np.testing.assert_allclose(zl, jlosses, rtol=5e-4)
        (padded, local), = info.values()
        assert local * 2 == padded
    assert jlosses[-1] < jlosses[0]


# ------------------------------------------------------ TransformerLM


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_transformer_lm_sp_attn_fn_matches_flax(world4, attn):
    """The bench lane's model on a sequence axis: ``attn_fn`` a ring or
    a Ulysses (flash) attention and ``pos_offset = rank * L_local``,
    against the flax model under ``shard_map`` on the same weights."""
    _, ranks = world4
    params = _flax_params()
    t = _tlm_tokens()
    lt = t.shape[1] // 4
    fn = (functools.partial(jpar.ring_attention, axis="sp", causal=True)
          if attn == "ring" else
          functools.partial(jpar.ulysses_attention, axis="sp", causal=True))
    model = JLM(**TCFG, dtype=jnp.float32, attn_fn=fn)
    want = np.asarray(_jrun(
        lambda p, toks: model.apply({"params": p}, toks, train=False,
                                    pos_offset=lax.axis_index("sp") * lt),
        {"sp": 4}, (P(), P(None, "sp")), P(None, "sp"),
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(t),
        check_vma=False))
    dense = np.asarray(JLM(**TCFG, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(t), train=False))
    np.testing.assert_allclose(want, dense, **ATTN_TOL)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[("tlm", attn)], _seq(want, 4, r),
                                   **ATTN_TOL)


def test_zero_axis_name_resolves_on_the_bound_mesh():
    """``axis_name`` names a data axis of the bound mesh (its default
    the mesh's data axis); with no mesh bound only the world's flat axis
    resolves, as the JAX function's unbound fallback does."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError
    from horovod_tpu_torch.distributed.zero import (
        shard_info, sharded_distributed_optimizer)
    from horovod_tpu_torch.parallel import LogicalMesh, bind

    basics.init(device="cpu")
    try:
        p = torch.nn.Parameter(torch.arange(3.0))
        q = torch.nn.Parameter(torch.arange(3.0))
        with pytest.raises(InvalidArgumentError, match="bound LogicalMesh"):
            sharded_distributed_optimizer(torch.optim.Adam([p]),
                                          axis_name="dp")
        with bind(LogicalMesh.from_config("dp=1")):
            with pytest.raises(InvalidArgumentError, match="no axis 'sp'"):
                sharded_distributed_optimizer(torch.optim.Adam([p]),
                                              axis_name="sp")
            opt = sharded_distributed_optimizer(torch.optim.Adam([p],
                                                                 lr=0.1))
        assert shard_info(opt) == {"float32": (3, 3)}
        plain = torch.optim.Adam([q], lr=0.1)
        for o, t in ((opt, p), (plain, q)):
            t.grad = torch.tensor([1.0, -2.0, 0.5])
            o.step()
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-6)
    finally:
        basics.shutdown()
