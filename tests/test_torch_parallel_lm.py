"""Parity of the port's dense LM with ``horovod_tpu.models.parallel_lm``.

JAX weights (``init_lm_params``) are carried across with
``params_from_numpy``; token inputs come from a numpy seed. Both
packages run on the CPU in float32. Logits and caches must agree to
``rtol=atol=1e-5`` (the two frameworks sum matrix products in different
orders), greedy tokens exactly. The reference attention with its offset
masks is held to the JAX function on its own, at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.ops import attention as jatt
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.ops import attention as tatt

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 4, 4, 32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_lm_params(jax.random.PRNGKey(0), V, LMAX, LAYERS, H,
                              DH, FFN)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tlm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_params_structure_and_layouts_match(jparams, tparams):
    """Same tree, same shapes, same dtypes — in the carried-over dict
    and in the port's own init_lm_params."""
    own = tlm.init_lm_params(0, V, LMAX, LAYERS, H, DH, FFN, device="cpu")
    jl, jdef = jax.tree_util.tree_flatten(jparams)
    for tree in (tparams, own):
        tl, tdef = jax.tree_util.tree_flatten(tree)
        assert tdef == jdef
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == tuple(b.shape)
            assert a.dtype == torch.float32
    np.testing.assert_array_equal(_np(tparams["head"]),
                                  np.asarray(jparams["head"]))


def test_init_is_seeded_and_normalised():
    a = tlm.init_lm_params(7, V, LMAX, LAYERS, H, DH, FFN, device="cpu")
    b = tlm.init_lm_params(7, V, LMAX, LAYERS, H, DH, FFN, device="cpu")
    c = tlm.init_lm_params(8, V, LMAX, LAYERS, H, DH, FFN, device="cpu")
    assert torch.equal(a["layers"][1]["wup"], b["layers"][1]["wup"])
    assert not torch.equal(a["layers"][1]["wup"], c["layers"][1]["wup"])
    std = float(a["embed"].std()) * np.sqrt(H * DH)
    assert 0.8 < std < 1.2
    assert torch.all(a["layers"][0]["ln1"]["g"] == 1)


@pytest.mark.parametrize("causal,q_off,k_off,lq,lk", [
    (False, 0, 0, 5, 7),
    (True, 0, 0, 6, 6),
    (True, 5, 0, 3, 9),      # chunked prefill: queries at 5..7
    (True, 8, 4, 2, 6),      # block-parallel offsets
])
def test_dot_product_attention_matches_jax(causal, q_off, k_off, lq, lk):
    rng = np.random.default_rng(lq * 10 + lk)
    q = rng.normal(size=(2, lq, H, DH)).astype(np.float32)
    k = rng.normal(size=(2, lk, H, DH)).astype(np.float32)
    v = rng.normal(size=(2, lk, H, DH)).astype(np.float32)
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      q_offset=q_off, k_offset=k_off)
    got = tatt.dot_product_attention(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), causal=causal,
                                     q_offset=q_off, k_offset=k_off)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_per_row_q_offset_equals_scalar_calls():
    """The tensor q_offset (one offset per batch row, the engine's gather
    path) equals one scalar-offset call per row, bit for bit."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.normal(size=(3, 1, H, DH)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(3, 8, H, DH)).astype(np.float32))
    v = torch.tensor(rng.normal(size=(3, 8, H, DH)).astype(np.float32))
    offs = torch.tensor([0, 4, 7])
    got = tatt.dot_product_attention(q, k, v, causal=True, q_offset=offs)
    for i in range(3):
        one = tatt.dot_product_attention(q[i:i + 1], k[i:i + 1],
                                         v[i:i + 1], causal=True,
                                         q_offset=int(offs[i]))
        torch.testing.assert_close(got[i:i + 1], one, rtol=0, atol=0)


def test_lm_apply_matches_jax(jparams, tparams):
    toks = _tokens(0, (2, 13))
    want = jlm.lm_apply(jparams, jnp.asarray(toks))
    got = tlm.lm_apply(tparams, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    hid = tlm.lm_apply(tparams, torch.tensor(toks, dtype=torch.long),
                       return_hidden=True)
    np.testing.assert_allclose(
        _np(hid), np.asarray(jlm.lm_apply(jparams, jnp.asarray(toks),
                                          return_hidden=True)), **TOL)


@pytest.mark.parametrize("lp", [1, 9])
def test_lm_prefill_logits_and_caches_match_jax(jparams, tparams, lp):
    prompt = _tokens(lp, (2, lp))
    jc, jlog = jlm.lm_prefill(jparams, jnp.asarray(prompt))
    tc, tlog = tlm.lm_prefill(tparams, torch.tensor(prompt,
                                                    dtype=torch.long))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    assert len(tc) == LAYERS
    for a, b in zip(tc, jc):
        for kv in ("k", "v"):
            assert tuple(a[kv].shape) == (2, LMAX, H, DH)
            np.testing.assert_allclose(_np(a[kv]), np.asarray(b[kv]),
                                       **TOL)


def test_lm_decode_step_matches_jax(jparams, tparams):
    prompt = _tokens(3, (2, 7))
    jc, _ = jlm.lm_prefill(jparams, jnp.asarray(prompt))
    tc, _ = tlm.lm_prefill(tparams, torch.tensor(prompt, dtype=torch.long))
    tok = np.asarray([5, 60], np.int32)
    jc2, jlog = jlm.lm_decode_step(jparams, jc, jnp.asarray(tok), 7)
    before = [c["k"].clone() for c in tc]
    tc2, tlog = tlm.lm_decode_step(tparams, tc,
                                   torch.tensor(tok, dtype=torch.long), 7)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    for a, b in zip(tc2, jc2):
        np.testing.assert_allclose(_np(a["k"]), np.asarray(b["k"]), **TOL)
        np.testing.assert_allclose(_np(a["v"]), np.asarray(b["v"]), **TOL)
    for c, old in zip(tc, before):   # the input caches are untouched
        assert torch.equal(c["k"], old)


@pytest.mark.parametrize("seed,lp,steps", [(0, 5, 9), (1, 11, 6),
                                           (2, 1, 12)])
def test_lm_decode_greedy_tokens_equal_jax(jparams, tparams, seed, lp,
                                           steps):
    prompt = _tokens(100 + seed, (2, lp))
    want = np.asarray(jlm.lm_decode(jparams, jnp.asarray(prompt), steps))
    got = tlm.lm_decode(tparams, prompt, steps, device="cpu")
    assert got.dtype == torch.long and tuple(got.shape) == (2, steps)
    np.testing.assert_array_equal(_np(got), want)


def test_lm_decode_sampling_is_generator_deterministic(tparams):
    prompt = _tokens(9, (1, 4))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tlm.lm_decode(tparams, prompt, 8, temperature=1.0,
                             generator=g, device="cpu")

    assert torch.equal(draw(3), draw(3))
    with pytest.raises(ValueError, match="Generator"):
        tlm.lm_decode(tparams, prompt, 2, temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="position table"):
        tlm.lm_decode(tparams, prompt, LMAX, device="cpu")


def test_entry_points_default_to_the_card(tparams, monkeypatch):
    """device=None means CUDA; with no CUDA device it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm_params(0, V, LMAX, LAYERS, H, DH, FFN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.lm_decode(tparams, _tokens(0, (1, 3)), 2)
