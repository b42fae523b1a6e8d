"""Parity of the port's flash attention (K1-K3) with the JAX kernels.

The same inputs, made from a numpy seed, go through
``horovod_tpu.ops.attention`` (the Pallas kernels, in interpret mode off
the TPU, as tests/test_parallel.py runs them) and through
``horovod_tpu_torch.ops.attention`` on CPU tensors, which runs the plain
PyTorch versions of the kernels. Float32 throughout. The forward (``out``
and the per-row ``lse``) must agree to 1e-5: both take one float32
softmax over the same scores and differ in summation order only. The
gradients (``jax.vjp`` against torch autograd) to ``rtol 5e-4, atol
5e-5``, the tolerance of tests/test_models.py's flash-vs-dense pin: the
backward recomputes ``exp(S - lse)`` and subtracts ``D = rowsum(dO*O)``,
which amplifies the last-digit differences of the forward. The port's
``"kernel"`` backward is held against the JAX ``"pallas"`` backward and
its ``"scan"`` port against the JAX scan. The host math
(``flash_grid_info``, ``_causal_step_tables``) and the errors must equal
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as ja
from horovod_tpu_torch.ops import attention as ta

FWD_ATOL = 1e-5
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)

# name -> (B, Lq, Lk, H, D, causal, q_offset, k_offset, block_q, block_k)
CASES = {
    "square": (2, 32, 32, 2, 8, False, 0, 0, 16, 16),
    "square_causal": (2, 32, 32, 2, 8, True, 0, 0, 16, 16),
    "rectangular": (1, 16, 32, 2, 8, False, 0, 0, 8, 16),
    "rectangular_offset_causal": (1, 16, 32, 2, 8, True, 16, 0, 8, 16),
    "offset_causal": (1, 32, 32, 1, 16, True, 8, 0, 16, 8),
    "block_q_not_multiple_of_block_k": (1, 48, 48, 1, 8, True, 0, 0, 16,
                                        24),
}


def _inputs(B, Lq, Lk, H, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Lk, H, D), dtype=np.float32)
    v = rng.standard_normal((B, Lk, H, D), dtype=np.float32)
    do = rng.standard_normal((B, Lq, H, D), dtype=np.float32)
    return q, k, v, do


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_lse_match_jax(name):
    B, Lq, Lk, H, D, causal, qo, ko, bq, bk = CASES[name]
    q, k, v, _ = _inputs(B, Lq, Lk, H, D)
    scale = 1.0 / np.sqrt(D)
    want_out, want_lse = ja._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, bq,
        bk, True, qo, ko, None)
    got_out, got_lse = ta.flash_forward(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal, scale,
        qo, ko)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=FWD_ATOL)
    public = ta.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        block_q=bq, block_k=bk, q_offset=qo, k_offset=ko)
    np.testing.assert_array_equal(public.detach().numpy(), got_out.numpy())


@pytest.mark.parametrize("impl", ["kernel", "scan"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name, impl):
    B, Lq, Lk, H, D, causal, qo, ko, bq, bk = CASES[name]
    q, k, v, do = _inputs(B, Lq, Lk, H, D, seed=1)
    jimpl = "pallas" if impl == "kernel" else "scan"

    def jfn(q, k, v):
        return ja.flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk, bwd_impl=jimpl, q_offset=qo,
                                  k_offset=ko)

    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ta.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                             block_k=bk, bwd_impl=impl, q_offset=qo,
                             k_offset=ko)
    out.backward(torch.tensor(do))
    for name_, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   err_msg=f"d{name_}", **GRAD_TOL)


# The geometries that cross the bf16 K2/K3 tiles on the card (chip_smoke
# sweep: a ragged 128-row key tile, five 64-row tiles, an offset causal
# mask over long keys, a rectangular non-causal shape), as
# name -> (Lq, Lk, causal, q_offset, k_offset, block_q, block_k). The
# JAX kernels need blocks that divide the lengths: 136 = 17 x 8 and
# 264 = 3 x 88.
BWD_GEOMS = {
    "ragged_key_tile_causal": (136, 136, True, 0, 0, 8, 8),
    "five_tiles_causal": (320, 320, True, 0, 0, 64, 64),
    "offset_causal_long_keys": (64, 264, True, 200, 0, 64, 88),
    "rectangular": (192, 320, False, 0, 0, 64, 64),
}
# bfloat16: both round dS, P^T and dS^T to bf16 at the same points and
# their outputs to bf16 (one ulp is 2^-8 relative); a last-bit
# difference in a float32 sum may move one rounding by an ulp.
BWD_TOL = {"float32": GRAD_TOL, "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BWD_GEOMS))
def test_backward_plain_versions_match_jax_kernels(name, dtype):
    """The plain K2/K3 (``flash_bwd_dq_reference``,
    ``flash_bwd_dkv_reference``) against the JAX dQ and dK/dV kernels in
    interpret mode, on the forward's lse and O, in the working type."""
    Lq, Lk, causal, qo, ko, bq, bk = BWD_GEOMS[name]
    q, k, v, do = _inputs(1, Lq, Lk, 2, 8, seed=7)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(getattr(jnp, dtype))
                       for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(8)
    o, lse = ja._flash_forward(jq, jk, jv, causal, scale, bq, bk, True, qo,
                               ko, None)
    want = ja._flash_bwd_pallas(causal, scale, bq, bk, True, qo, ko, None,
                                (jq, jk, jv, o, lse), jdo)

    def to_torch(a):
        return torch.tensor(np.asarray(a.astype(jnp.float32))).to(
            getattr(torch, dtype))

    tq, tk, tv, tdo, to = (to_torch(a) for a in (jq, jk, jv, jdo, o))
    tlse = torch.tensor(np.asarray(lse))
    d = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    dq = ta.flash_bwd_dq_reference(tq, tk, tv, tdo, tlse, d, causal, scale,
                                   qo, ko)
    dk, dv = ta.flash_bwd_dkv_reference(tq, tk, tv, tdo, tlse, d, causal,
                                        scale, qo, ko)
    for name_, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   to_torch(w).float().numpy(),
                                   err_msg=name_, **BWD_TOL[dtype])


def test_plain_versions_match_dense_autograd_in_bfloat16():
    """The plain K1-K3 at bfloat16 inputs against dense attention's
    float32 autograd: the kernels' bf16 rounding points (p, dS, P^T,
    dS^T) keep them within bf16 resolution (2e-2)."""
    q, k, v, do = _inputs(2, 32, 32, 2, 16, seed=4)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v, do)]
    leaves = [t.float().requires_grad_() for t in bf[:3]]
    ta.dot_product_attention(*leaves, causal=True).backward(bf[3].float())
    qb, kb, vb = (t.clone().requires_grad_() for t in bf[:3])
    out = ta.flash_attention(qb, kb, vb, causal=True)
    out.backward(bf[3])
    assert out.dtype == torch.bfloat16 and qb.grad.dtype == torch.bfloat16
    for got, ref in zip((qb.grad, kb.grad, vb.grad), leaves):
        np.testing.assert_allclose(got.float().numpy(),
                                   ref.grad.numpy(), atol=2e-2, rtol=2e-2)


def test_kernel_and_scan_backward_agree_on_strided_views():
    """q/k/v as the model hands them over (views into one [B, L, 3E]
    projection) take both backwards to the same gradients."""
    rng = np.random.default_rng(5)
    B, L, H, D = 2, 32, 2, 8
    qkv = torch.tensor(rng.standard_normal((B, L, 3 * H * D),
                                           dtype=np.float32))
    do = torch.tensor(rng.standard_normal((B, L, H, D), dtype=np.float32))
    grads = {}
    for impl in ("kernel", "scan"):
        x = qkv.clone().requires_grad_()
        q, k, v = (t.reshape(B, L, H, D) for t in x.split(H * D, dim=-1))
        assert q.stride(1) == 3 * H * D
        ta.flash_attention(q, k, v, causal=True, bwd_impl=impl).backward(do)
        grads[impl] = x.grad
    np.testing.assert_allclose(grads["kernel"].numpy(),
                               grads["scan"].numpy(), rtol=1e-5, atol=1e-6)


GRID_CASES = [
    dict(seq_q=2048, seq_k=2048, causal=True, head_dim=64,
         batch_heads=96),
    dict(seq_q=2048, seq_k=2048, causal=True, truncate=False,
         head_dim=64, batch_heads=96),
    dict(seq_q=64, seq_k=128, causal=True, q_offset=64),
    dict(seq_q=48, seq_k=48, causal=True, block_q=16, block_k=24),
    dict(seq_q=8192, seq_k=8192, causal=False, head_dim=128,
         dtype_bytes=4),
]


@pytest.mark.parametrize("kw", GRID_CASES, ids=range(len(GRID_CASES)))
def test_flash_grid_info_equals_jax(kw):
    assert ta.flash_grid_info(**kw) == ja.flash_grid_info(**kw)


@pytest.mark.parametrize("args", [(4, 4, 16, 16, False), (4, 4, 16, 16,
                                                          True),
                                  (3, 2, 16, 24, False), (3, 2, 16, 24,
                                                          True),
                                  (8, 4, 256, 512, True)])
def test_causal_step_tables_equal_jax(args):
    want = ja._causal_step_tables(*args)
    got = ta._causal_step_tables(*args)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _both_raise(fn_kwargs, shapes=(1, 32, 32, 1, 8)):
    B, Lq, Lk, H, D = shapes
    q, k, v, _ = _inputs(B, Lq, Lk, H, D)
    with pytest.raises(ValueError) as want:
        ja.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **fn_kwargs)
    with pytest.raises(ValueError) as got:
        ta.flash_attention(torch.tensor(q), torch.tensor(k),
                           torch.tensor(v), **fn_kwargs)
    return str(want.value), str(got.value)


@pytest.mark.parametrize("kw,shapes", [
    (dict(causal=True, q_offset=0, k_offset=4), (1, 32, 32, 1, 8)),
    (dict(causal=True, truncate=True, q_offset=8), (1, 32, 32, 1, 8)),
    (dict(causal=False, truncate=True), (1, 32, 32, 1, 8)),
    (dict(causal=True), (1, 100, 100, 1, 8)),
], ids=["offset_before_keys", "truncate_offset", "truncate_noncausal",
        "pad_upstream"])
def test_errors_equal_jax(kw, shapes):
    want, got = _both_raise(kw, shapes)
    assert got == want


def test_bwd_impl_values():
    want, got = _both_raise(dict(bwd_impl="bogus"))
    assert "auto|scan|" in want and got == (
        "bwd_impl must be auto|scan|kernel, got 'bogus'")
    assert ta.resolve_bwd_impl(None, 2048) == "kernel"
    assert ta.resolve_bwd_impl("auto", 16384) == "kernel"
    assert ta.resolve_bwd_impl("scan", 64) == "scan"


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    q, k, v, do = (torch.tensor(a) for a in _inputs(1, 16, 16, 2, 8))
    before = (ta.flash_forward.launches, ta.flash_bwd_dq.launches,
              ta.flash_bwd_dkv.launches)
    out, lse = ta.flash_forward(q, k, v, True)
    ref_out, ref_lse = ta.flash_forward_reference(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    d = (do * out).sum(-1).transpose(1, 2).contiguous()
    assert torch.equal(ta.flash_bwd_dq(q, k, v, do, lse, d, True),
                       ta.flash_bwd_dq_reference(q, k, v, do, lse, d, True))
    for a, b in zip(ta.flash_bwd_dkv(q, k, v, do, lse, d, True),
                    ta.flash_bwd_dkv_reference(q, k, v, do, lse, d, True)):
        assert torch.equal(a, b)
    assert (ta.flash_forward.launches, ta.flash_bwd_dq.launches,
            ta.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("wrapper", ["flash_forward", "flash_bwd_dq",
                                     "flash_bwd_dkv"])
def test_non_cpu_input_never_takes_the_plain_version(monkeypatch, wrapper):
    """Only a CPU tensor takes a plain version: any other device launches
    the kernel or raises (here the ``meta`` device, which has no kernel),
    and the plain version is never called for it."""
    calls = []
    for ref in ("flash_forward_reference", "flash_bwd_dq_reference",
                "flash_bwd_dkv_reference"):
        monkeypatch.setattr(ta, ref, lambda *a, **k: calls.append(1))
    q, k, v, do = (torch.tensor(a).to("meta")
                   for a in _inputs(1, 16, 16, 2, 8))
    stats = torch.zeros((1, 2, 16), device="meta")
    args = (q, k, v) if wrapper == "flash_forward" else (q, k, v, do, stats,
                                                         stats)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(ta, wrapper)(*args)
    assert not calls
