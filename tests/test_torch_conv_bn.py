"""Parity of the port's fused 1x1-conv + BN-statistics op (K5) with the JAX
kernel.

The same inputs, made from numpy seeds, go through
``horovod_tpu.ops.conv_bn`` (the Pallas kernel in interpret mode, as
tests/test_conv_bn.py runs it on the CPU) and through
``horovod_tpu_torch.ops.conv_bn`` on CPU tensors, which runs the plain
PyTorch version of kernel K5. Tolerances, each with its reason:

* float32 ``y``: ``rtol 1e-5, atol 1e-5`` -- one float32 product per
  element, summed in another order;
* float32 ``s1``/``s2``: ``rtol 1e-5, atol 1e-4`` -- sums of a few hundred
  such elements, in another order (tests/test_conv_bn.py's bound);
* bfloat16 ``y``: ``rtol 1e-2, atol 1e-2`` -- both round a float32 sum to
  bfloat16, and a last-bit difference in the sum flips the rounding by
  one bfloat16 ulp (2^-8 relative);
* bfloat16 ``s1``/``s2``: ``rtol 1e-3, atol 1e-1`` -- float32 sums over
  the same rounded values but for those rare one-ulp flips, as
  tests/test_conv_bn.py pins the kernel against the unfused sums;
* float32 gradients through a BatchNorm-like consumer: ``rtol 1e-4`` and
  an absolute bound of ``1e-4`` times the gradient's largest entry. The
  consumer normalises ``y``, and BatchNorm's scale invariance makes each
  gradient a near-total cancellation of terms as large as its largest
  entries (tests/test_conv_bn.py:248 says the same of fused against
  unfused), so two frameworks' float32 rounding leaves about 1e-5 of that
  scale; a wrong cotangent formula is off by the whole scale. Float64
  gradients ``1e-9``, the exactness pin of tests/test_conv_bn.py:156
  repeated across the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from horovod_tpu.ops import conv_bn as jcb
from horovod_tpu_torch.ops import conv_bn as tcb

TOL = {
    "float32": (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=1e-4)),
    "bfloat16": (dict(rtol=1e-2, atol=1e-2), dict(rtol=1e-3, atol=1e-1)),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _assert_outputs(got, want, dname):
    y_tol, s_tol = TOL[dname]
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **y_tol)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(g), _np(w), **s_tol)


def _affine(seed, k, positive_shift=False):
    a, b = _arrays(seed, (k,), (k,))
    a = a * 0.5 + 1.0
    b = np.abs(b) + 0.5 if positive_shift else b * 0.1
    return a, b


# M = 256 has an aligned JAX block; M = 100 takes its zero-padding branch.
@pytest.mark.parametrize("m", [256, 100])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_matmul_bn_stats_matches_jax(m, dname):
    x, w = _arrays(1, (m, 96), (96, 40))
    want = jcb.matmul_bn_stats(jnp.asarray(x, JDT[dname]),
                               jnp.asarray(w, JDT[dname]), True)
    got = tcb.matmul_bn_stats(torch.tensor(x).to(TDT[dname]),
                              torch.tensor(w).to(TDT[dname]))
    assert tuple(got[0].shape) == (m, 40) and got[0].dtype == TDT[dname]
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    _assert_outputs(got, want, dname)


# positive_shift with M = 100: JAX pads M to its block, and a pad row would
# become relu(b) > 0 without the mask (tests/test_conv_bn.py:137).
@pytest.mark.parametrize("m,positive_shift", [(256, False), (100, True)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_matmul_prologue_bn_stats_matches_jax(m, positive_shift, dname):
    x, w = _arrays(2, (m, 32), (32, 24))
    a, b = _affine(3, 32, positive_shift)
    j = [jnp.asarray(v, JDT[dname]) for v in (x, w)]
    want = jcb.matmul_prologue_bn_stats(j[0], jnp.asarray(a),
                                        jnp.asarray(b), j[1], True)
    got = tcb.matmul_prologue_bn_stats(
        torch.tensor(x).to(TDT[dname]), torch.tensor(a), torch.tensor(b),
        torch.tensor(w).to(TDT[dname]))
    _assert_outputs(got, want, dname)


# Shapes off the bf16 kernel's tiles on the card (128-row M tiles, K in
# 64-deep slices, 64- or 128-column N tiles): M = 257, N = 300, K = 72
# and 136, with and without the prologue (positive shifts, so a row off
# the tile that escaped the mask would show in the statistics). The
# wrapper on CPU tensors runs the plain version.
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("k", [72, 136])
def test_plain_version_matches_jax_off_the_tiles(k, prologue):
    x, w = _arrays(8, (257, k), (k, 300))
    jx, jw = (jnp.asarray(v, jnp.bfloat16) for v in (x, w))
    tx, tw = (torch.tensor(v).to(torch.bfloat16) for v in (x, w))
    if prologue:
        a, b = _affine(9, k, positive_shift=True)
        want = jcb.matmul_prologue_bn_stats(jx, jnp.asarray(a),
                                            jnp.asarray(b), jw, True)
        got = tcb.bn_stats_forward(tx, tw, torch.tensor(a),
                                   torch.tensor(b))
    else:
        want = jcb.matmul_bn_stats(jx, jw, True)
        got = tcb.bn_stats_forward(tx, tw)
    assert tuple(got[0].shape) == (257, 300)
    assert got[0].dtype == torch.bfloat16
    _assert_outputs(got, want, "bfloat16")


def test_prologue_pad_rows_stay_out_of_the_statistics():
    """The statistics are those of the M real rows: with a positive shift
    every real row's h is relu(x + b) and a padded row would add relu(b)."""
    x, w = _arrays(4, (100, 32), (32, 16))
    a, b = np.ones(32, np.float32), _affine(5, 32, True)[1]
    _, s1, s2 = tcb.matmul_prologue_bn_stats(
        torch.tensor(x), torch.tensor(a), torch.tensor(b), torch.tensor(w))
    y = np.maximum(x + b, 0) @ w
    np.testing.assert_allclose(s1.numpy(), y.sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), (y * y).sum(0), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("hw", [8, 7])
def test_strided_conv1x1_matches_jax(prologue, hw):
    x, w = _arrays(6, (2, hw, hw, 24), (1, 1, 24, 40))
    a, b = _affine(7, 24)
    if prologue:
        want = jcb.conv1x1_prologue_bn_stats(
            jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
            (2, 2), interpret=True)
        got = tcb.conv1x1_prologue_bn_stats(
            torch.tensor(x), torch.tensor(a), torch.tensor(b),
            torch.tensor(w), (2, 2))
    else:
        want = jcb.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w), (2, 2),
                                    interpret=True)
        got = tcb.conv1x1_bn_stats(torch.tensor(x), torch.tensor(w), (2, 2))
    side = -(-hw // 2)
    assert tuple(got[0].shape) == (2, side, side, 40)
    _assert_outputs(got, want, "float32")
    # A strided 1x1 is the convolution itself (SAME pads nothing for it).
    conv = lax.conv_general_dilated(
        jnp.maximum(jnp.asarray(x) * a + b, 0) if prologue
        else jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(conv), rtol=1e-5,
                               atol=1e-5)


def _consume(y, s1, s2, lib):
    """A BatchNorm-like consumer of all three outputs (tests/test_conv_bn.py
    :86), so every cotangent path carries a gradient."""
    n = y.shape[0]
    mean = s1 / n
    var = s2 / n - mean * mean
    rs = lax.rsqrt(var + 1e-5) if lib is jnp else torch.rsqrt(var + 1e-5)
    sin = jnp.sin if lib is jnp else torch.sin
    return ((((y - mean) * rs) ** 2).sum() + 0.3 * sin(s1).sum()
            + 0.1 * (s2 ** 0.5).sum())


def _grads(prologue, dtype, seed=8):
    x, w = _arrays(seed, (64, 16), (16, 8))
    w = w * 0.1
    a, b = _affine(seed + 1, 16)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    args = (x, a, b, w) if prologue else (x, w)
    if prologue:
        jf = lambda x, a, b, w: _consume(   # noqa: E731
            *jcb.matmul_prologue_bn_stats(x, a, b, w, True), jnp)
    else:
        jf = lambda x, w: _consume(         # noqa: E731
            *jcb.matmul_bn_stats(x, w, True), jnp)
    want = jax.grad(jf, argnums=tuple(range(len(args))))(
        *[jnp.asarray(v, jdt) for v in args])
    ts = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in args]
    op = tcb.matmul_prologue_bn_stats if prologue else tcb.matmul_bn_stats
    _consume(*op(*ts), torch).backward()
    return [t.grad.numpy() for t in ts], [np.asarray(g) for g in want]


@pytest.mark.parametrize("prologue", [False, True])
def test_gradients_match_jax_custom_vjp_f32(prologue):
    got, want = _grads(prologue, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("prologue", [False, True])
def test_gradients_match_jax_custom_vjp_f64_exact(prologue):
    with jax.enable_x64():
        got, want = _grads(prologue, torch.float64)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


def test_strided_gradient_lands_on_the_subsampled_rows():
    """The backward of a strided 1x1 writes into x[:, ::2, ::2] only."""
    x, w = _arrays(9, (1, 4, 4, 3), (3, 5))
    xt = torch.tensor(x, requires_grad=True)
    y, s1, s2 = tcb.conv1x1_bn_stats(xt, torch.tensor(w), (2, 2))
    (y.sum() + s1.sum() + s2.sum()).backward()
    g = xt.grad.numpy()
    assert np.all(g[:, 1::2] == 0) and np.all(g[:, :, 1::2] == 0)
    assert np.all(g[:, ::2, ::2] != 0)


def test_wrapper_runs_the_plain_version_on_cpu_only():
    x, w = _arrays(10, (50, 12), (12, 6))
    a, b = _affine(11, 12)
    before = (tcb.bn_stats_forward.launches,
              tcb.bn_stats_forward.prologue_launches)
    got = tcb.bn_stats_forward(torch.tensor(x), torch.tensor(w),
                               torch.tensor(a), torch.tensor(b))
    want = tcb.matmul_prologue_bn_stats_reference(
        torch.tensor(x), torch.tensor(a), torch.tensor(b), torch.tensor(w))
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    # The counters count kernel launches: the CPU route launches none.
    assert (tcb.bn_stats_forward.launches,
            tcb.bn_stats_forward.prologue_launches) == before
    # Only a CPU tensor takes the plain version; anything else is the
    # kernel's or an error, never a fallback.
    with pytest.raises(ValueError, match="unsupported device"):
        tcb.bn_stats_forward(torch.empty(4, 3, device="meta"),
                             torch.empty(3, 2, device="meta"))
    with pytest.raises(ValueError, match=r"\[K=12, N\]"):
        tcb.bn_stats_forward(torch.tensor(x), torch.tensor(w).t())
    with pytest.raises(ValueError, match="both"):
        tcb.bn_stats_forward(torch.tensor(x), torch.tensor(w),
                             torch.tensor(a), None)


def test_model_without_a_card_raises(monkeypatch):
    from horovod_tpu_torch.models import resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.build("resnet18", num_filters=4, fused_bn=True)


# ResNet-50 at batch 64, 224^2: every 1x1 conv's (M, K, N). JAX's VMEM
# policy fuses all of them, so both packages take the fused route there.
RESNET50_1X1 = [
    (200704, 64, 64), (200704, 64, 256), (200704, 256, 64),
    (200704, 256, 128), (50176, 128, 512), (50176, 256, 512),
    (50176, 512, 128), (50176, 512, 256), (12544, 256, 1024),
    (12544, 512, 1024), (12544, 1024, 256), (12544, 1024, 512),
    (3136, 512, 2048), (3136, 1024, 2048), (3136, 2048, 512)]


def test_jax_fuses_every_resnet50_1x1_at_batch_64():
    for m, k, n in RESNET50_1X1:
        assert jcb.fits_fused(m, k, n), (m, k, n)
