"""Parity of the port's paged-attention decode with the JAX kernel.

The same inputs, made from a numpy seed, go through
``horovod_tpu.ops.paged_attention.paged_attention_decode`` (the Pallas
kernel, in interpret mode off the TPU) and through the port's
``horovod_tpu_torch.ops.paged_attention.paged_attention_decode`` on CPU
tensors, which runs its plain PyTorch version. The matrix is the one of
tests/test_paged_attention.py: ragged lengths, the page boundary, single
pages, idle lanes, physically shuffled pages, a NaN-poisoned null page
0, 1e30-poisoned stale rows, shape errors. Float32, ``atol=1e-6``: both
sides take one float32 softmax over the same scores and differ only in
summation order. ``paged_grid_info`` must return the equal dict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import paged_attention as jpa
from horovod_tpu_torch.ops import paged_attention as tpa

H, D = 2, 8
ATOL = 1e-6


def _case(lengths, ps, pps, seed=0, shuffle=False):
    """Pages + tables for the given per-slot live-key counts; the null
    page 0 is NaN-poisoned, live slots map distinct real pages."""
    rng = np.random.default_rng(seed)
    S = len(lengths)
    need = [-(-int(x) // ps) for x in lengths]
    P = 1 + sum(need) + 2
    k_pages = rng.normal(size=(P, ps, H, D)).astype(np.float32)
    v_pages = rng.normal(size=(P, ps, H, D)).astype(np.float32)
    k_pages[0] = np.nan
    v_pages[0] = np.nan
    ids = list(range(1, P))
    if shuffle:
        rng.shuffle(ids)
    tables = np.zeros((S, pps), np.int32)
    nxt = 0
    for s, n in enumerate(need):
        for j in range(n):
            tables[s, j] = ids[nxt]
            nxt += 1
    q = rng.normal(size=(S, H, D)).astype(np.float32)
    return q, k_pages, v_pages, tables, np.asarray(lengths, np.int32)


def _jax(q, kp, vp, tab, lens):
    return np.asarray(jpa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tab), jnp.asarray(lens)))


def _torch(q, kp, vp, tab, lens, fn=tpa.paged_attention_decode):
    return fn(*(torch.tensor(a) for a in (q, kp, vp, tab, lens))).numpy()


def _check(case):
    want = _jax(*case)
    got = _torch(*case)
    assert np.isfinite(got).all(), "null-page NaN leaked into a sum"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    return got


MATRIX = {
    # mid-page, full page, page+1, single row, idle lane
    "ragged_lengths": dict(lengths=[7, 8, 9, 1, 0, 3], ps=4, pps=4),
    "page_boundary": dict(lengths=[4, 8, 12], ps=4, pps=3),
    "single_page": dict(lengths=[1, 2, 4], ps=4, pps=1),
    # Lmax >> t: the unmapped (NaN) table tail is never read
    "table_tail_untouched": dict(lengths=[3, 5], ps=4, pps=16),
    "shuffled_pages": dict(lengths=[7, 9, 2], ps=4, pps=4, shuffle=True),
    "idle_lanes": dict(lengths=[5, 0, 0], ps=4, pps=2),
    "odd_page_size": dict(lengths=[1, 5, 10, 15], ps=5, pps=3, seed=3),
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_plain_version_matches_jax_kernel(name):
    kw = dict(MATRIX[name])
    lengths, ps, pps = kw.pop("lengths"), kw.pop("ps"), kw.pop("pps")
    out = _check(_case(lengths, ps, pps, **kw))
    idle = np.asarray(lengths) == 0
    assert np.all(out[idle] == 0.0), "idle lanes must give zero rows"


def test_stale_rows_past_t_are_masked():
    """Rows of the last live page beyond t hold stale finite values after
    page reuse; poisoned with 1e30 they must get exactly zero weight, in
    both packages, and the answer must not move."""
    q, kp, vp, tab, lens = _case([6], ps=4, pps=2)
    clean = _torch(q, kp, vp, tab, lens)
    kp[tab[0, 1], 2:] = 1e30
    vp[tab[0, 1], 2:] = 1e30
    got = _check((q, kp, vp, tab, lens))
    np.testing.assert_array_equal(got, clean)


def test_reference_function_is_the_cpu_path():
    """The wrapper on CPU tensors is the plain version, bit for bit, and
    launches nothing."""
    case = _case([7, 0, 3], ps=4, pps=2, seed=5)
    before = tpa.paged_attention_decode.launches
    a = _torch(*case)
    b = _torch(*case, fn=tpa.paged_attention_decode_reference)
    np.testing.assert_array_equal(a, b)
    assert tpa.paged_attention_decode.launches == before


def test_explicit_scale_matches_jax():
    q, kp, vp, tab, lens = _case([7, 3], ps=4, pps=2, seed=9)
    want = np.asarray(jpa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tab), jnp.asarray(lens), scale=0.3))
    got = tpa.paged_attention_decode(
        *(torch.tensor(a) for a in (q, kp, vp, tab, lens)),
        scale=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("what", ["head_dim", "slots"])
def test_shape_errors_match_jax(what):
    q, kp, vp, tab, lens = _case([4], ps=4, pps=2)
    if what == "head_dim":
        args, match = (q, kp[:, :, :, :4], vp, tab, lens), "shape mismatch"
    else:
        args, match = (q, kp, vp, tab, np.zeros(3, np.int32)), "slots"
    with pytest.raises(ValueError, match=match):
        jpa.paged_attention_decode(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match=match):
        tpa.paged_attention_decode(*(torch.tensor(a) for a in args))


GRID_CASES = [
    dict(lengths=[7, 8, 9, 1, 0], page_size=4, pages_per_seq=4),
    dict(lengths=[4], page_size=4, pages_per_seq=8, dtype_bytes=4,
         num_layers=3),
    dict(lengths=[16, 0, 384, 17], page_size=16, pages_per_seq=24,
         dtype_bytes=2, num_layers=12, tp=2),
    dict(lengths=[], page_size=4, pages_per_seq=2),
]


@pytest.mark.parametrize("kw", GRID_CASES, ids=range(len(GRID_CASES)))
def test_paged_grid_info_equals_jax(kw):
    want = jpa.paged_grid_info(num_heads=4, head_dim=8, **kw)
    got = tpa.paged_grid_info(num_heads=4, head_dim=8, **kw)
    assert got == want


def test_paged_grid_info_tables_and_errors_equal_jax():
    _, _, _, tab, lens = _case([7, 4, 0], ps=4, pps=4)
    kw = dict(page_size=4, pages_per_seq=4, num_heads=H, head_dim=D)
    got = tpa.paged_grid_info(lens, tables=tab, **kw)
    assert got == jpa.paged_grid_info(lens, tables=tab, **kw)
    assert all(0 not in v for v in got["pages_visited"])
    for bad in ([17], [-1]):
        with pytest.raises(ValueError) as want_err:
            jpa.paged_grid_info(bad, **kw)
        with pytest.raises(ValueError) as got_err:
            tpa.paged_grid_info(bad, **kw)
        assert str(got_err.value) == str(want_err.value)


def test_non_cpu_input_never_takes_the_plain_version(monkeypatch):
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel or raises (here the ``meta`` device, which has
    no kernel), and the plain version is never called for it."""
    calls = []
    monkeypatch.setattr(tpa, "paged_attention_decode_reference",
                        lambda *a, **k: calls.append(1))
    args = [torch.tensor(a).to("meta") for a in _case([3], ps=4, pps=1)]
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention_decode(*args)
    assert not calls
