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

The CUDA kernel splits each slot's key axis into chunks of ``R`` rows
(``paged_split_plan``) and merges the chunks' float32 partials in chunk
order. Its host plan is pinned here, and per-chunk partials computed on
the CPU from the plain softmax of each chunk, merged by
``merge_partials_reference`` (the merge kernel's plain version), must
equal ``paged_attention_decode_reference`` and the JAX kernel: float32
to ``atol=1e-6``, bfloat16 to ``BF16_TOL``.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import paged_attention as jpa
from horovod_tpu_torch.ops import paged_attention as tpa

H, D = 2, 8
ATOL = 1e-6
# bfloat16 against bfloat16: the kernel's own bf16 tolerance in
# chip_smoke.py (atol = rtol = 2e-2). Each side rounds its output to
# bf16 (one ulp is 2^-8 relative) and the softmax weights to bf16
# before P.V, against its own running maximum (the chunk's, the page
# step's or the row's), so one weight may round an ulp the other way.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


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


# ------------------------------------------ the split kernel's host plan


@pytest.mark.parametrize("pps, ps, want", [
    (24, 16, (64, 6)),       # the serving shapes: 384 rows
    (128, 16, (64, 32)),     # the long-context geometry
    (6, 16, (64, 2)),
    (1, 4, (64, 1)),         # a table narrower than a chunk
    (3, 5, (64, 1)),
    (7, 10, (64, 2)),        # 70 rows: a second chunk of 6
    (11, 3, (64, 1)),
])
def test_paged_split_plan(pps, ps, want):
    assert tpa.CHUNK_ROWS == 64
    assert tpa.paged_split_plan(pps, ps) == want


def test_paged_split_plan_rejects_empty_tables():
    for bad in ((0, 16), (4, 0)):
        with pytest.raises(ValueError, match="positive"):
            tpa.paged_split_plan(*bad)


def test_chunk_rows_are_the_kernel_source_s():
    """The host's plan and the kernel take R from two places: the entry
    point rejects a plan made for another R on the card; here, without
    one, the two constants are read and compared."""
    import re

    src = (Path(tpa.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    found = re.findall(r"constexpr int kChunkRows = (\d+);", src)
    assert found == [str(tpa.CHUNK_ROWS)]


@pytest.mark.parametrize("name", ["serving", "long"])
def test_timing_geometries(name):
    """The geometries that ``chip_smoke.py`` times K4 at: idle, one-row,
    page-edge and full-table slots; the byte count is the live K/V rows
    plus q, out, the live table entries and the lengths."""
    g = tpa.geometry(name)
    lens = g["lengths"]
    assert len(lens) == (8 if name == "serving" else 32)
    assert {0, 1, 16, 17} <= set(lens)
    assert max(lens) == g["pps"] * g["ps"]
    H, D, ps = g["H"], g["D"], g["ps"]
    nbytes, flops = tpa.decode_work(lens, H, D, ps, 4)
    pages = sum(-(-n // ps) for n in lens)
    assert nbytes == (sum(lens) * H * D * 2 * 4 + 2 * len(lens) * H * D * 4
                      + 4 * pages + 4 * len(lens))
    assert flops == 4 * H * D * sum(lens)


def test_timing_inputs_poison_only_dead_rows():
    """The serving geometry's inputs made on the CPU in float32: the null
    page is NaN and every stale row 1e30, yet the plain version, which
    reads only live rows, is finite and idle lanes are zero."""
    g = tpa.geometry("serving")
    lens = g["lengths"]
    q, kp, vp, tab, lengths = tpa.decode_inputs(
        dtype=torch.float32, seed=7, device="cpu", **g)
    assert torch.isnan(kp[0]).all() and torch.isnan(vp[0]).all()
    assert (kp == 1e30).any()
    assert tab.dtype == torch.int32 and lengths.tolist() == lens
    out = tpa.paged_attention_decode_reference(q, kp, vp, tab, lengths)
    assert torch.isfinite(out).all()
    assert (out[lengths == 0] == 0).all()


def _chunk_partials(q, kp, vp, tab, lens, R, splits, dtype, scale):
    """Each chunk's (m, l, acc) from the plain softmax over its own rows:
    m the largest log2-scaled score of its live rows, l the sum of
    2^(score - m), acc those weights (rounded to ``dtype``) times V. A
    chunk with no live row is filled with NaN: the merge must not read
    it."""
    q, kp, vp = (torch.tensor(a).to(dtype).float() for a in (q, kp, vp))
    S, Hq, Dq = q.shape
    ps = kp.shape[1]
    out = torch.full((S, Hq, splits, Dq + 2), float("nan"))
    sl2 = scale * np.log2(np.e)
    for s in range(S):
        for c in range(splits):
            rows = range(c * R, min(c * R + R, int(lens[s])))
            if not rows:
                continue
            idx = [(int(tab[s, r // ps]), r % ps) for r in rows]
            k = torch.stack([kp[p, i] for p, i in idx])      # [n, H, D]
            v = torch.stack([vp[p, i] for p, i in idx])
            t = torch.einsum("hd,nhd->hn", q[s], k) * sl2
            m = t.amax(dim=-1)
            w = torch.exp2(t - m[:, None])
            out[s, :, c, 0] = m
            out[s, :, c, 1] = w.sum(dim=-1)
            out[s, :, c, 2:] = torch.einsum(
                "hn,nhd->hd", w.to(dtype).float(), v)
    return out


SPLIT_CASES = {
    # R - 1, R, R + 1 and several chunks, a full table, idle lanes, one
    # row; page size 3 or 5 does not divide R, 4 does
    "ps3_r8": dict(R=8, ps=3, pps=11, lengths=[7, 8, 9, 26, 0, 1, 33]),
    "ps4_r8": dict(R=8, ps=4, pps=6, lengths=[7, 8, 9, 24, 17, 0]),
    "ps5_r16": dict(R=16, ps=5, pps=10, lengths=[15, 16, 17, 50, 0, 33]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_merged_chunk_partials_equal_the_plain_version_and_jax(name, dtype):
    kw = SPLIT_CASES[name]
    R, ps, pps, lengths = kw["R"], kw["ps"], kw["pps"], kw["lengths"]
    q, kp, vp, tab, lens = _case(lengths, ps, pps, seed=4, shuffle=True)
    for s, n in enumerate(lengths):          # 1e30 in the stale rows
        if n % ps:
            kp[tab[s, n // ps], n % ps:] = 1e30
            vp[tab[s, n // ps], n % ps:] = 1e30
    splits = -(-ps * pps // R)
    tdt = getattr(torch, dtype)
    scale = 1.0 / np.sqrt(D)
    part = _chunk_partials(q, kp, vp, tab, lens, R, splits, tdt, scale)
    assert torch.isnan(part).any(), "no chunk without a live row"
    got = tpa.merge_partials_reference(part, torch.tensor(lens), R,
                                       dtype=tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    assert np.isfinite(got).all(), "a dead chunk or the null page leaked"
    assert np.all(got[np.asarray(lengths) == 0] == 0.0)
    args = [torch.tensor(a) for a in (q, kp, vp, tab, lens)]
    args[:3] = [a.to(tdt) for a in args[:3]]
    plain = tpa.paged_attention_decode_reference(*args).float().numpy()
    jdt = getattr(jnp, dtype)
    want = np.asarray(jpa.paged_attention_decode(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(tab), jnp.asarray(lens)).astype(jnp.float32))
    tol = dict(rtol=0, atol=ATOL) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, plain, **tol)
    np.testing.assert_allclose(got, want, **tol)
