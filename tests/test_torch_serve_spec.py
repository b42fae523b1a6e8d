"""The port's speculative decoding against the JAX package's.

Model level: ``draft_params`` is a view of the target's dict;
``lm_verify_window``'s logits equal the JAX function's to ``rtol=atol=
1e-5`` (the frameworks sum matrix products in different orders; the
same tolerance as tests/test_torch_parallel_lm.py), and at ``w=1`` equal
``lm_decode_step``'s bit for bit; ``lm_decode_spec`` at k in {1, 2, 4}
and draft depth in {1, n} equals the JAX ``lm_decode_spec`` and the
port's ``lm_decode`` token for token, and raises the reference's errors.

Sampling: the greedy ``speculative_accept`` equals the reference's on the
same logits; the device-side counter hash equals its host form bit for
bit; at temperature > 0 the draft's proposals follow the draft's
softmax and the emitted token follows the TARGET's softmax whatever the
draft proposed, within a total-variation bound of 0.05 over 4000 draws
on a vocabulary of 8 (the expected distance of 4000 exact draws is about
0.016).

Engine: the cases of tests/test_serve_engine.py's speculative classes, in
both attention modes: every greedy stream equals the plain engine's, the
JAX speculative engine's and ``lm_decode``'s (with the JAX engine's
``spec_stats`` for the same schedule), under the budget clamp, an EOS
mid-window, eviction-recompute and prefix COW; a full-depth draft accepts
every proposal; the draft depth resolves to half by default; sampled
streams are same-seed deterministic, evictions included; the lane's
masked rows write only the null page; a tick whose live slots are all
greedy runs the lane without the sampled draw, with the same results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeEngine as JServeEngine
from horovod_tpu.serve import sampling as jsampling
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import ServeConfig, ServeEngine
from horovod_tpu_torch.serve import sampling as tsampling
from horovod_tpu_torch.serve.engine import pack_spec, spec_lane

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


def _prompt(i, lp):
    return np.random.default_rng(1000 + i).integers(0, V, lp).astype(
        np.int32)


def _ref(params, prompt, steps):
    return tlm.lm_decode(params, np.asarray(prompt)[None], steps,
                         device="cpu")[0].tolist()


def _spec_cfg(k, attention="gather", **kw):
    base = dict(page_size=8, num_pages=40, decode_slots=2,
                prefill_chunk=4, speculate_k=k, draft_layers=1,
                attention=attention)
    base.update(kw)
    return base


# ------------------------------------------------------- model level


def test_draft_params_is_a_view(tparams):
    d = tlm.draft_params(tparams, 1)
    assert d["layers"] == tparams["layers"][:1]
    assert d["layers"][0] is tparams["layers"][0]
    for name in ("embed", "pos", "ln_f", "head"):
        assert d[name] is tparams[name]
    for bad in (0, LAYERS + 1):
        with pytest.raises(ValueError) as want:
            jlm.draft_params({"layers": [None] * LAYERS}, bad)
        with pytest.raises(ValueError) as got:
            tlm.draft_params(tparams, bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("w", [1, 3, 5])
def test_verify_window_matches_jax(jparams, tparams, w):
    prompt = _prompt(1, 7)
    toks = _prompt(2, w)[None]
    jc, _ = jlm.lm_prefill(jparams, jnp.asarray(prompt)[None])
    jnew, jlg = jlm.lm_verify_window(jparams, jc, jnp.asarray(toks), 7)
    with torch.no_grad():
        tc, _ = tlm.lm_prefill(tparams, torch.as_tensor(prompt).long()[None])
        tnew, tlg = tlm.lm_verify_window(
            tparams, tc, torch.as_tensor(toks).long(), 7)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    for jl, tl in zip(jnew, tnew):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tl[kv].numpy(), np.asarray(jl[kv]),
                                       **TOL)
    if w == 1:
        with torch.no_grad():
            dnew, dlg = tlm.lm_decode_step(
                tparams, tc, torch.as_tensor(toks[:, 0]).long(), 7)
        assert torch.equal(tlg[:, 0], dlg)
        for a, b in zip(tnew, dnew):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"],
                                                               b["v"])


@pytest.mark.parametrize("draft_layers", [1, LAYERS])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_decode_spec_equals_jax_and_lm_decode(jparams, tparams, k,
                                              draft_layers):
    prompt = _prompt(3, 9)
    got = tlm.lm_decode_spec(tparams, prompt[None], 14, k=k,
                             draft_layers=draft_layers,
                             device="cpu")[0].tolist()
    want = np.asarray(jlm.lm_decode_spec(
        jparams, jnp.asarray(prompt)[None], 14, k=k,
        draft_layers=draft_layers))[0].tolist()
    assert got == want == _ref(tparams, prompt, 14)


@pytest.mark.parametrize("case", ["rows", "k", "length"])
def test_decode_spec_raises_the_reference_errors(jparams, tparams, case):
    prompt, steps, k = _prompt(4, 6)[None], 4, 2
    if case == "rows":
        prompt = np.concatenate([prompt, prompt])
    elif case == "k":
        k = 0
    else:
        steps = LMAX
    with pytest.raises(ValueError) as want:
        jlm.lm_decode_spec(jparams, jnp.asarray(prompt), steps, k=k,
                           draft_layers=1)
    with pytest.raises(ValueError) as got:
        tlm.lm_decode_spec(tparams, prompt, steps, k=k, draft_layers=1,
                           device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ sampling


def _rows(w, vocab=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (w, vocab)).astype(np.float32)


@pytest.mark.parametrize("agree", [0, 1, 2, 3])
def test_greedy_accept_equals_reference(agree):
    """Drafts that agree with the target's argmaxes on the first
    ``agree`` rows, then diverge: the same emitted tokens as the JAX
    rule, from the logits or from the argmaxes alone."""
    tl = _rows(4, seed=agree)
    tgt = tl.argmax(-1)
    draft = np.asarray([tgt[i] if i < agree else (tgt[i] + 1) % 16
                        for i in range(3)], np.int32)
    dl = _rows(3, seed=10 + agree)
    want = jsampling.speculative_accept(tl, draft, dl, temperature=0.0,
                                        top_k=0, seed=0, position0=5)
    got = tsampling.speculative_accept(
        torch.as_tensor(tl), draft, torch.as_tensor(dl), temperature=0.0,
        top_k=0, seed=0, position0=5)
    assert got == want == tgt[:min(agree + 1, 4)].tolist()
    assert tsampling.speculative_accept(
        None, draft, None, temperature=0.0, top_k=0, seed=0, position0=5,
        target_tokens=tgt) == want


def test_device_hash_equals_host_hash():
    """The int64 tensor form of the splitmix64 key (wrapping arithmetic,
    logical shifts by masking) gives the host form's bits, for every
    fold; fold 0 is the plain sampler's seed."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 40, 64)
    pos = rng.integers(0, 2 ** 33, 64)
    for fold in (0, tsampling.DRAFT_FOLD, tsampling.ACCEPT_FOLD,
                 tsampling.RESIDUAL_FOLD):
        got = tsampling._key_t(torch.as_tensor(seeds),
                               torch.as_tensor(pos), fold).tolist()
        want = [tsampling._signed(tsampling._key64(s, p, fold))
                for s, p in zip(seeds, pos)]
        assert got == want, fold
    u = tsampling._uniforms(torch.as_tensor(seeds), torch.as_tensor(pos),
                            tsampling.DRAFT_FOLD, 256)
    assert 0 < float(u.min()) and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_draft_draw_greedy_rows_and_determinism():
    lg = torch.as_tensor(_rows(4, seed=3))
    temp = torch.tensor([0.0, 1.0, 0.7, 2.0])
    topk = torch.tensor([0, 0, 1, 3])
    seeds, pos = torch.tensor([1, 2, 3, 4]), torch.tensor([5, 6, 7, 8])
    a = tsampling.draft_sample_tokens(lg, temp, topk, seeds, pos)
    b = tsampling.draft_sample_tokens(lg, temp, topk, seeds, pos)
    assert torch.equal(a, b)
    am = lg.argmax(-1)
    assert a[0] == am[0] and a[2] == am[2]      # greedy, and top-k 1
    assert a[3] in torch.topk(lg[3], 3).indices


def _tv(counts, p):
    return 0.5 * float(np.abs(counts / counts.sum() - p).sum())


def test_sampled_accept_preserves_the_target_distribution():
    """Draft proposals drawn on the device from q, then the rejection
    rule: the emitted first token follows p (the target's softmax) and
    the proposals follow q, each within TV 0.05 over 4000 draws, while
    p and q themselves lie more than 0.2 apart."""
    n, vocab = 4000, 8
    tl = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5],
                       [0.0] * vocab])
    dl = torch.tensor([[-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0]])
    p = torch.softmax(tl[0], -1).numpy()
    q = torch.softmax(dl[0], -1).numpy()
    assert _tv(q * n, p) > 0.2
    seeds = torch.arange(n)
    proposals = tsampling.draft_sample_tokens(
        dl.expand(n, vocab), torch.ones(n), torch.zeros(n, dtype=torch.long),
        seeds, torch.full((n,), 9))
    first = np.zeros(vocab)
    for s in range(n):
        out = tsampling.speculative_accept(
            tl, [int(proposals[s])], dl, temperature=1.0, top_k=0,
            seed=s, position0=9)
        first[out[0]] += 1
    assert _tv(np.bincount(proposals.numpy(), minlength=vocab), q) < 0.05
    assert _tv(first, p) < 0.05


def test_sampled_accept_deterministic_and_window_bounded():
    tl = torch.as_tensor(_rows(5, seed=6))
    dl = torch.as_tensor(_rows(4, seed=7))
    draft = [3, 7, 1, 9]
    kw = dict(temperature=0.8, top_k=8, seed=42, position0=11)
    a = tsampling.speculative_accept(tl, draft, dl, **kw)
    assert a == tsampling.speculative_accept(tl, draft, dl, **kw)
    assert 1 <= len(a) <= 5 and all(0 <= t < 16 for t in a)
    assert a[:-1] == draft[:len(a) - 1]      # accepted proposals first


# ---------------------------------------------------------------- engine

_SPEC = [(5, 9), (9, 6), (3, 11)]
_JAX_RUNS = {}


def _drive(eng):
    prompts = [_prompt(70 + i, lp) for i, (lp, _) in enumerate(_SPEC)]
    reqs = [eng.submit(prompts[0], _SPEC[0][1]),
            eng.submit(prompts[1], _SPEC[1][1])]
    for _ in range(2):
        eng.step()               # the third request joins mid-flight
    reqs.append(eng.submit(prompts[2], _SPEC[2][1]))
    eng.run()
    return ([r.state for r in reqs], [list(map(int, r.output)) for r in reqs],
            prompts, eng.spec_stats())


def _jax_spec(jparams):
    if "spec" not in _JAX_RUNS:
        _JAX_RUNS["spec"] = _drive(JServeEngine(jparams, JServeConfig(
            **_spec_cfg(2))))
    return _JAX_RUNS["spec"]


@pytest.mark.parametrize("attention", ["gather", "paged"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_streams_equal_plain_jax_and_lm_decode(jparams, tparams, k,
                                                    attention):
    states, outs, prompts, sp = _drive(ServeEngine(
        tparams, ServeConfig(**_spec_cfg(k, attention)), device="cpu"))
    _, plain, _, none = _drive(ServeEngine(tparams, ServeConfig(
        page_size=8, num_pages=40, decode_slots=2, prefill_chunk=4,
        attention=attention), device="cpu"))
    _, jouts, _, jsp = _jax_spec(jparams)
    assert states == ["finished"] * 3 and none is None
    assert outs == plain == jouts
    for out, p, (_, n) in zip(outs, prompts, _SPEC):
        assert out == _ref(tparams, p, n)
    assert sp["k"] == k and sp["ticks"] > 0
    if k == 2:
        assert sp == jsp        # the same schedule, the same accounting


@pytest.mark.parametrize("n", [1, 3])
def test_budget_clamp_never_overshoots(tparams, n):
    prompt = _prompt(80, 7)
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(4)), device="cpu")
    req = eng.submit(prompt, n)
    eng.run()
    assert req.state == "finished" and req.output == _ref(tparams, prompt,
                                                          n)


def test_eos_mid_window_truncates(tparams):
    prompt = _prompt(3, 6)
    full = _ref(tparams, prompt, 8)
    eos = full[2]
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(4, draft_layers=2)),
                      device="cpu")
    req = eng.submit(prompt, 8, eos_token=eos)
    eng.run()
    assert req.state == "finished"
    assert req.output == full[:full.index(eos) + 1]


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_eviction_recompute_stays_exact_under_spec(tparams, attention):
    spec = [(9, 10), (11, 8), (10, 9)]
    prompts = [_prompt(30 + i, lp) for i, (lp, _) in enumerate(spec)]
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(
        2, attention, page_size=4, num_pages=8, admission="lazy")),
        device="cpu")
    reqs = [eng.submit(p, n) for p, (_, n) in zip(prompts, spec)]
    eng.run(max_steps=500)
    assert sum(r.evictions for r in reqs) > 0, "must exercise eviction"
    for req, p, (_, n) in zip(reqs, prompts, spec):
        assert req.state == "finished" and req.output == _ref(tparams, p, n)


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_prefix_cow_stays_exact_under_spec(tparams, attention):
    sys_p = _prompt(61, 16)
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(
        2, attention, prefix_caching=True, decode_slots=1)), device="cpu")
    prompts = [np.concatenate([sys_p, _prompt(62 + i, 3)])
               for i in range(2)]
    reqs = [eng.submit(p, 4) for p in prompts]
    eng.run()
    assert eng.prefix_stats()["hits"] >= 1
    assert eng.prefix_stats()["cow_copies"] == 0
    for req, p in zip(reqs, prompts):
        assert req.state == "finished" and req.output == _ref(tparams, p, 4)


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_full_depth_draft_accepts_everything(tparams, attention):
    prompt = _prompt(81, 6)
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(
        4, attention, draft_layers=LAYERS, decode_slots=1)), device="cpu")
    req = eng.submit(prompt, 9)
    eng.run()
    assert req.output == _ref(tparams, prompt, 9)
    sp = eng.stats()["spec"]
    assert sp["accept_rate"] == 1.0
    assert sp["proposed"] == sp["accepted"] > 0
    assert sp["tokens_per_step"] > 1.0


def test_draft_layers_auto_and_too_deep(tparams):
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(2, draft_layers=0)),
                      device="cpu")
    assert eng.draft_layers == max(1, LAYERS // 2)
    assert eng.spec_stats()["draft_layers"] == LAYERS // 2
    assert eng.lane_graphs is None      # the CPU runs the lane eagerly
    with pytest.raises(InvalidArgumentError, match="draft") as e:
        ServeEngine(tparams, ServeConfig(**_spec_cfg(
            2, draft_layers=LAYERS + 1)), device="cpu")
    # The one range check is the model's draft_params.
    assert "draft_params" in str(e.value.__cause__)


def test_spec_stats_block_shape_and_reset(tparams):
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(2)), device="cpu")
    req = eng.submit(_prompt(84, 5), 5)
    eng.run()
    sp = eng.stats()["spec"]
    assert set(sp) == {"k", "draft_layers", "ticks", "proposed",
                       "accepted", "accept_rate", "tokens_per_step"}
    assert sp["ticks"] > 0 and sp["proposed"] >= sp["accepted"] >= 0
    assert 1.0 <= sp["tokens_per_step"] <= sp["k"] + 1
    assert req.output == _ref(tparams, req.prompt, 5)
    eng.reset_metrics()
    sp = eng.spec_stats()
    assert sp["ticks"] == sp["proposed"] == sp["accepted"] == 0
    assert sp["accept_rate"] is None
    base = ServeEngine(tparams, ServeConfig(page_size=8, num_pages=16,
                                            decode_slots=1,
                                            prefill_chunk=4), device="cpu")
    assert "spec" not in base.stats() and base.spec_stats() is None


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_greedy_neighbour_unaffected_by_a_sampling_slot(tparams,
                                                        attention):
    pg, ps = _prompt(7, 6), _prompt(8, 6)
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(2, attention)),
                      device="cpu")
    rg = eng.submit(pg, 6)
    rs = eng.submit(ps, 6, temperature=1.2, top_k=4, seed=9)
    eng.run()
    assert rg.output == _ref(tparams, pg, 6)
    assert len(rs.output) == 6 and all(0 <= t < V for t in rs.output)


@pytest.mark.parametrize("evict", [False, True])
def test_sampled_stream_same_seed_deterministic(tparams, evict):
    """Same seed, same schedule, same stream — also when the schedule
    evicts and recomputes (the draft re-draws the same proposal at each
    position); another seed draws another stream."""
    cfg = (_spec_cfg(2, "paged", page_size=4, num_pages=8,
                     admission="lazy") if evict
           else _spec_cfg(2, decode_slots=1))
    spec = [(9, 10), (11, 8), (10, 9)] if evict else [(5, 8)]

    def run(seed):
        eng = ServeEngine(tparams, ServeConfig(**cfg), device="cpu")
        reqs = [eng.submit(_prompt(90 + i, lp), n, temperature=0.8,
                           top_k=8, seed=seed + i)
                for i, (lp, n) in enumerate(spec)]
        eng.run(max_steps=500)
        assert all(r.state == "finished" for r in reqs)
        return ([r.output for r in reqs], sum(r.evictions for r in reqs))

    (a, ev), (b, _), (c, _) = run(42), run(42), run(7)
    assert a == b and a != c
    assert (ev > 0) == evict
    assert all(0 <= t < V for out in a for t in out)


def test_lane_masked_rows_write_only_the_null_page(tparams):
    """One live slot of three with a window of 2 rows (k=3): the idle
    slots and the live slot's rows past its width write into page 0 only;
    the live slot writes exactly its two positions in both modes; the
    two modes' argmaxes agree."""
    ps, pps, num_pages = 4, 3, 10
    gen = torch.Generator().manual_seed(0)
    pages = [{kv: torch.randn(num_pages, ps, H, DH, generator=gen)
              for kv in ("k", "v")} for _ in range(LAYERS)]
    tables = np.zeros((3, pps), np.int32)
    tables[1] = [5, 2, 0]
    dec = {"tok": np.array([0, 7, 0], np.int32),
           "pos": np.array([0, 5, 0], np.int32),
           "active": np.array([False, True, False]), "tables": tables,
           "width": np.array([0, 2, 0], np.int32),
           "temp": np.zeros(3, np.float32), "topk": np.zeros(3, np.int32),
           "seed": np.zeros(3, np.int64), "sidx": np.zeros(3, np.int64)}
    index, temps = pack_spec(dec, ps)
    assert index.dtype == np.int32 and index.shape == (3 * (pps + 9),)
    toks = {}
    for attention in ("gather", "paged"):
        work = [{kv: t.clone() for kv, t in pg.items()} for pg in pages]
        tokens, ver, dl = spec_lane(
            tparams, work, torch.as_tensor(index), torch.as_tensor(temps),
            slots=3, k=3, draft_layers=1, page_size=ps, attention=attention)
        assert tokens.shape == (3, 7) and ver.shape == (3, 4, V)
        assert dl.shape == (3, 3, V)
        toks[attention] = tokens[1, :2].tolist() + tokens[1, 4:5].tolist()
        for before, after in zip(pages, work):
            for kv in ("k", "v"):
                changed = (before[kv] != after[kv]).flatten(2).any(-1)
                # page 0 row 0 (masked rows), page 2 rows 1-2 (pos 5-6).
                assert changed.nonzero().tolist() == [[0, 0], [2, 1],
                                                      [2, 2]], (attention,
                                                                kv)
    assert toks["gather"] == toks["paged"]


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_lane_without_the_sampled_draw_gives_the_same_greedy_tick(
        tparams, attention):
    """All live slots greedy: ``spec_lane(sampled=False)`` returns the
    same tokens and logits, and writes the same pages, as the lane with
    the sampled draw."""
    ps, pps, num_pages, k = 4, 4, 12, 3
    gen = torch.Generator().manual_seed(1)
    pages = [{kv: torch.randn(num_pages, ps, H, DH, generator=gen)
              for kv in ("k", "v")} for _ in range(LAYERS)]
    tables = np.array([[3, 4, 0, 0], [0, 0, 0, 0], [5, 6, 7, 0]],
                      np.int32)
    dec = {"tok": np.array([3, 0, 9], np.int32),
           "pos": np.array([5, 0, 8], np.int32),
           "active": np.array([True, False, True]), "tables": tables,
           "width": np.array([4, 0, 3], np.int32),
           "temp": np.zeros(3, np.float32),
           "topk": np.array([5, 0, 0], np.int32),
           "seed": np.array([11, 0, 12], np.int64),
           "sidx": np.array([2, 0, 4], np.int64)}
    index, temps = pack_spec(dec, ps)
    outs, written = [], []
    for sampled in (True, False):
        work = [{kv: t.clone() for kv, t in pg.items()} for pg in pages]
        outs.append(spec_lane(
            tparams, work, torch.as_tensor(index), torch.as_tensor(temps),
            slots=3, k=k, draft_layers=1, page_size=ps,
            attention=attention, sampled=sampled))
        written.append(work)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for pa, pb in zip(*written):
        for kv in ("k", "v"):
            assert torch.equal(pa[kv], pb[kv])


def test_engine_skips_the_sampled_draw_only_on_greedy_ticks(tparams,
                                                            monkeypatch):
    """The engine asks for the sampled draw exactly on the ticks where a
    live slot samples."""
    from horovod_tpu_torch.serve import engine as tengine

    ticks = []      # (sampled, a live slot samples) per lane call
    lane = tengine.spec_lane

    def spy(*args, sampled, **kw):
        ticks.append((sampled, any(r is not None and r.temperature > 0
                                   for r in eng.slots)))
        return lane(*args, sampled=sampled, **kw)

    monkeypatch.setattr(tengine, "spec_lane", spy)
    eng = ServeEngine(tparams, ServeConfig(**_spec_cfg(2)), device="cpu")
    eng.submit(_prompt(0, 6), 6)
    eng.run()
    assert ticks and set(ticks) == {(False, False)}
    ticks.clear()
    greedy = eng.submit(_prompt(1, 6), 12)
    hot = eng.submit(_prompt(2, 6), 3, temperature=0.8, top_k=5, seed=3)
    eng.run()
    assert greedy.state == hot.state == "finished"
    assert set(ticks) == {(True, True), (False, False)}
