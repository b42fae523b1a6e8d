"""The port's prefix cache against ``horovod_tpu.serve.prefix``.

The host code is a copy, so the copy is held to the reference call for
call: ``aligned_prefix_len``, ``prefix_route_key`` and
``rendezvous_rank`` give the reference's outputs, and a ``PrefixIndex``
driven by the same sequence of ``match``/``insert``/``reclaim``/``flush``
calls (over each package's own allocator) leaves the same pages,
refcounts, counters and ``stats()``.

The engine cases mirror tests/test_serve_prefix.py's: ``cow_page`` copies
content and swaps holds; the engine's COW guard unshares a sabotaged
page; cache-hit streams equal the cold streams, ``lm_decode``'s and the
JAX engine's bit for bit (with the same ``prefix_stats``), in both
admission modes and both attention modes; admission charges only the
missed pages; ``update_params`` flushes the index; a prefix survives its
prefiller; and the cache is off by default. JAX weights cross with
``params_from_numpy``; prompts come from numpy seeds.
"""

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.serve import PageAllocator as JPageAllocator
from horovod_tpu.serve import PrefixIndex as JPrefixIndex
from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeEngine as JServeEngine
from horovod_tpu.serve import prefix as jprefix
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import (PageAllocator, PagedKVCache,
                                     PrefixIndex, ServeConfig, ServeEngine)
from horovod_tpu_torch.serve import prefix as tprefix

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 2, 8, 32


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_lm_params(jax.random.PRNGKey(0), V, LMAX, LAYERS, H,
                              DH, FFN)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tlm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _prompt(i, lp):
    return np.random.default_rng(200 + i).integers(0, V, lp).astype(
        np.int32)


def _ref(params, prompt, steps):
    return tlm.lm_decode(params, np.asarray(prompt)[None], steps,
                         device="cpu")[0].tolist()


def _cfg(**kw):
    base = dict(page_size=8, num_pages=40, decode_slots=2,
                prefill_chunk=4, prefix_caching=True)
    base.update(kw)
    return base


# ------------------------------------------------------- pure helpers


@pytest.mark.parametrize("page_size", [1, 4, 8, 16])
def test_aligned_prefix_len_matches_jax(page_size):
    for n in range(0, 70):
        assert tprefix.aligned_prefix_len(n, page_size) == \
            jprefix.aligned_prefix_len(n, page_size), n


@pytest.mark.parametrize("page_size", [4, 8])
def test_route_key_and_rendezvous_match_jax(page_size):
    rng = np.random.default_rng(page_size)
    for lp in (1, page_size, page_size + 1, 3 * page_size + 2, 40):
        prompt = rng.integers(0, V, lp).tolist()
        key = tprefix.prefix_route_key(prompt, page_size)
        assert key == jprefix.prefix_route_key(prompt, page_size), lp
        if key is not None:
            for r in range(4):
                assert tprefix.rendezvous_rank(key, r) == \
                    jprefix.rendezvous_rank(key, r)


def _index_state(alloc, idx):
    return (idx.stats(), idx.entries, alloc.available, alloc.in_use,
            [alloc.refcount(p) for p in range(alloc.num_pages)])


@pytest.mark.parametrize("seed", range(6))
def test_prefix_index_same_calls_same_pages_and_counters(seed):
    """A random sequence of index and allocator calls over four prompts
    that share chunks: both packages return the same pages, matched
    tokens and reclaim/flush counts, and end each call with the same
    counters, entries and refcounts."""
    rng = np.random.default_rng(seed)
    ps, num_pages = 4, 24
    stem = rng.integers(0, 6, 12).tolist()
    prompts = [stem[:n] + rng.integers(0, 6, m).tolist()
               for n, m in ((12, 3), (8, 5), (4, 9), (0, 10))]
    pair = [(JPageAllocator(num_pages), None),
            (PageAllocator(num_pages), None)]
    pair = [(a, cls(a, ps)) for (a, _), cls in
            zip(pair, (JPrefixIndex, PrefixIndex))]
    held = [[] for _ in pair]
    for step in range(40):
        op = rng.choice(["insert", "match", "admit", "reclaim", "release",
                         "flush", "reset"], p=[.3, .2, .15, .1, .15, .05,
                                               .05])
        p = prompts[int(rng.integers(len(prompts)))]
        n = int(rng.integers(1, 4))
        results = []
        for (alloc, idx), mine in zip(pair, held):
            if op == "insert":
                need = -(-len(p) // ps)
                if alloc.available < need:
                    res = "full"
                else:
                    table = alloc.alloc(need)
                    mine.extend(table)
                    res = idx.insert(p, table)
            elif op == "match":
                res = idx.match(p)
            elif op == "admit":
                res = idx.note_admission(n, n * ps)
            elif op == "reclaim":
                res = idx.reclaim(n)
            elif op == "release":
                res = mine[:n]
                alloc.release(mine[:n])
                del mine[:n]
            elif op == "flush":
                res = idx.flush()
            else:
                res = idx.reset_metrics()
            results.append((res, _index_state(alloc, idx)))
        assert results[0] == results[1], (step, op)


def test_flush_keeps_the_requests_holds():
    alloc = PageAllocator(32)
    idx = PrefixIndex(alloc, 4)
    held = alloc.alloc(2)
    idx.insert(list(range(9)), list(held))
    assert idx.flush() == 2 and idx.entries == 0
    assert alloc.refcount(held[0]) == 1
    assert idx.match(list(range(9))) == ([], 0)


# ------------------------------------------------- COW on the cache


def test_cow_page_copies_content_and_swaps_holds(tparams):
    cache = PagedKVCache(tparams, ServeConfig(page_size=8, num_pages=9))
    (page,) = cache.allocator.alloc(1)
    for layer in cache.pages:
        for kv in ("k", "v"):
            layer[kv][page] = torch.randn(layer[kv][page].shape)
    cache.allocator.retain([page])      # a second holder appears
    before = [{kv: t[page].clone() for kv, t in layer.items()}
              for layer in cache.pages]
    new = cache.cow_page(page)
    assert new != page
    for layer, old in zip(cache.pages, before):
        for kv in ("k", "v"):
            assert torch.equal(layer[kv][new], old[kv])
    assert cache.allocator.refcount(page) == 1
    assert cache.allocator.refcount(new) == 1


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_engine_cow_guard_unshares_a_sabotaged_page(tparams, attention):
    """Retain a page the decode WILL write: the guard copies it
    (``cow_copies`` counts the slip) and the stream stays exact."""
    prompt = _prompt(0, 11)
    eng = ServeEngine(tparams, ServeConfig(**_cfg(attention=attention)),
                      device="cpu")
    req = eng.submit(prompt, 6)
    eng.run(max_steps=4)                # prefill done, decoding
    assert req.generated
    hot = int(req.page_table[req.next_pos // eng.config.page_size])
    eng.cache.allocator.retain([hot])   # a stray share
    eng.run()
    assert req.state == "finished" and eng.cow_copies >= 1
    assert req.output == _ref(tparams, prompt, 6)
    eng.cache.allocator.release([hot])


# ------------------------------------------- engine hit exactness

_SYS = list(_prompt(1, 18))
_TAILS = [[3, 5, 9], [11, 2], [44, 1, 2, 3]]
_JAX_RUNS = {}


def _serial(eng, prompts, n=6):
    outs = []
    for p in prompts:
        r = eng.submit(np.asarray(p, np.int32), n)
        eng.run()
        outs.append((list(map(int, r.output)), r.prefix_hit_tokens))
    return outs, eng.prefix_stats()


def _jax_hits(jparams, admission):
    if admission not in _JAX_RUNS:
        eng = JServeEngine(jparams, JServeConfig(**_cfg(
            admission=admission)))
        _JAX_RUNS[admission] = _serial(eng, [_SYS + t for t in _TAILS])
    return _JAX_RUNS[admission]


@pytest.mark.parametrize("attention", ["gather", "paged"])
@pytest.mark.parametrize("admission", ["reserve", "lazy"])
def test_hit_streams_equal_cold_lm_decode_and_jax(jparams, tparams,
                                                  admission, attention):
    prompts = [_SYS + t for t in _TAILS]
    cold, none = _serial(ServeEngine(tparams, ServeConfig(**_cfg(
        admission=admission, attention=attention,
        prefix_caching=False)), device="cpu"), prompts)
    assert none is None
    hot, stats = _serial(ServeEngine(tparams, ServeConfig(**_cfg(
        admission=admission, attention=attention)), device="cpu"), prompts)
    want, want_stats = _jax_hits(jparams, admission)
    assert hot == want and stats == want_stats
    assert stats["hits"] == 2 and stats["lookups"] == 3
    assert stats["prefill_tokens_saved"] == 32 and stats["cow_copies"] == 0
    assert [h for _, h in hot] == [0, 16, 16]
    for (out, _), (c, _), p in zip(hot, cold, prompts):
        assert out == c == _ref(tparams, p, 6)


def test_admission_counts_only_missed_pages(tparams):
    """Reserve admission charges need - hit pages: a request that fits
    only thanks to its prefix hit is admitted."""
    sys_p = list(_prompt(2, 16))
    eng = ServeEngine(tparams, ServeConfig(**_cfg(num_pages=5)),
                      device="cpu")
    r1 = eng.submit(np.asarray(sys_p + [1, 2, 3], np.int32), 6)
    eng.run()
    assert r1.state == "finished" and eng.prefix.entries == 2
    p2 = np.asarray(sys_p + [9, 8, 7], np.int32)
    assert eng.cache.pages_needed(len(p2), 6) > \
        eng.cache.allocator.available   # would NOT fit cold...
    r2 = eng.submit(p2, 6)
    eng.run()
    assert r2.state == "finished"        # ...but fits via the hit
    assert r2.prefix_hit_pages == 2
    assert r2.output == _ref(tparams, p2, 6)


def test_update_params_flushes_the_index(tparams):
    eng = ServeEngine(tparams, ServeConfig(**_cfg()), device="cpu")
    eng.submit(_prompt(3, 20), 4)
    eng.run()
    assert eng.prefix.entries > 0
    other = tlm.init_lm_params(5, V, LMAX, LAYERS, H, DH, FFN, device="cpu")
    eng.update_params(other)
    assert eng.prefix.entries == 0 and eng.prefix_stats()["flushes"] == 1
    r2 = eng.submit(_prompt(3, 20), 4)   # same prompt, new weights
    eng.run()
    assert r2.prefix_hit_tokens == 0     # stale K/V never served
    assert r2.output == _ref(other, _prompt(3, 20), 4)


def test_prefix_survives_its_prefiller(tparams):
    eng = ServeEngine(tparams, ServeConfig(**_cfg()), device="cpu")
    p = _prompt(4, 20)
    r1 = eng.submit(p, 3)
    eng.run()
    assert r1.state == "finished" and r1.pages == []
    r2 = eng.submit(np.asarray(list(p) + [7], np.int32), 3)
    eng.run()
    assert r2.prefix_hit_tokens == 16
    assert r2.output == _ref(tparams, list(p) + [7], 3)


def test_lazy_pressure_reclaims_index_pages_before_evicting(tparams):
    """Under lazy admission a page only the index holds is reclaimed
    before any live request is evicted."""
    eng = ServeEngine(tparams, ServeConfig(**_cfg(
        num_pages=6, admission="lazy", decode_slots=1)), device="cpu")
    eng.submit(_prompt(5, 17), 2)
    eng.run()
    assert eng.prefix.entries == 2
    r = eng.submit(_prompt(6, 20), 12)
    eng.run()
    assert r.state == "finished" and r.evictions == 0
    assert eng.prefix_stats()["reclaimed"] >= 1
    assert r.output == _ref(tparams, _prompt(6, 20), 12)


def test_off_by_default_no_index_no_stats(tparams):
    eng = ServeEngine(tparams, ServeConfig(page_size=8, num_pages=40,
                                           decode_slots=2, prefill_chunk=4),
                      device="cpu")
    assert eng.prefix is None and eng.prefix_stats() is None
    assert "prefix" not in eng.stats()
    assert eng.scheduler.prefix is None
