"""The port's disaggregated prefill/decode serving against the reference.

* **Queue 3 repair** — ``PagedKVCache.can_admit``/``stats`` and
  ``Scheduler.queued`` answer as the reference's over the same
  alloc/retain/release/free and submit/pick sequences;
* **pools** — ``FleetConfig.pools`` validation and normalisation,
  ``prefill_replicas`` and ``pool_of``, case for case against the
  reference (equal values, or the same exception type and message);
* **the HVKV blob** — the same page contents export to the same bytes in
  both packages (float32 and bfloat16), each package imports the other's
  blob exactly, and the reference's export/import cases hold for the
  port (round trip, read-only under sharing, COW, churn conservation,
  geometry, torn blobs, out-of-pages all-or-nothing, page math); an
  import writes into the existing page tensors (``data_ptr`` unchanged);
* **the engine's handoff bay** — parking, export, release and
  ``admit_prefilled`` (all-or-nothing), the deadline sweep, and a stream
  prefilled in one engine and decoded in another equal to ``lm_decode``'s
  and to the reference engines' same handoff;
* **the in-process disagg fleet on a fake clock** against the JAX fleet
  with the same pools: streams, placements, ``transfers``,
  ``kv_bytes_shipped`` and ``chunks_shipped`` equal, clean and under
  both tear sides; the one-shot fault hook; same-seed sampled streams
  colocated equal to disaggregated within the port (sampled streams are
  not compared across packages: the port cannot reproduce
  ``jax.random``).

Tolerance: none anywhere — greedy token streams, blob bytes and page
tiles are compared for exact equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.serve import FleetConfig as JFleetConfig
from horovod_tpu.serve import PagedKVCache as JPagedKVCache
from horovod_tpu.serve import Scheduler as JScheduler
from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeEngine as JServeEngine
from horovod_tpu.serve import ServeFleet as JServeFleet
from horovod_tpu.serve import scheduler as jsched
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import (FleetConfig, OutOfPages, PagedKVCache,
                                     Scheduler, ServeConfig, ServeEngine,
                                     ServeFleet)
from horovod_tpu_torch.serve import scheduler as tsched
from horovod_tpu_torch.serve.transport import FrameError

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 2, 8, 32
CFG = dict(page_size=8, num_pages=32, decode_slots=2, prefill_chunk=4)
POOLS = {"prefill": 1, "decode": 1}


def _map(fn, x):
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_map(fn, v) for v in x]
    return fn(x)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_lm_params(jax.random.PRNGKey(0), V, LMAX, LAYERS, H,
                              DH, FFN)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tlm.params_from_numpy(_map(np.asarray, jparams), device="cpu")


def _prompt(i, lp):
    return np.random.default_rng(500 + i).integers(0, V, lp).astype(
        np.int32)


def _ref(params, prompt, steps):
    return tlm.lm_decode(params, np.asarray(prompt)[None], steps,
                         device="cpu")[0].tolist()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


# ------------------------------------------------------------- caches

#: The reference's cache geometry (tests/test_serve_kvcache.py): 1 layer,
#: 2 heads of 4, Lmax 32, page 8.
C_V, C_LMAX, C_H, C_D = 32, 32, 2, 4


def _caches(num_pages=9, dtype="float32"):
    """The reference's cache and the port's over the same geometry."""
    jp = jlm.init_lm_params(jax.random.PRNGKey(0), C_V, C_LMAX, 1, C_H,
                            C_D, 8, dtype=getattr(jnp, dtype))
    tp = tlm.init_lm_params(0, C_V, C_LMAX, 1, C_H, C_D, 8,
                            dtype=getattr(torch, dtype), device="cpu")
    return (JPagedKVCache(jp, JServeConfig(page_size=8,
                                           num_pages=num_pages)),
            PagedKVCache(tp, ServeConfig(page_size=8, num_pages=num_pages)))


def _tile(r, cache):
    return r.randn(cache.config.page_size, cache.num_heads,
                   cache.head_dim).astype(np.float32)


def _fill_port(cache, pages, seed):
    r = np.random.RandomState(seed)
    for layer in cache.pages:
        for kv in ("k", "v"):
            for p in pages:
                layer[kv][p] = torch.from_numpy(_tile(r, cache)).to(
                    cache.dtype)


def _fill_ref(cache, pages, seed):
    r = np.random.RandomState(seed)
    for layer in cache.pages:
        for kv in ("k", "v"):
            for p in pages:
                layer[kv] = layer[kv].at[p].set(
                    jnp.asarray(_tile(r, cache)).astype(cache.dtype))


def _tiles_port(cache, pages):
    idx = torch.tensor(list(pages), dtype=torch.long)
    return {(li, kv): layer[kv][idx].float().numpy()
            for li, layer in enumerate(cache.pages) for kv in ("k", "v")}


def _tiles_ref(cache, pages):
    idx = np.asarray(list(pages))
    return {(li, kv): np.asarray(layer[kv][idx].astype(jnp.float32))
            for li, layer in enumerate(cache.pages) for kv in ("k", "v")}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------------ Queue 3 repair


def _ops(seed, n=40):
    """A random admit/alloc/retain/release/free sequence."""
    rng = random.Random(seed)
    return [(rng.choice(("alloc", "alloc", "retain", "release", "free")),
             rng.randint(1, 3), rng.random()) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_can_admit_and_stats_match_the_reference(seed):
    jc, tc = _caches(num_pages=12)
    held = []           # grants, the same ids in both (LIFO free lists)
    for op, n, u in _ops(seed):
        if op == "alloc" and jc.allocator.available >= n:
            g = jc.allocator.alloc(n)
            assert tc.allocator.alloc(n) == g
            held.append(g)
        elif op == "retain" and held:
            g = held[int(u * len(held))]
            jc.allocator.retain(g)
            tc.allocator.retain(g)
            held.append(list(g))
        elif op in ("release", "free") and held:
            g = held.pop(int(u * len(held)))
            shared = any(jc.allocator.is_shared(p) for p in g)
            how = "release" if shared or op == "release" else "free"
            getattr(jc.allocator, how)(g)
            getattr(tc.allocator, how)(g)
        assert tc.stats() == jc.stats()
        for prompt, new in ((1, 1), (8, 2), (16, 9), (20, 12), (31, 1)):
            assert tc.can_admit(prompt, new) == jc.can_admit(prompt, new)


def test_scheduler_queued_matches_the_reference():
    jc, tc = _caches(num_pages=12)
    clk = FakeClock()
    jcfg = JServeConfig(page_size=8, num_pages=12, decode_slots=2,
                        prefill_chunk=4)
    tcfg = ServeConfig(page_size=8, num_pages=12, decode_slots=2,
                       prefill_chunk=4)
    js, ts = JScheduler(jc, jcfg), Scheduler(tc, tcfg)
    assert ts.queued() == js.queued() == 0
    for i, (lp, n) in enumerate([(5, 4), (9, 6), (3, 2), (30, 5),
                                 (7, 7)]):
        p = _prompt(i, lp)
        js.submit(jsched.make_request(jcfg, clk, p, n))
        ts.submit(tsched.make_request(tcfg, clk, p, n))
        assert ts.queued() == js.queued()
    for free, inflight in ((2, 0), (1, 1), (2, 1), (0, 2)):
        a, b = js.pick_prefill(free, inflight), ts.pick_prefill(free,
                                                               inflight)
        assert (a is None) == (b is None)
        assert ts.queued() == js.queued()


# -------------------------------------------------------------- pools


@pytest.mark.parametrize("replicas,pools", [
    (2, None),
    (3, {"prefill": 1, "decode": 2}),
    (2, (("decode", 1), ("prefill", 1))),
    (4, {"prefill": 3, "decode": 1}),
    (2, {"prefill": 1, "verify": 1}),
    (2, {"prefill": 2}),
    (2, {"prefill": 0, "decode": 2}),
    (2, {"prefill": 1, "decode": "one"}),
    (2, {"prefill": 1, "decode": 1.0}),
    (2, {"prefill": 2, "decode": 2}),
    (2, {"prefill": 1, "decode": 3}),
], ids=["colocated", "1p2d", "pairs", "3p1d", "bad_key", "one_key",
        "empty_pool", "str", "float", "over", "under"])
def test_pools_validate_and_map_as_the_reference(replicas, pools):
    out = []
    for Cfg in (JFleetConfig, FleetConfig):
        try:
            c = Cfg(replicas=replicas, pools=pools)
        except Exception as e:      # compared across packages below
            out.append((type(e).__name__, str(e)))
            continue
        hash(c)
        out.append((c.pools, c.prefill_replicas,
                    [c.pool_of(i) for i in range(replicas)]))
    assert out[1] == out[0]


# -------------------------------------------------------------- blobs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blob_bytes_identical_and_cross_imported(dtype):
    """The same page contents export to the same bytes in both packages,
    and each package's blob imports into the other's cache exactly."""
    jsrc, tsrc = _caches(dtype=dtype)
    pages = jsrc.allocator.alloc(3)
    assert tsrc.allocator.alloc(3) == pages
    _fill_ref(jsrc, pages, seed=1)
    _fill_port(tsrc, pages, seed=1)
    jblob = jsrc.export_pages(pages, 20)
    tblob = tsrc.export_pages(pages, 20)
    assert tblob == jblob
    assert b'"dtype": "%s"' % dtype.encode() in tblob[:256]
    jdst, tdst = _caches(dtype=dtype)
    tgrant, tpos = tdst.import_pages(jblob)
    jgrant, jpos = jdst.import_pages(tblob)
    assert (tpos, jpos) == (20, 20)
    _assert_same(_tiles_port(tdst, tgrant), _tiles_ref(jsrc, pages))
    _assert_same(_tiles_ref(jdst, jgrant), _tiles_port(tsrc, pages))
    assert tdst.export_pages(tgrant, 20) == jblob


def test_import_writes_the_existing_page_tensors():
    _, src = _caches()
    _, dst = _caches()
    pages = src.allocator.alloc(2)
    _fill_port(src, pages, seed=3)
    ptrs = [(layer["k"].data_ptr(), layer["v"].data_ptr())
            for layer in dst.pages]
    tensors = [(layer["k"], layer["v"]) for layer in dst.pages]
    grant, _ = dst.import_pages(src.export_pages(pages, 16))
    assert [(layer["k"].data_ptr(), layer["v"].data_ptr())
            for layer in dst.pages] == ptrs
    assert all(a is layer["k"] and b is layer["v"]
               for (a, b), layer in zip(tensors, dst.pages))
    _assert_same(_tiles_port(dst, grant), _tiles_port(src, pages))


def test_round_trip_bytes_identical():
    _, src = _caches()
    _, dst = _caches()
    pages = src.allocator.alloc(3)
    _fill_port(src, pages, seed=1)
    blob = src.export_pages(pages, 20)       # ceil(20/8) = 3 pages
    grant, positions = dst.import_pages(blob)
    assert positions == 20 and len(grant) == 3
    _assert_same(_tiles_port(src, pages), _tiles_port(dst, grant))
    assert src.allocator.in_use == 3 and dst.allocator.in_use == 3
    assert src.export_pages(pages, 20) == blob


def test_export_is_read_only_under_sharing():
    _, src = _caches()
    pages = src.allocator.alloc(2)
    src.allocator.retain(pages)              # prefix-style share
    before = {p: src.allocator.refcount(p) for p in pages}
    src.export_pages(pages, 16)
    assert {p: src.allocator.refcount(p) for p in pages} == before
    src.allocator.release(pages)
    src.allocator.release(pages)
    assert src.allocator.available == src.allocator.capacity


def test_cow_shared_pages_round_trip():
    _, src = _caches()
    _, dst = _caches()
    pages = src.allocator.alloc(2)
    _fill_port(src, pages, seed=2)
    src.allocator.retain(pages)              # second holder
    new0 = src.cow_page(pages[0])            # writer's private copy
    table = [new0, pages[1]]
    grant, _ = dst.import_pages(src.export_pages(table, 16))
    _assert_same(_tiles_port(src, table), _tiles_port(dst, grant))
    assert src.allocator.refcount(pages[0]) == 1
    assert src.allocator.refcount(pages[1]) == 2
    assert src.allocator.refcount(new0) == 1
    dst.allocator.release(grant)
    src.allocator.release([new0, pages[1]])
    src.allocator.release(pages)
    assert src.allocator.available == src.allocator.capacity
    assert dst.allocator.available == dst.allocator.capacity


def test_churn_round_trip_conservation():
    rng = random.Random(11)
    _, src = _caches(num_pages=33)
    _, dst = _caches(num_pages=33)
    for cache in (src, dst):
        live = []
        for _ in range(60):
            if live and rng.random() < 0.5:
                cache.allocator.release(live.pop(rng.randrange(len(live))))
            elif cache.allocator.available >= 4:
                live.append(cache.allocator.alloc(rng.randint(1, 4)))
        for g in live:
            cache.allocator.release(g)
    for trial in range(6):
        npos = rng.randint(1, C_LMAX)
        n = src.pages_needed(npos, 1)
        pages = src.allocator.alloc(n)
        _fill_port(src, pages, seed=100 + trial)
        shared = pages[:1] if rng.random() < 0.5 else []
        if shared:
            src.allocator.retain(shared)
        before = (src.allocator.in_use, src.allocator.available)
        grant, got = dst.import_pages(src.export_pages(pages, npos))
        assert got == npos and len(grant) == n
        _assert_same(_tiles_port(src, pages), _tiles_port(dst, grant))
        assert (src.allocator.in_use, src.allocator.available) == before
        for c in (src, dst):
            assert c.allocator.in_use + c.allocator.available \
                == c.allocator.capacity
        dst.allocator.release(grant)
        if shared:
            src.allocator.release(shared)
        src.allocator.release(pages)
    assert src.allocator.available == src.allocator.capacity
    assert dst.allocator.available == dst.allocator.capacity


def test_geometry_mismatch_refused():
    _, src = _caches()
    blob = src.export_pages(src.allocator.alloc(1), 8)
    other = PagedKVCache(tlm.init_lm_params(0, 32, 32, 1, 4, 4, 16,
                                            device="cpu"),
                         ServeConfig(page_size=8, num_pages=9))
    with pytest.raises(FrameError, match="geometry"):
        other.import_pages(blob)
    assert other.allocator.in_use == 0
    _, bf = _caches(dtype="bfloat16")
    with pytest.raises(FrameError, match="geometry"):
        bf.import_pages(blob)                # dtype is geometry too
    assert bf.allocator.in_use == 0


def test_torn_blob_refused():
    _, src = _caches()
    _, dst = _caches()
    blob = src.export_pages(src.allocator.alloc(1), 8)
    for bad in (blob[:-1], blob + b"\x00", b"JUNK" + blob[4:], blob[:3]):
        with pytest.raises(FrameError):
            dst.import_pages(bad)
    assert dst.allocator.in_use == 0


def test_import_out_of_pages_all_or_nothing():
    _, src = _caches()
    _, dst = _caches()
    blob = src.export_pages(src.allocator.alloc(3), 24)
    held = dst.allocator.alloc(6)            # 2 free < 3
    snap = _tiles_port(dst, range(dst.config.num_pages))
    with pytest.raises(OutOfPages):
        dst.import_pages(blob)
    assert dst.allocator.available == 2
    _assert_same(snap, _tiles_port(dst, range(dst.config.num_pages)))
    dst.allocator.release(held)


def test_export_page_math_validated():
    _, src = _caches()
    pages = src.allocator.alloc(2)
    with pytest.raises(FrameError):
        src.export_pages(pages, 8)           # 8 positions need 1 page
    with pytest.raises(FrameError):
        src.export_pages(pages, 0)


# ---------------------------------------------------- engine handoff bay


def _engine(params, clock=None, **cfg):
    kw = dict(CFG, attention="paged")
    kw.update(cfg)
    return ServeEngine(params, ServeConfig(**kw), clock=clock or FakeClock(),
                       device="cpu")


def _park(eng, prompt, new, **kw):
    req = eng.submit(prompt, new, **kw)
    req.prefill_only = True
    for _ in range(100):
        if eng.handoff:
            break
        eng.step()
    return req


def test_handoff_parks_exports_and_decodes_elsewhere(jparams, tparams):
    """A stream prefilled in one engine and decoded in another equals
    lm_decode's and the reference engines' same handoff."""
    p, n = _prompt(0, 13), 9
    peng, deng = _engine(tparams), _engine(tparams)
    req = _park(peng, p, n)
    assert peng.handoff_ready() == [req.rid]
    assert peng.in_flight == 1 and not peng.idle
    assert len(req.output) == 1 and all(s is None for s in peng.slots)
    assert peng.stats()["by_state"] == {"decode": 1}
    held = peng.cache.allocator.in_use
    blob = peng.export_handoff(req.rid)
    assert peng.export_handoff(req.rid) == blob     # repeatable
    assert peng.cache.allocator.in_use == held      # read-only
    assert peng.release_handoff(req.rid) is req
    assert peng.cache.allocator.in_use == 0 and peng.idle
    with pytest.raises(KeyError):
        peng.export_handoff(req.rid)
    req.prefill_only = False
    deng.admit_prefilled(req, blob)
    assert deng.ready == [req] and req.state == "decode"
    deng.run()
    assert req.state == "finished" and req.output == _ref(tparams, p, n)
    # the reference's engines, the same handoff
    jcfg = JServeConfig(**dict(CFG, attention="paged"))
    jpe, jde = JServeEngine(jparams, jcfg), JServeEngine(jparams, jcfg)
    jr = jpe.submit(p, n)
    jr.prefill_only = True
    while not jpe.handoff:
        jpe.step()
    jblob = jpe.export_handoff(jr.rid)
    jpe.release_handoff(jr.rid)
    jr.prefill_only = False
    jde.admit_prefilled(jr, jblob)
    jde.run()
    assert jr.output == req.output
    # the port's blob equals the reference's only where the page tensors
    # hold equal floats: both are float32 but computed by different
    # libraries, so the pin is the stream, not the bytes
    assert len(jblob) == len(blob)


def test_admit_prefilled_is_all_or_nothing(tparams):
    peng = _engine(tparams)
    req = _park(peng, _prompt(1, 11), 6)
    blob = peng.export_handoff(req.rid)
    peng.release_handoff(req.rid)
    deng = _engine(tparams)
    # a blob of another length: a typed refusal, nothing admitted
    wrong = _engine(tparams)
    other = _park(wrong, _prompt(2, 5), 6)
    with pytest.raises(FrameError, match="positions"):
        deng.admit_prefilled(req, wrong.export_handoff(other.rid))
    assert deng.cache.allocator.in_use == 0 and deng.ready == []
    # a full cache: OutOfPages, nothing admitted, nothing leaked
    held = deng.cache.allocator.alloc(deng.cache.allocator.available - 1)
    with pytest.raises(OutOfPages):
        deng.admit_prefilled(req, blob)
    assert deng.cache.allocator.in_use == len(held) and deng.ready == []
    deng.cache.allocator.release(held)
    deng.admit_prefilled(req, blob)
    deng.run()
    assert req.output == _ref(tparams, _prompt(1, 11), 6)


def test_expiry_sweeps_the_handoff_bay(tparams):
    clk = FakeClock()
    eng = _engine(tparams, clock=clk)
    req = _park(eng, _prompt(3, 9), 8, ttl=5.0)
    assert eng.handoff == [req] and eng.cache.allocator.in_use > 0
    clk.t += 10.0
    eng.step()
    assert eng.handoff == [] and eng.timed_out == [req]
    assert req.state == "timeout" and eng.cache.allocator.in_use == 0
    assert eng.idle


# --------------------------------------------- the in-process disagg fleet


SPEC = [(5, 8), (9, 6), (3, 10), (7, 7), (4, 9), (6, 5)]


def _fleet(Fleet, Cfg, FCfg, params, pools, kw):
    clk = FakeClock()
    fl = Fleet(params, Cfg(**CFG), FCfg(replicas=2, backoff_base=0.01,
                                        max_restarts=2, pools=pools),
               clock=clk, sleep=clk.sleep, **kw)
    return fl, clk


def _run(fl, clk, spec, temps=None, base=0, fault=None):
    if fault:
        fl.disagg.fault_next_transfer = fault
    reqs = [fl.submit(_prompt(base + i, lp), n,
                      temperature=(temps[i] if temps else 0.0),
                      seed=23 + i)
            for i, (lp, n) in enumerate(spec)]
    guard = 0
    while not fl.idle:
        fl.step()
        clk.t += 0.001
        guard += 1
        assert guard < 5000, "fleet failed to drain"
    return reqs


def _both(jparams, tparams, pools=POOLS, fault=None, spec=SPEC, base=0):
    """The same submissions through the JAX fleet and the port's."""
    out = []
    for Fleet, Cfg, FCfg, params, kw in (
            (JServeFleet, JServeConfig, JFleetConfig, jparams, {}),
            (ServeFleet, ServeConfig, FleetConfig, tparams,
             {"device": "cpu"})):
        fl, clk = _fleet(Fleet, Cfg, FCfg, params, pools, kw)
        try:
            reqs = _run(fl, clk, spec, base=base, fault=fault)
            out.append((reqs, fl.stats(), fl))
        finally:
            fl.close()
    return out


@pytest.fixture(scope="module")
def clean(jparams, tparams):
    return _both(jparams, tparams)


def test_disagg_fleet_streams_and_placements_match_the_reference(
        clean, tparams):
    (jreqs, jst, _), (treqs, tst, _) = clean
    for i, (rj, rt) in enumerate(zip(jreqs, treqs)):
        assert rt.state == rj.state == "finished"
        assert rt.output == rj.output == _ref(
            tparams, _prompt(i, SPEC[i][0]), SPEC[i][1]), i
        assert rt.replica == rj.replica == 1   # finished decode-side
        assert rt.prefill_only is False and rt.redispatches == 0
    assert tst["by_state"] == jst["by_state"] == {"finished": len(SPEC)}
    roles = {c["id"]: c["role"] for c in tst["fleet"]["per_replica"]}
    assert roles == {0: "prefill", 1: "decode"}


def test_disagg_fleet_transfer_counts_match_the_reference(clean):
    (_, jst, _), (_, tst, tfl) = clean
    jd, td = jst["fleet"]["disagg"], tst["fleet"]["disagg"]
    assert set(td) == set(jd)
    for key in ("pools", "transfers", "kv_bytes_shipped",
                "chunks_shipped", "parked", "failures"):
        assert td[key] == jd[key], key
    assert td["transfers"] == len(SPEC) and td["parked"] == 0
    assert td["failures"] == {}
    assert td["transfer_ms_p50"] is not None
    # kv_bytes_shipped is the sum of the blobs the geometry gives
    tile = CFG["page_size"] * H * DH * 4
    want = 0
    for lp, _ in SPEC:
        header = len(('{"layers": %d, "page_size": %d, "heads": %d, '
                      '"head_dim": %d, "dtype": "float32", "pages": %d, '
                      '"positions": %d}') % (LAYERS, 8, H, DH,
                                             -(-lp // 8), lp))
        want += 8 + header + LAYERS * 2 * -(-lp // 8) * tile
    assert td["kv_bytes_shipped"] == want
    # the prefill replica's slots and bay are empty once idle
    peng = tfl.replicas[0].engine
    assert all(s is None for s in peng.slots) and peng.handoff == []


def test_colocated_fleet_stamps_no_disagg_block(jparams, tparams):
    (jr, jst, _), (tr, tst, _) = _both(jparams, tparams, pools=None,
                                       spec=SPEC[:2])
    assert tst["fleet"]["disagg"] is None and jst["fleet"]["disagg"] is None
    assert [r.output for r in tr] == [r.output for r in jr]
    assert all(c["role"] is None for c in tst["fleet"]["per_replica"])


@pytest.mark.parametrize("side", ["prefill", "decode"])
def test_transfer_tears_recover_as_the_reference(clean, jparams, tparams,
                                                 side):
    (jtorn, jst, jfl), (ttorn, tst, tfl) = _both(
        jparams, tparams, fault=side, spec=SPEC[:4])
    for i, (rj, rt, rc) in enumerate(zip(jtorn, ttorn, clean[1][0])):
        assert rt.state == rj.state == "finished", i
        assert rt.output == rj.output == rc.output, i
        assert rt.replica == rj.replica
    jf, tf = jst["fleet"], tst["fleet"]
    for key in ("incidents_by_class", "redispatched", "tokens_recomputed",
                "restarts_used"):
        assert tf[key] == jf[key], key
    for key in ("transfers", "kv_bytes_shipped", "chunks_shipped",
                "failures", "parked"):
        assert tf["disagg"][key] == jf["disagg"][key], key
    assert tf["disagg"]["failures"] == {side: 1}
    assert tfl.disagg.fault_next_transfer is None   # one-shot
    assert [r.role for r in tfl.replicas] == ["prefill", "decode"]
    if side == "decode":
        # the request stayed parked prefill-side and re-exported the
        # same bytes: nothing requeued, every request crossed once
        assert tf["redispatched"] == 0
        assert all(r.redispatches == 0 and not r.requeued for r in ttorn)
        assert tf["disagg"]["transfers"] == 4
    else:
        assert tf["redispatched"] >= 1
        assert tf["tokens_recomputed"] > 0
        assert sum(r.redispatches for r in ttorn) <= 4


def test_pools_scheduled_independently(tparams):
    fl, clk = _fleet(ServeFleet, ServeConfig, FleetConfig, tparams, POOLS,
                     {"device": "cpu"})
    try:
        seen = []
        real = fl.replicas[1].engine.scheduler.submit

        def spy(req):
            seen.append(req)
            return real(req)

        fl.replicas[1].engine.scheduler.submit = spy
        reqs = _run(fl, clk, [(5, 4), (8, 3), (4, 5), (6, 4), (3, 6)],
                    base=50)
        assert seen == []               # no admission on the decode pool
        assert all(r.state == "finished" and r.replica == 1 for r in reqs)
        assert fl.stats()["fleet"]["disagg"]["transfers"] == 5
    finally:
        fl.close()


def test_sampled_streams_colocated_equal_disaggregated(tparams):
    temps = [0.0, 0.9, 0.0, 0.7]
    outs = []
    for pools in (None, POOLS):
        fl, clk = _fleet(ServeFleet, ServeConfig, FleetConfig, tparams,
                         pools, {"device": "cpu"})
        try:
            outs.append([r.output for r in _run(fl, clk, SPEC[:4],
                                                temps=temps, base=80)])
        finally:
            fl.close()
    assert outs[0] == outs[1]
