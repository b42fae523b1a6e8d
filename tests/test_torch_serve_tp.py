"""The port's tensor-parallel serving engine (``ServeConfig.mesh``) in 2-
and 4-rank gloo worlds, against the JAX package's ``mesh="dp=1,tp=4"``
engine and the port's own tp=1 engine.

A small model (2 layers, 4 heads of 4, MLP 32, vocab 64, 64 positions;
numpy-seeded weights carried to both packages). One gloo world per size
(started once for the module, as tests/test_torch_tp.py starts its
worlds, the 2-rank world first) runs every case: rank 0 serves, the
others ``follow()``; the JAX engines run in this process on
tests/conftest.py's virtual CPU mesh (its gather mode: the JAX tests pin
its paged mode equal to it).

* Greedy streams, requests joining mid-flight, in both attention modes:
  equal to the JAX TP engine's and the port's tp=1 engine's; so with
  speculation at k=2 (a one-layer draft), and with the prefix cache (a
  hit on a 16-token system prompt) plus a copy-on-write forced through
  the engine's guard, whose copy lands on every rank's head shard.
* Each rank's page tensors are its own ``[P, ps, H/tp, D]`` tensors,
  equal (rtol/atol 1e-5, float32 summation order) to the JAX engine's
  head slice of the same pages (the null page 0 aside: the port writes
  idle slots' rows there, the JAX engine drops them); every rank runs
  the same lane ticks; ``kv_bytes_per_chip`` is the tp=1 figure over tp.
* A weight swap (``update_params``) on a served engine with the prefix
  cache on: the streams after it equal the JAX TP engine's and the
  port's tp=1 engine's after theirs, the index is flushed, and the busy
  and geometry refusals carry the JAX engine's messages.
* The HVKV blob of a head-sharded cache: a TP engine's handoff blob has
  the JAX TP engine's framing bytes exactly and its tiles within
  ``PAGE_TOL``; it decodes on the TP engine itself and on a tp=1 engine
  (tiles bit for bit) with the tp=1 stream; a tp=1 blob, and in the
  4-rank world the 2-rank world's blob, land on every rank as the
  blob's head slice bit for bit; a blob of another geometry is refused
  with no state change.
* Every refusal: a mesh that is not the world, heads or vocab that do
  not split, ``capture=True`` over gloo, the sharded cache's own export
  and import (the group takes part through the engine), control-plane
  calls on a follower, an in-process fleet of TP engines, and
  ``follow()`` on a controller or an unsharded engine.
* ``serve_bench --mesh dp=1,tp=N --ab-tp``'s record: ``serve.tp``
  (degree, backend, per-chip bytes, the exact pin), ``per_card`` and
  ``config.mesh``; the followers print nothing.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeEngine as JServeEngine
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.serve import ServeConfig, ServeEngine
from horovod_tpu_torch.serve.scheduler import make_request
from test_torch_tp import start_world

WORLDS = [2, 4]
V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 4, 4, 32
PAGE_TOL = dict(rtol=1e-5, atol=1e-5)
SB_FLAGS = ["--layers", "2", "--d-model", "16", "--heads", "4",
            "--vocab", "64", "--requests", "5", "--rate", "200",
            "--prompt-min", "4", "--prompt-max", "12", "--new-min", "2",
            "--new-max", "6", "--decode-slots", "2", "--prefill-chunk", "4",
            "--page-size", "8", "--attention", "paged", "--capture", "off",
            "--pin-exact", "--require-finished"]

# Scenarios: ServeConfig fields and waves of ((prompt id, length,
# max_new), ...), each followed by that many steps before the next wave.
SCENARIOS = {
    "staggered": (dict(page_size=8, num_pages=40, decode_slots=2,
                       prefill_chunk=4),
                  [(((10, 5, 6), (11, 9, 4)), 3),
                   (((12, 3, 12), (13, 13, 3)), 2),
                   (((14, 7, 1), (15, 4, 8)), 0)]),
    "spec": (dict(page_size=8, num_pages=40, decode_slots=2,
                  prefill_chunk=4, speculate_k=2, draft_layers=1),
             [(((70, 5, 9), (71, 9, 6)), 2), (((72, 3, 11),), 0)]),
}
PREFIX_CFG = dict(page_size=8, num_pages=32, decode_slots=1,
                  prefill_chunk=8, prefix_caching=True)
# The weight swap: the staggered waves on a prefix-caching engine, a
# swap to the weights of numpy seed SWAP_SEED, the waves again.
SWAP_CFG = dict(SCENARIOS["staggered"][0], prefix_caching=True)
SWAP_SEED = 22
# The handoff request (prompt id, length, max_new): two pages of 8.
HANDOFF_CFG = dict(page_size=8, num_pages=40, decode_slots=2,
                   prefill_chunk=4)
HANDOFF = (80, 13, 6)
#: The environment variable naming the 2-rank world's handoff blob for
#: the 4-rank world to import.
FOREIGN = "HVD_TEST_SERVE_TP_BLOB"


def _params(seed=21):
    rng = np.random.default_rng(seed)
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


def _prompt(i, lp):
    return np.random.default_rng(1000 + i).integers(0, V, lp).astype(
        np.int32)


def _system():
    return _prompt(61, 16)


def _serve(eng, waves):
    """Submit the waves on a controller (or an unsharded engine), drain;
    the requests in order."""
    reqs = []
    for wave, steps in waves:
        reqs += [eng.submit(_prompt(i, lp), n) for i, lp, n in wave]
        for _ in range(steps):
            eng.step()
    eng.run()
    return reqs


def _prefix_serve(eng):
    """Two requests sharing the system prompt, the second a prefix hit;
    once the hit is decoding, a copy-on-write of its first (shared)
    page is forced through the engine's guard. Returns the requests and
    the ``(old, new)`` page pair."""
    sys_p = _system()
    first = eng.submit(np.concatenate([sys_p, _prompt(62, 3)]), 4)
    eng.run()
    second = eng.submit(np.concatenate([sys_p, _prompt(63, 3)]), 4)
    while second.state != "decode" or second not in eng.slots:
        eng.step()
    old = int(second.page_table[0])
    assert eng.cache.allocator.is_shared(old)
    eng._cow_range(second, 0, 0)
    new = int(second.page_table[0])
    eng.run()
    return [first, second], (old, new)


def _pages(eng):
    return [{kv: layer[kv].numpy().copy() for kv in ("k", "v")}
            for layer in eng.cache.pages]


def _swap(eng, new):
    """On a controller (or an unsharded engine, of either package): the
    staggered waves, the busy and geometry refusals, the swap to
    ``new``, the waves again."""
    waves = SCENARIOS["staggered"][1]
    before = [r.output for r in _serve(eng, waves)]
    entries = eng.prefix_stats()["entries"]
    eng.submit(_prompt(0, 3), 2)
    errors = {"busy": _error(lambda: eng.update_params(new))}
    eng.run()
    errors["geometry"] = _error(lambda: eng.update_params(
        dict(new, pos=new["pos"][:LMAX // 2])))
    eng.update_params(new)
    flushed = eng.prefix_stats()["entries"]
    after = [r.output for r in _serve(eng, waves)]
    return {"before": before, "after": after, "errors": errors,
            "entries": entries, "flushed": flushed}


def _park(eng, i, lp, n):
    """A prefill-only request parked in the handoff bay."""
    req = eng.submit(_prompt(i, lp), n)
    req.prefill_only = True
    while not eng.handoff:
        eng.step()
    return req


def _prefilled(eng, like):
    """A request as a decode replica receives ``like`` (its first token
    emitted on the prefill side)."""
    req = make_request(eng.config, eng.clock, like.prompt,
                       like.max_new_tokens)
    req.generated = [like.output[0]]
    req.output = list(req.generated)
    return req


def _payload(blob):
    """A blob's framing bytes and its tiles ``[L, 2, n, ps, H, D]``."""
    end = 8 + int.from_bytes(blob[4:8], "big")
    n = len(blob[end:]) // (LAYERS * 2 * 8 * H * DH * 4)
    return blob[:end], np.frombuffer(blob[end:], np.float32).reshape(
        LAYERS, 2, n, 8, H, DH)


def _handoff(eng, params, foreign):
    """On a TP controller (paged, HANDOFF_CFG): the handoff request
    parked, exported twice and released; its blob admitted back and
    decoded (TP -> TP); the same blob into a tp=1 engine (tiles read
    back, decoded); a blob of another geometry refused; then the tp=1
    engine's blob and ``foreign`` admitted and left undecoded, for the
    ranks' pages to show their head slices."""
    i, lp, n = HANDOFF
    req = _park(eng, i, lp, n)
    blob = eng.export_handoff(req.rid)
    out = {"blob": blob, "again": eng.export_handoff(req.rid)}
    eng.release_handoff(req.rid)
    req.prefill_only = False
    eng.admit_prefilled(req, blob)
    eng.run()
    out["stream_tp"] = req.output
    single = ServeEngine(params, ServeConfig(attention="paged",
                                             **HANDOFF_CFG), device="cpu")
    r1 = _park(single, i, lp, n)
    out["blob1"] = single.export_handoff(r1.rid)
    single.release_handoff(r1.rid)
    r1.prefill_only = False
    single.admit_prefilled(r1, blob)
    ids = torch.tensor(r1.pages[:2], dtype=torch.int32)
    out["single_tiles"] = single.cache.read_tiles(ids).numpy()
    single.run()
    out["stream_1"] = r1.output
    bad = out["blob1"].replace(b'"page_size": 8', b'"page_size": 4')
    avail, ready = eng.cache.allocator.available, list(eng.ready)
    out["mismatch"] = _error(lambda: eng.admit_prefilled(
        _prefilled(eng, req), bad))
    out["unchanged"] = (eng.cache.allocator.available == avail
                        and eng.ready == ready)
    grants = {}
    for name, b in (("tp1", out["blob1"]), ("foreign", foreign)):
        if b is not None:
            r = _prefilled(eng, req)
            eng.admit_prefilled(r, b)
            grants[name] = r.pages[:2]
    out["grants"] = grants
    return out


def _error(fn):
    try:
        fn()
    except Exception as e:              # noqa: BLE001 - reported
        return type(e).__name__, str(e)
    return None


def _errors(n, params):
    """The refusals that need the world (construction checks are
    collective: every rank runs them), and the TP engine's own calls:
    the controller swaps weights, finds no parked request to export and
    refuses a torn blob; a follower refuses them all."""
    cfg = dict(page_size=8, num_pages=16, decode_slots=1, prefill_chunk=4)
    mesh = f"dp=1,tp={n}"
    out = {
        "world": _error(lambda: ServeEngine(params, ServeConfig(
            mesh=f"dp=1,tp={n + 1}", **cfg), device="cpu", capture=False)),
        "heads": _error(lambda: ServeEngine(
            tlm.init_lm_params(0, 8 * n, 16, 1, n + 1, 4, 8 * n,
                               device="cpu"),
            ServeConfig(mesh=mesh, **cfg), device="cpu",
            capture=False)),
        "vocab": _error(lambda: ServeEngine(
            tlm.init_lm_params(0, 4 * n + 1, 16, 1, n, 4, 8 * n,
                               device="cpu"),
            ServeConfig(mesh=mesh, **cfg), device="cpu",
            capture=False)),
        "capture": _error(lambda: ServeEngine(
            params, ServeConfig(mesh=mesh, **cfg), device="cpu",
            capture=True)),
    }
    eng = ServeEngine(params, ServeConfig(mesh=mesh, **cfg),
                      device="cpu", capture=False)
    out["cache_export"] = _error(lambda: eng.cache.export_pages([1], 3))
    out["cache_import"] = _error(lambda: eng.cache.import_pages(b"HVKV"))
    req = make_request(eng.config, eng.clock, _prompt(0, 3), 2)
    out["update_params"] = _error(lambda: eng.update_params(params))
    out["export"] = _error(lambda: eng.export_handoff(7))
    out["import"] = _error(lambda: eng.admit_prefilled(req, b"HVKV"))
    if eng.is_controller:
        out["follow"] = _error(eng.follow)
        eng.close()
        out["after_close"] = _error(lambda: eng.submit(_prompt(0, 3), 2))
    else:
        out["submit"] = _error(lambda: eng.submit(_prompt(0, 3), 2))
        out["step"] = _error(eng.step)
        eng.follow()
    return out


def _worker(rank, n, init, out):
    import torch.distributed as dist

    from horovod_tpu_torch import serve_bench as sb

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    params = tlm.params_from_numpy(_params(), device="cpu")
    mesh = f"dp=1,tp={n}"
    res = {}
    for name, (cfg, waves) in SCENARIOS.items():
        for attention in ("gather", "paged"):
            eng = ServeEngine(params, ServeConfig(
                attention=attention, mesh=mesh, **cfg), device="cpu",
                capture=False)
            if eng.is_controller:
                reqs = _serve(eng, waves)
                eng.close()
                got = {"streams": [r.output for r in reqs],
                       "states": [r.state for r in reqs],
                       "stats": eng.stats(), "steps": eng.steps}
            else:
                got = {"steps": eng.follow()}
            got.update(pages=_pages(eng), ticks=eng.lane_ticks,
                       contiguous=all(t.is_contiguous()
                                      for layer in eng.cache.pages
                                      for t in layer.values()))
            res[(name, attention)] = got
    eng = ServeEngine(params, ServeConfig(attention="paged", mesh=mesh,
                                          **PREFIX_CFG),
                      device="cpu", capture=False)
    if eng.is_controller:
        reqs, pair = _prefix_serve(eng)
        eng.close()
        got = {"streams": [r.output for r in reqs], "pair": pair,
               "prefix": eng.prefix_stats()}
    else:
        eng.follow()
        got = {}
    got["pages"] = _pages(eng)
    res["prefix"] = got
    pair = [got.get("pair")]
    dist.broadcast_object_list(pair, src=0)
    res["prefix"]["pair"] = tuple(pair[0])
    eng = ServeEngine(params, ServeConfig(attention="paged", mesh=mesh,
                                          **SWAP_CFG),
                      device="cpu", capture=False)
    if eng.is_controller:
        got = _swap(eng, tlm.params_from_numpy(_params(SWAP_SEED),
                                               device="cpu"))
        eng.close()
        got["steps"] = eng.steps
    else:
        got = {"steps": eng.follow()}
    res["swap"] = dict(got, ticks=eng.lane_ticks)
    foreign = os.environ.get(FOREIGN)
    if foreign is not None:
        with open(foreign, "rb") as f:
            foreign = f.read()
    eng = ServeEngine(params, ServeConfig(attention="paged", mesh=mesh,
                                          **HANDOFF_CFG),
                      device="cpu", capture=False)
    if eng.is_controller:
        got = _handoff(eng, params, foreign)
        eng.close()
        with open(os.path.join(out, "blob_tp.bin"), "wb") as f:
            f.write(got["blob"])
    else:
        eng.follow()
        got = {}
    got["pages"] = _pages(eng)
    res["handoff"] = got
    res["errors"] = _errors(n, params)
    args = sb.build_parser().parse_args(
        SB_FLAGS + ["--mesh", mesh, "--ab-tp"])
    res["bench"] = sb.run(args, device="cpu")
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, the 2-rank one first: the 4-rank world imports its
    handoff blob (named by the ``FOREIGN`` variable)."""
    out, env = {}, None
    for n in WORLDS:
        d = str(tmp_path_factory.mktemp(f"stp{n}"))
        out[n] = start_world(n, d, "test_torch_serve_tp", timeout=240,
                             env=env)
        env = dict(os.environ, **{FOREIGN: os.path.join(d, "blob_tp.bin")})
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"tp{n}")
def world(request, worlds):
    return request.param, worlds[request.param]


# ------------------------------------------------------- the references


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(jnp.asarray, _params())


@pytest.fixture(scope="module")
def jax_tp(jparams):
    """The JAX ``mesh="dp=1,tp=4"`` engine (gather) over every scenario:
    streams, and the page arrays of the staggered one."""
    out = {}
    for name, (cfg, waves) in SCENARIOS.items():
        eng = JServeEngine(jparams, JServeConfig(mesh="dp=1,tp=4", **cfg))
        reqs = _serve(eng, waves)
        out[name] = [r.output for r in reqs]
        if name == "staggered":
            out["pages"] = [{kv: np.asarray(layer[kv]) for kv in ("k", "v")}
                            for layer in eng.cache.pages]
    eng = JServeEngine(jparams, JServeConfig(mesh="dp=1,tp=4",
                                             **PREFIX_CFG))
    sys_p = _system()
    reqs = [eng.submit(np.concatenate([sys_p, _prompt(62, 3)]), 4)]
    eng.run()
    reqs.append(eng.submit(np.concatenate([sys_p, _prompt(63, 3)]), 4))
    eng.run()
    out["prefix"] = [r.output for r in reqs]
    out["swap"] = _swap(
        JServeEngine(jparams, JServeConfig(mesh="dp=1,tp=4", **SWAP_CFG)),
        jax.tree_util.tree_map(jnp.asarray, _params(SWAP_SEED)))
    eng = JServeEngine(jparams, JServeConfig(mesh="dp=1,tp=4",
                                             **HANDOFF_CFG))
    out["blob"] = eng.export_handoff(_park(eng, *HANDOFF).rid)
    return out


@pytest.fixture(scope="module")
def tp1():
    """The port's tp=1 engine over every scenario, both modes."""
    params = tlm.params_from_numpy(_params(), device="cpu")
    out = {}
    for name, (cfg, waves) in SCENARIOS.items():
        for attention in ("gather", "paged"):
            eng = ServeEngine(params, ServeConfig(attention=attention,
                                                  **cfg), device="cpu")
            out[(name, attention)] = (
                [r.output for r in _serve(eng, waves)], eng.stats())
    eng = ServeEngine(params, ServeConfig(attention="paged", **PREFIX_CFG),
                      device="cpu")
    reqs, _ = _prefix_serve(eng)
    out["prefix"] = [r.output for r in reqs]
    out["swap"] = _swap(
        ServeEngine(params, ServeConfig(attention="paged", **SWAP_CFG),
                    device="cpu"),
        tlm.params_from_numpy(_params(SWAP_SEED), device="cpu"))
    eng = ServeEngine(params, ServeConfig(attention="paged", **HANDOFF_CFG),
                      device="cpu")
    req = eng.submit(_prompt(HANDOFF[0], HANDOFF[1]), HANDOFF[2])
    eng.run()
    out["handoff"] = req.output
    return out


# -------------------------------------------------------------- streams


@pytest.mark.parametrize("attention", ["gather", "paged"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_streams_equal_the_jax_tp_engine_and_tp1(world, jax_tp, tp1,
                                                    name, attention):
    n, ranks = world
    r0 = ranks[0][(name, attention)]
    assert all(s == "finished" for s in r0["states"])
    assert r0["streams"] == jax_tp[name]
    assert r0["streams"] == tp1[(name, attention)][0]
    if name == "spec":
        sp = r0["stats"]["spec"]
        assert sp["k"] == 2 and sp["draft_layers"] == 1 and sp["ticks"] > 0
    # Every rank ran the same lanes; the followers stepped with rank 0.
    assert {res[(name, attention)]["ticks"] for res in ranks} == {
        r0["ticks"]}
    assert r0["ticks"] > 0
    for res in ranks[1:]:
        assert res[(name, attention)]["steps"] == r0["steps"]


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_kv_bytes_per_chip_is_the_tp1_figure_over_tp(world, tp1,
                                                     attention):
    n, ranks = world
    got = ranks[0][("staggered", attention)]["stats"]["attention"]
    want = tp1[("staggered", attention)][1]["attention"]
    assert got["tp"] == n and want["tp"] == 1
    assert got["decode_steps"] == want["decode_steps"]
    for key in ("kv_bytes_per_step_paged", "kv_bytes_per_step_gather",
                "pages_live_per_step_mean"):
        assert got[key] == want[key], key
    # Both figures are rounded to 0.1 byte a step.
    assert got["kv_bytes_per_chip"] == pytest.approx(
        want["kv_bytes_per_chip"] / n, abs=0.1)


def test_prefix_hit_and_cow_land_on_every_shard(world, jax_tp, tp1):
    n, ranks = world
    r0 = ranks[0]["prefix"]
    assert r0["streams"] == jax_tp["prefix"] == tp1["prefix"]
    assert r0["prefix"]["hits"] == 1 and r0["prefix"]["cow_copies"] == 1
    old, new = r0["pair"]
    assert old != new
    for res in ranks:
        pages = res["prefix"]["pages"]
        assert res["prefix"]["pair"] == (old, new)
        for layer in pages:
            for kv in ("k", "v"):
                assert np.abs(layer[kv][old]).max() > 0
                np.testing.assert_array_equal(layer[kv][new],
                                              layer[kv][old])


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_page_shards_equal_the_jax_head_slices(world, jax_tp, attention):
    n, ranks = world
    hl = H // n
    for r, res in enumerate(ranks):
        got = res[("staggered", attention)]
        assert got["contiguous"]
        for mine, full in zip(got["pages"], jax_tp["pages"]):
            for kv in ("k", "v"):
                assert mine[kv].shape == (40, 8, hl, DH)
                np.testing.assert_allclose(
                    mine[kv][1:], full[kv][1:, :, r * hl:(r + 1) * hl],
                    **PAGE_TOL)


# ------------------------------------------------------------ refusals


def test_refusals_in_the_world(world):
    n, ranks = world
    for r, res in enumerate(ranks):
        e = res["errors"]
        assert e["world"][0] == "InvalidArgumentError"
        assert f"spans {n + 1} rank(s)" in e["world"][1]
        assert e["heads"][0] == "InvalidArgumentError"
        assert "num_heads" in e["heads"][1]
        assert e["vocab"][0] == "InvalidArgumentError"
        assert "vocab" in e["vocab"][1]
        assert e["capture"][0] == "InvalidArgumentError"
        assert "gloo collectives cannot be captured" in e["capture"][1]
        for key in ("cache_export", "cache_import"):
            assert e[key][0] == "InvalidArgumentError", key
            assert "go through the engine" in e[key][1], key
        if r == 0:
            # The controller swaps weights, has no parked request 7 and
            # refuses a torn blob before any page moves.
            assert e["update_params"] is None
            assert e["export"][0] == "KeyError"
            assert e["import"][0] == "FrameError"
            assert e["follow"][0] == "PreconditionError"
            assert e["after_close"][0] == "PreconditionError"
        else:
            for key in ("update_params", "export", "import", "submit",
                        "step"):
                assert e[key][0] == "PreconditionError", key


def test_refusals_without_a_world():
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError
    from horovod_tpu_torch.serve import FleetConfig, ServeFleet

    params = tlm.params_from_numpy(_params(), device="cpu")
    cfg = dict(page_size=8, num_pages=16, decode_slots=1, prefill_chunk=4)
    # capture=True (the default) over no world: the mesh is not the
    # world, which is checked before the group's backend can be (the
    # gloo refusal is pinned in the worlds).
    with pytest.raises(InvalidArgumentError, match="world has 1"):
        ServeEngine(params, ServeConfig(mesh="dp=1,tp=4", **cfg),
                    device="cpu")
    with pytest.raises(InvalidArgumentError, match="world has 1"):
        ServeEngine(params, ServeConfig(mesh="dp=1,tp=2", **cfg),
                    device="cpu", capture=False)
    for pools in (None, {"prefill": 1, "decode": 1}):
        with pytest.raises(InvalidArgumentError,
                           match="transport='inproc'.*'process' or 'tcp'"):
            ServeFleet(params, ServeConfig(mesh="dp=1,tp=2", **cfg),
                       FleetConfig(pools=pools), device="cpu")
    single = ServeEngine(params, ServeConfig(mesh="dp=1,tp=1", **cfg),
                         device="cpu")
    assert single.tp == 1 and single.is_controller
    with pytest.raises(Exception, match="not tensor-parallel"):
        single.follow()
    single.close()        # nothing to release


@pytest.mark.parametrize("bad", ["garbage", "dp=2,tp=2", "dp=1,tp=-1",
                                 "tp=0", ""])
def test_bad_mesh_strings_raise_as_the_jax_config(bad):
    with pytest.raises(ValueError) as want:
        JServeConfig(page_size=8, num_pages=16, decode_slots=1,
                     prefill_chunk=4, mesh=bad)
    with pytest.raises(ValueError) as got:
        ServeConfig(page_size=8, num_pages=16, decode_slots=1,
                    prefill_chunk=4, mesh=bad)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# --------------------------------------------------------- weight swap


def test_update_params_streams_equal_the_jax_tp_engine_and_tp1(
        world, jax_tp, tp1):
    n, ranks = world
    got = ranks[0]["swap"]
    assert got["before"] == tp1["swap"]["before"]
    assert got["after"] == jax_tp["swap"]["after"] == tp1["swap"]["after"]
    assert got["after"] != got["before"]
    # The followers ran every step of both waves with the controller.
    assert {res["swap"]["ticks"] for res in ranks} == {got["ticks"]}
    for res in ranks[1:]:
        assert res["swap"]["steps"] == got["steps"]


def test_update_params_refusals_keep_the_jax_messages(world, jax_tp):
    n, ranks = world
    got, want = ranks[0]["swap"]["errors"], jax_tp["swap"]["errors"]
    assert got["busy"][0] == "RuntimeError"
    assert got["geometry"][0] == "ValueError"
    assert got == want


def test_update_params_flushes_the_prefix_index(world, jax_tp):
    n, ranks = world
    got = ranks[0]["swap"]
    assert got["entries"] > 0 and got["flushed"] == 0
    assert (jax_tp["swap"]["entries"], jax_tp["swap"]["flushed"]) == (
        got["entries"], 0)


# ------------------------------------------------------- the HVKV blob


def test_handoff_blob_framing_equals_the_jax_tp_engine(world, jax_tp):
    n, ranks = world
    got = ranks[0]["handoff"]
    assert got["again"] == got["blob"]              # repeatable
    frame, tiles = _payload(got["blob"])
    jframe, jtiles = _payload(jax_tp["blob"])
    assert frame == jframe
    np.testing.assert_allclose(tiles, jtiles, **PAGE_TOL)
    # The port's tp=1 blob of the same request frames the same way.
    frame1, tiles1 = _payload(got["blob1"])
    assert frame1 == frame
    np.testing.assert_allclose(tiles1, tiles, **PAGE_TOL)


def test_blob_decodes_across_tp_degrees(world, tp1):
    n, ranks = world
    got = ranks[0]["handoff"]
    want = tp1["handoff"]
    assert got["stream_tp"] == want                 # tp=N -> tp=N
    assert got["stream_1"] == want                  # tp=N -> tp=1
    # The tp=1 engine's pages hold the blob's tiles bit for bit.
    np.testing.assert_array_equal(got["single_tiles"],
                                  _payload(got["blob"])[1])


@pytest.mark.parametrize("source", ["tp1", "foreign"])
def test_each_rank_holds_the_blobs_head_slice(world, worlds, source):
    """tp=1 -> tp=N, and the 2-rank world's blob -> tp=4: rank r's
    imported pages are the blob's heads r*H/N onward, bit for bit."""
    n, ranks = world
    got = ranks[0]["handoff"]
    if source == "tp1":
        blob = got["blob1"]
    else:
        blob = worlds[2][0]["handoff"]["blob"]
        assert ("foreign" in got["grants"]) == (n == 4)
        if n == 2:
            return
    grant = got["grants"][source]
    tiles = _payload(blob)[1]
    hl = H // n
    for r, res in enumerate(ranks):
        pages = res["handoff"]["pages"]
        for layer, lt in zip(pages, tiles):
            for kv, t in zip(("k", "v"), lt):
                np.testing.assert_array_equal(
                    layer[kv][grant], t[..., r * hl:(r + 1) * hl, :])


def test_mismatched_blob_is_refused_with_no_state_change(world):
    n, ranks = world
    got = ranks[0]["handoff"]
    assert got["mismatch"][0] == "FrameError"
    assert "geometry" in got["mismatch"][1]
    assert got["unchanged"]


# ---------------------------------------------------------- serve_bench


def test_serve_bench_ab_tp_record(world):
    n, ranks = world
    rec = ranks[0]["bench"]
    assert all(res["bench"] is None for res in ranks[1:])
    assert rec["metric"] == "serve_ab_tp_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "ab_tp" and s["by_state"] == {"finished": 5}
    tp = s["tp"]
    assert tp["degree"] == n and tp["backend"] == "gloo"
    assert tp["mesh"] == f"dp=1,tp={n}"
    assert tp["exact_pin"] == {"compared": 5, "identical": True}
    assert tp["kv_bytes_per_chip"] <= tp["kv_bytes_per_chip_single"] / n \
        * 1.001
    assert s["attention"]["tp"] == n
    assert tp["single"]["attention"]["tp"] == 1
    assert rec["per_card"]["cards"] == 1
    assert set(rec["per_card"]["tokens_per_sec"]) == {"tp", "tp1"}
    assert rec["config"]["mesh"] == f"dp=1,tp={n}"
    assert rec["config"]["capture"] == "off"
