"""The port's continuous-batching engine against the JAX ``ServeEngine``.

The same weights (JAX ``init_lm_params``, carried across with
``params_from_numpy``) and the same prompts (numpy seed) go through the
JAX engine and the port's engine on the CPU; every greedy stream must be
equal, and equal to the port's own ``lm_decode``, across the matrix of
tests/test_serve_engine.py: chunk sizes 1/3/4/16, staggered joins,
lazy-admission eviction-recompute, ``max_new=1`` — in both attention
modes of the port. (The JAX engine runs its gather mode; its paged mode
is pinned equal to it by tests/test_serve_engine.py.) The per-step
decode-traffic accounting must equal the JAX engine's too.

Besides: the refcounted ``PageAllocator`` against the JAX one, same-seed
sampling determinism, lifecycle edges (EOS, rejects, deadlines, weight
swaps), the fixed-shape decode lane's idle-slot writes (page 0 only),
config parity (``mesh`` builds the JAX config's axes and a TP fleet
raises; the speculative and prefix knobs build the JAX config's fields), a ``device=None`` engine raising without
CUDA,
and an AST scan proving that nothing in ``horovod_tpu_torch/`` or
``chip_smoke.py`` imports ``jax`` or ``horovod_tpu`` (the interpreter
imports jax at startup here, so ``sys.modules`` cannot show it).
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.serve import ServeConfig as JServeConfig
from horovod_tpu.serve import ServeEngine as JServeEngine
from horovod_tpu.serve.kvcache import PageAllocator as JPageAllocator
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.ops import paged_attention as tpa
from horovod_tpu_torch.serve import (OutOfPages, PageAllocator,
                                     ServeConfig, ServeEngine)

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 4, 4, 32
REPO = pathlib.Path(__file__).resolve().parent.parent


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


# Each scenario: engine config + waves of (prompt id, prompt len,
# max_new) submitted together, then `steps` engine steps before the next
# wave; the engine then drains.
_CHUNK = dict(page_size=8, num_pages=32, decode_slots=1)
SCENARIOS = {
    **{f"chunk{c}": dict(cfg=dict(_CHUNK, prefill_chunk=c),
                         waves=[([(1, 11, 5)], 0)]) for c in (1, 3, 4, 16)},
    "staggered": dict(
        cfg=dict(page_size=8, num_pages=40, decode_slots=2,
                 prefill_chunk=4),
        waves=[([(10, 5, 6), (11, 9, 4)], 3),
               ([(12, 3, 12), (13, 13, 3)], 2),
               ([(14, 7, 1), (15, 4, 8)], 0)]),
    "eviction": dict(
        cfg=dict(page_size=4, num_pages=8, decode_slots=2,
                 prefill_chunk=4, admission="lazy"),
        waves=[([(30, 9, 10), (31, 11, 8), (32, 10, 9)], 0)]),
    "max_new_1": dict(
        cfg=dict(page_size=8, num_pages=16, decode_slots=1,
                 prefill_chunk=8),
        waves=[([(2, 6, 1)], 0)]),
}


def _drive(eng, scenario):
    reqs, specs = [], []
    for wave, steps in scenario["waves"]:
        for pid, lp, n in wave:
            reqs.append(eng.submit(_prompt(pid, lp), n))
            specs.append((pid, lp, n))
        for _ in range(steps):
            eng.step()
    eng.run(max_steps=500)
    return {"outputs": [list(map(int, r.output)) for r in reqs],
            "states": [r.state for r in reqs],
            "evictions": sum(r.evictions for r in reqs),
            "specs": specs,
            "attention": eng.stats()["attention"]}


_JAX_RUNS = {}


def _jax_run(jparams, name):
    if name not in _JAX_RUNS:
        eng = JServeEngine(jparams, JServeConfig(**SCENARIOS[name]["cfg"]))
        _JAX_RUNS[name] = _drive(eng, SCENARIOS[name])
    return _JAX_RUNS[name]


@pytest.mark.parametrize("attention", ["gather", "paged"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_streams_equal_jax_engine_and_lm_decode(jparams, tparams,
                                                       name, attention):
    want = _jax_run(jparams, name)
    eng = ServeEngine(tparams, ServeConfig(attention=attention,
                                           **SCENARIOS[name]["cfg"]),
                      device="cpu")
    got = _drive(eng, SCENARIOS[name])
    assert got["states"] == ["finished"] * len(got["states"])
    assert got["outputs"] == want["outputs"]
    for out, (pid, lp, n) in zip(got["outputs"], got["specs"]):
        ref = tlm.lm_decode(tparams, _prompt(pid, lp)[None], n,
                            device="cpu")[0].tolist()
        assert out == ref
    if name == "eviction":
        assert got["evictions"] > 0 and want["evictions"] > 0, \
            "the scenario must exercise eviction-recompute"
    # Same schedule, same per-step live-key counts: the traffic
    # accounting equals the JAX engine's (whose mode is gather).
    got_att = dict(got["attention"], mode="gather",
                   kv_bytes_per_chip=want["attention"]["kv_bytes_per_chip"])
    assert got_att == want["attention"]


def test_paged_mode_on_cpu_launches_no_kernel(tparams):
    before = tpa.paged_attention_decode.launches
    eng = ServeEngine(tparams, ServeConfig(
        page_size=8, num_pages=16, decode_slots=2, prefill_chunk=4,
        attention="paged"), device="cpu")
    eng.submit(_prompt(3, 5), 4)
    eng.run()
    assert eng.finished and tpa.paged_attention_decode.launches == before
    assert eng.lane_graphs is None      # the CPU runs the lane eagerly
    att = eng.stats()["attention"]
    assert att["mode"] == "paged" and att["kv_fetch_frac"] < 1


def test_idle_slots_write_only_the_null_page(tparams):
    """The decode lane runs all S slots at one shape: with one live slot
    of three, the two idle slots write their rows into page 0 and only
    there, the live slot's row lands in its own page, no other page
    changes, and the live slot's logits do not depend on what the idle
    slots hold (bit for bit)."""
    from horovod_tpu_torch.serve.engine import decode_lane, pack_decode

    ps, pps, num_pages = 4, 3, 10
    gen = torch.Generator().manual_seed(0)
    pages = [{kv: torch.randn(num_pages, ps, H, DH, generator=gen)
              for kv in ("k", "v")} for _ in range(LAYERS)]
    tables = np.zeros((3, pps), np.int32)
    tables[1] = [5, 2, 0]
    dec = {"tok": np.array([0, 7, 0], np.int32),
           "pos": np.array([0, 5, 0], np.int32),
           "active": np.array([False, True, False]), "tables": tables}
    packed = pack_decode(dec, ps)
    assert packed.dtype == np.int32 and packed.shape == (3 * (pps + 5),)
    for attention in ("gather", "paged"):
        work = [{kv: t.clone() for kv, t in pg.items()} for pg in pages]
        logits = decode_lane(tparams, work, torch.as_tensor(packed),
                             slots=3, page_size=ps, attention=attention)
        other = [{kv: t.clone() for kv, t in pg.items()} for pg in pages]
        idle = dict(dec, tok=np.array([9, 7, 3], np.int32))
        want = decode_lane(tparams, other,
                           torch.as_tensor(pack_decode(idle, ps)), slots=3,
                           page_size=ps, attention=attention)
        assert torch.equal(logits[1], want[1]), attention
        assert not torch.equal(logits[0], want[0])
        for before, after in zip(pages, work):
            for kv in ("k", "v"):
                changed = (before[kv] != after[kv]).flatten(2).any(-1)
                # page 0 row 0 (the idle slots), page 2 row 1 (pos 5).
                assert changed.nonzero().tolist() == [[0, 0], [2, 1]], (
                    attention, kv)


def test_page_allocator_matches_jax():
    """The same operation sequence on both allocators leaves the same
    grants, refcounts, free counts and the same errors."""
    ops = [("alloc", 3), ("retain", [3, 2]), ("release", [3]),
           ("alloc", 2), ("free", [1]), ("release", [3, 2]),
           ("release", [2]), ("free", [2]), ("release", [5]),
           ("alloc", 9), ("retain", [7]), ("alloc", 6)]
    pair = (JPageAllocator(8), PageAllocator(8))
    for op, arg in ops:
        results = []
        for a in pair:
            try:
                results.append(("ok", getattr(a, op)(arg)))
            except OutOfPages as e:
                results.append(("OutOfPages", str(e)))
            except Exception as e:      # noqa: BLE001 - compared below
                results.append((type(e).__name__, str(e)))
            results[-1] += (a.available, a.in_use, a.shared,
                            [a.refcount(p) for p in range(8)])
        jres, tres = results
        # OutOfPages is a distinct class per package; compare by name.
        if jres[0] == "OutOfPages":
            assert tres[0] == "OutOfPages"
        assert jres[1:] == tres[1:], (op, arg)


@pytest.mark.parametrize("fn", ["rebase_for_recompute",
                                "restart_from_scratch"])
def test_recompute_arithmetic_matches_jax(fn):
    """The host-side request rewrites shared by eviction-requeue and the
    fleet's redispatch leave the same request state in both packages."""
    from horovod_tpu.serve import scheduler as jsch
    from horovod_tpu_torch.serve import scheduler as tsch

    def state(mod):
        req = mod.Request(prompt=_prompt(9, 6), max_new_tokens=5)
        req.generated, req.output = [3, 4], [3, 4]
        req.prefill_pos, req.version = 6, 2
        ret = getattr(mod, fn)(req)
        return (ret, req.prompt.tolist(), req.max_new_tokens,
                req.generated, req.output, req.prefill_pos, req.version,
                req.version_restarts, req.sample_index)

    assert state(tsch) == state(jsch)


def test_sampling_same_seed_deterministic(tparams):
    cfg = ServeConfig(page_size=8, num_pages=32, decode_slots=2,
                      prefill_chunk=4)

    def run(seed):
        eng = ServeEngine(tparams, cfg, device="cpu")
        hot = eng.submit(_prompt(5, 6), 10, temperature=1.0, top_k=8,
                         seed=seed)
        cold = eng.submit(_prompt(6, 6), 10)
        eng.run()
        return hot.output, cold.output

    a, b, c = run(7), run(7), run(8)
    assert a == b
    assert a[0] != c[0]
    assert all(0 <= t < V for t in a[0])
    # A sampling neighbour never moves a greedy stream.
    assert a[1] == c[1] == tlm.lm_decode(tparams, _prompt(6, 6)[None], 10,
                                         device="cpu")[0].tolist()


def test_sampling_top_k_one_is_greedy():
    from horovod_tpu_torch.serve.sampling import sample_tokens

    logits = torch.tensor(np.random.default_rng(0).normal(
        size=(3, 20)).astype(np.float32))
    toks = sample_tokens(logits, [0.0, 2.0, 0.5], [0, 1, 1], [1, 2, 3],
                         [0, 4, 9])
    np.testing.assert_array_equal(toks, logits.argmax(-1).numpy())


def test_lifecycle_eos_rejects_and_queue(tparams):
    eng = ServeEngine(tparams, ServeConfig(
        page_size=8, num_pages=16, decode_slots=1, prefill_chunk=8,
        max_queue=1), device="cpu")
    ref = tlm.lm_decode(tparams, _prompt(4, 5)[None], 6,
                        device="cpu")[0].tolist()
    # The first token of the stream that did not occur before it.
    cut = next(i for i in range(1, 6) if ref[i] not in ref[:i])
    big = eng.submit(_prompt(0, LMAX), 4)
    assert big.state == "rejected" and big.reject_reason == "infeasible"
    r = eng.submit(_prompt(4, 5), 6, eos_token=ref[cut])
    over = eng.submit(_prompt(1, 5), 2)
    assert over.reject_reason == "overloaded"
    eng.run()
    assert r.output == ref[:cut + 1] and r.state == "finished"
    assert eng.stats()["by_state"] == {"rejected": 2, "finished": 1}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_deadline_times_out_and_frees_pages(tparams):
    clock = _Clock()
    eng = ServeEngine(tparams, ServeConfig(
        page_size=8, num_pages=16, decode_slots=1, prefill_chunk=8),
        clock=clock, device="cpu")
    req = eng.submit(_prompt(7, 5), 20, ttl=1.0)
    eng.step()
    eng.step()
    assert eng.cache.allocator.in_use > 0
    clock.t = 2.0
    eng.run()
    assert req.state == "timeout" and eng.timed_out == [req]
    assert eng.cache.allocator.in_use == 0
    assert 0 < len(req.output) < 20


def test_update_params_swaps_only_when_idle(tparams):
    other = tlm.init_lm_params(3, V, LMAX, LAYERS, H, DH, FFN,
                               device="cpu")
    eng = ServeEngine(tparams, ServeConfig(
        page_size=8, num_pages=16, decode_slots=1, prefill_chunk=8),
        device="cpu")
    eng.update_params(other)
    req = eng.submit(_prompt(8, 5), 4)
    with pytest.raises(RuntimeError, match="in flight"):
        eng.update_params(tparams)
    eng.run()
    assert req.output == tlm.lm_decode(other, _prompt(8, 5)[None], 4,
                                       device="cpu")[0].tolist()
    short = tlm.init_lm_params(3, V, LMAX // 2, LAYERS, H, DH, FFN,
                               device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        eng.update_params(short)


@pytest.mark.parametrize("kw", [dict(page_size=0), dict(num_pages=1),
                                dict(decode_slots=0), dict(policy="lifo"),
                                dict(attention="flash"),
                                dict(speculate_k=-1),
                                dict(draft_layers=2),
                                dict(default_ttl=0)])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(mesh="dp=1,tp=4")])
def test_unported_knobs_raise_naming_the_roadmap(kw):
    """``mesh`` builds the JAX config's fields and degree; a fleet of
    tensor-parallel replicas runs on the worker transports
    (tests/test_torch_serve_tp_fleet.py), and the in-process one refuses
    it, naming the transports that take it."""
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError
    from horovod_tpu_torch.serve import FleetConfig, ServeFleet

    want, got = JServeConfig(**kw), ServeConfig(**kw)
    assert got.mesh_axes() == want.mesh_axes()
    assert got.tp_degree == want.tp_degree == 4
    with pytest.raises(InvalidArgumentError,
                       match="transport='inproc'.*'process' or 'tcp'"):
        ServeFleet({}, got, FleetConfig(), device="cpu")


@pytest.mark.parametrize("kw", [dict(speculate_k=2, draft_layers=1),
                                dict(prefix_caching=True),
                                dict(speculate_k=4, prefix_caching=True,
                                     attention="paged")])
def test_ported_knobs_build_the_same_config_as_jax(kw):
    """Speculative decoding and prefix caching construct, and every field
    of the port's config equals the JAX config's."""
    import dataclasses

    want, got = JServeConfig(**kw), ServeConfig(**kw)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.in_flight_limit == want.in_flight_limit


def test_defaults_match_jax():
    want, got = JServeConfig(), ServeConfig()
    for f in ("page_size", "num_pages", "decode_slots", "prefill_chunk",
              "max_in_flight", "policy", "slo", "admission", "attention",
              "eos_token", "max_queue", "requeue_evicted", "default_ttl"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.in_flight_limit == want.in_flight_limit


def test_engine_defaults_to_the_card(tparams, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tparams, ServeConfig())


def _port_files():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 14 and all(f.exists() for f in files)
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("_graphs.py", "_lazy.py", "distributed/window.py", "utils/devsync.py",
                "data/__init__.py", "data/sharding.py", "data/prefetch.py",
                "serve/prefix.py", "serve_bench.py", "serve/router.py",
                "serve/fleet.py", "serve/transport.py", "serve/worker.py",
                "serve/netfault.py", "serve/params_wire.py",
                "serve/chunk_stream.py", "serve/kv_wire.py",
                "serve/disagg.py", "serve/tp_replica.py",
                "elastic/__init__.py",
                "elastic/faults.py", "elastic/signals.py",
                "elastic/supervisor.py", "elastic/snapshot.py",
                "elastic/loop.py", "checkpoint.py", "_pytree.py",
                "run/__init__.py",
                "run/driver.py", "run/network.py", "run/task_exec.py",
                "run/launcher.py", "run/__main__.py",
                "parallel/__init__.py", "parallel/logical.py",
                "parallel/mesh.py", "parallel/tp.py", "parallel/moe.py",
                "parallel/spmd.py", "models/train.py",
                "models/mnist.py", "models/vgg.py", "models/vit.py",
                "models/inception.py",
                "training/__init__.py", "training/callbacks.py",
                "training/_msgpack.py", "distributed/autotune.py",
                "distributed/_bayes.py", "training/optim.py",
                "examples/__init__.py", "examples/mnist.py",
                "examples/synthetic_benchmark.py",
                "examples/imagenet_resnet50.py",
                "examples/transformer_zero.py", "examples/word2vec.py",
                "examples/long_context_ring_attention.py",
                "examples/gpt_parallel.py", "lm_common.py",
                "decode_bench.py", "verify/__init__.py",
                "verify/schedule.py", "verify/rules.py", "verify/core.py",
                "verify/registry.py", "verify/__main__.py"):
        assert f"horovod_tpu_torch/{new}" in names, new
    for pkg in ("elastic", "run", "training", "examples", "verify"):
        assert sorted(n for n in names
                      if n.startswith(f"horovod_tpu_torch/{pkg}/")) == \
            sorted(f"horovod_tpu_torch/{pkg}/{m}.py" for m in {
                "elastic": ("__init__", "faults", "loop", "signals",
                            "snapshot", "supervisor"),
                "run": ("__init__", "__main__", "driver", "launcher",
                        "network", "task_exec"),
                "training": ("__init__", "callbacks", "_msgpack", "optim"),
                "examples": ("__init__", "mnist", "synthetic_benchmark",
                             "imagenet_resnet50", "transformer_zero",
                             "word2vec", "long_context_ring_attention",
                             "gpt_parallel"),
                "verify": ("__init__", "schedule", "rules", "core",
                           "registry", "__main__")}[pkg])
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "flax", "optax", "orbax",
                            "ml_dtypes", "msgpack", "horovod_tpu",
                            "tools"):
                    bad.append(f"{f.relative_to(REPO)}: {n}")
    assert not bad, bad
