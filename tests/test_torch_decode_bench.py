"""The static-cache decode lane of the port on the CPU:
``models.parallel_lm.StaticDecoder``, ``horovod_tpu_torch.decode_bench``
and ``horovod_tpu_torch.lm_common``, against the JAX package's
``lm_decode``, ``tools/decode_bench.py`` and ``tools/lm_common.py``.

JAX weights (``init_lm_params``) go across with ``params_from_numpy``,
prompts come from numpy seeds, both packages run in float32 on the CPU,
and the greedy tokens must be equal bit for bit (2 layers, d 64, 4 heads,
vocab 256, batch 2, prompt 8, 16 steps). On the CPU the decoder runs
its prefill and step functions eagerly; the graphs are held to the eager
loop on the card (``chip_smoke.py``'s decode phase).
"""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu_torch import decode_bench, lm_common
from horovod_tpu_torch.models import parallel_lm as tlm

V, LAYERS, H, DH, D = 256, 2, 4, 16, 64
B, LP, STEPS = 2, 8, 16
LMAX = LP + STEPS
TINY = ["--layers", "2", "--d-model", "64", "--heads", "4", "--vocab",
        "256", "--batch", "2", "--prompt-len", "8", "--steps", "16",
        "--iters", "2"]


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_lm_params(jax.random.PRNGKey(0), V, LMAX, LAYERS, H,
                              DH, 4 * D)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tlm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, V, (B, LP)).astype(
        np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_static_decoder_tokens_equal_lm_decode_and_jax(jparams, tparams,
                                                       seed):
    prompt = _prompt(seed)
    want = np.asarray(jlm.lm_decode(jparams, jnp.asarray(prompt), STEPS))
    eager = tlm.lm_decode(tparams, prompt, STEPS, device="cpu")
    dec = tlm.StaticDecoder(tparams, B, LP, STEPS, device="cpu")
    for _ in range(2):          # a second call reuses every buffer
        got = dec(prompt)
        assert got.dtype == torch.long and tuple(got.shape) == (B, STEPS)
        assert torch.equal(got, eager)
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(dec.pos) == LP + STEPS - 1


def test_static_decoder_logits_are_the_eager_loops(tparams):
    prompt = torch.as_tensor(_prompt(3), dtype=torch.long)
    dec = tlm.StaticDecoder(tparams, B, LP, STEPS, device="cpu")
    dec(prompt)
    caches, logits = tlm.lm_prefill(tparams, prompt)
    tok = torch.argmax(logits.float(), -1)
    for i in range(STEPS - 1):
        caches, logits = tlm.lm_decode_step(tparams, caches, tok, LP + i)
        tok = torch.argmax(logits.float(), -1)
    assert torch.equal(dec.logits, logits.float())
    # The caches are written in place, row for row the eager loop's.
    for c, e in zip(dec.caches, caches):
        n = LP + STEPS - 1
        assert torch.equal(c["k"][:, :n], e["k"][:, :n])
        assert torch.equal(c["v"][:, :n], e["v"][:, :n])


def test_static_decoder_is_greedy_only_and_checks_its_shapes(tparams):
    with pytest.raises(ValueError, match="greedy only"):
        tlm.StaticDecoder(tparams, B, LP, STEPS, temperature=0.7,
                          device="cpu")
    with pytest.raises(ValueError, match="exceeds the position table"):
        tlm.StaticDecoder(tparams, B, LP, STEPS + 1, device="cpu")
    dec = tlm.StaticDecoder(tparams, B, LP, STEPS, device="cpu")
    with pytest.raises(ValueError, match=r"built for \(2, 8\)"):
        dec(_prompt(0)[:, :4])


def test_static_decoder_defaults_to_the_card(tparams, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.StaticDecoder(tparams, B, LP, STEPS)


def _jax_error(monkeypatch, capsys, argv):
    from tools import decode_bench as jdb

    monkeypatch.setattr(sys, "argv", ["decode_bench.py", *argv])
    with pytest.raises(SystemExit) as e:
        jdb.main()
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["--steps", "0"], ["--batch", "0"], ["--prompt-len", "0"],
    ["--iters", "0"], ["--layers", "0"], ["--heads", "5"],
])
def test_argument_errors_equal_the_jax_tools(monkeypatch, capsys, argv):
    want = _jax_error(monkeypatch, capsys, argv)
    with pytest.raises(SystemExit) as e:
        decode_bench.parse_args(argv)
    assert e.value.code == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


def test_flags_and_defaults_equal_the_jax_tools():
    port = {a.dest: a.default for a in decode_bench.build_parser()._actions
            if a.dest != "help"}
    assert port == {"layers": 12, "d_model": 768, "heads": 12,
                    "vocab": 32000, "batch": 8, "prompt_len": 128,
                    "steps": 256, "iters": 5, "device": None}


def test_cpu_run_prints_one_record(capsys):
    assert decode_bench.main(TINY + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "transformer_lm_decode_tokens_per_sec_per_card"
    assert rec["unit"] == "tokens/sec/card" and rec["vs_baseline"] is None
    assert rec["value"] > 0 and rec["peak"] >= rec["value"]
    assert rec["ms_per_generation"] == pytest.approx(
        B * STEPS / rec["value"] * 1e3)
    assert rec["card"] == "cpu" and rec["device"] == "cpu"
    assert "Iter #1:" in out.err and "compile+prefill" in out.err


def test_lm_common_equals_the_jax_helpers():
    from tools import lm_common as jlc

    port, jax_ap = argparse.ArgumentParser(), argparse.ArgumentParser()
    lm_common.add_model_args(port)
    jlc.add_model_args(jax_ap)
    assert [(a.option_strings, a.default, a.type) for a in port._actions] \
        == [(a.option_strings, a.default, a.type) for a in jax_ap._actions]
    args = argparse.Namespace(layers=2, d_model=64, heads=4, vocab=256)
    p = lm_common.build_params(args, LMAX, seed=3, device="cpu")
    want = tlm.init_lm_params(3, 256, LMAX, 2, 4, 16, 256, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(p),
        torch.utils._pytree.tree_leaves(want)))
    assert p["layers"][0]["wup"].shape == (64, 256)


def test_serve_bench_builds_its_model_through_lm_common(monkeypatch):
    """serve_bench's parser keeps the four model flags first, with their
    defaults, and a run builds its model once through lm_common, at the
    position table its workload needs (the construction it inlined
    before, parameter for parameter)."""
    from horovod_tpu_torch import serve_bench

    ap = serve_bench.build_parser()
    first = [a for a in ap._actions if a.dest != "help"][:4]
    assert [(a.option_strings[0], a.default) for a in first] == [
        ("--layers", 12), ("--d-model", 768), ("--heads", 12),
        ("--vocab", 32000)]
    built = []
    real = lm_common.build_params

    def spy(args, max_len, seed=0, device=None):
        p = real(args, max_len, seed=seed, device=device)
        built.append((max_len, p))
        return p

    monkeypatch.setattr(serve_bench, "build_params", spy)
    rec = serve_bench.run(ap.parse_args([
        "--layers", "1", "--d-model", "16", "--heads", "2", "--vocab",
        "32", "--requests", "2", "--rate", "200", "--prompt-min", "4",
        "--prompt-max", "6", "--new-min", "2", "--new-max", "3",
        "--decode-slots", "2", "--prefill-chunk", "4", "--page-size",
        "8"]), device="cpu", ap=ap)
    assert rec["value"] > 0 and len(built) == 1
    lmax, params = built[0]
    want = tlm.init_lm_params(0, 32, lmax, 1, 2, 8, 64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(params),
        torch.utils._pytree.tree_leaves(want)))
