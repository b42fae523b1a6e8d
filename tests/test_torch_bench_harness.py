"""The port's bench harness: ``python -m horovod_tpu_torch.bench --device
cpu`` against the JAX bench's pins (``tests/test_bench.py``), and
``--bf16-momentum`` on both lanes.

* the supervisor: a hung attempt (a 1 s attempt timeout) ends in an error
  record naming the timeout after 2 attempts; SIGTERM mid-attempt still
  prints the contract line with rc 0; a deterministic failure of the
  child is tried once, its exception's text in ``error``; each record is
  one JSON line on stdout with the metric and unit the success would
  carry and ``"value": null``; under ``HOROVOD_RANK`` or ``RANK`` (or
  ``HVD_BENCH_NO_SUPERVISOR``) the lane runs in the process itself;
* ``--mesh`` canonicalizes, rejects an invalid config as a usage error,
  and stamps ``null`` when absent (degraded records included);
* ``--compile-only`` (``<model>_first_step_secs``, unit ``secs``,
  ``_winK`` for windows) and ``--probe-only`` (``chip_probe_tflops``);
* the aliases ``--d-model`` and ``--flash-attention``;
* ``--bf16-momentum``: SGD's momentum (image lane) and Adam's first
  moment (LM lane) in bfloat16, stamped as ``opt_state_dtype``, with
  ``opt_state_bytes`` (the narrow state's bytes halved), per step, in a
  window and under ``--zero``.

The subprocess runs are few and tiny: each starts an interpreter.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch import bench
from horovod_tpu_torch.common import basics

REPO = Path(__file__).resolve().parent.parent
LM_TINY = ["--seq-len", "16", "--batch-size", "2", "--lm-layers", "2",
           "--lm-dim", "16", "--lm-heads", "2", "--vocab", "32", "--fp32",
           "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
           "--num-iters", "1"]
IMG_TINY = ["--model", "resnet18", "--image-size", "32", "--batch-size",
            "2", "--fp32", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "1", "--num-iters", "1"]


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    for k in ("HOROVOD_RANK", "RANK", "HVD_BENCH_NO_SUPERVISOR"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def _bench(*args, extra_env=None, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--device", "cpu",
         *args], env=_env(extra_env), cwd=str(REPO), capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0]), proc


def _run(argv):
    try:
        return bench.run(bench.build_parser().parse_args(argv),
                         device="cpu")
    finally:
        basics.shutdown()


# ------------------------------------------------------ the supervisor


def test_hung_attempt_degrades_to_an_error_record():
    rec, proc = _bench(*IMG_TINY, "--image-size", "64", extra_env={
        "HVD_BENCH_ATTEMPTS": "2", "HVD_BENCH_ATTEMPT_TIMEOUT": "1",
        "HVD_BENCH_BACKOFF": "0.1"})
    assert (rec["metric"], rec["unit"]) == ("img/sec", "img/sec/card")
    assert rec["value"] is None and "timeout" in rec["error"]
    assert rec["mesh"] is None and rec["probe_tflops"] is None
    assert proc.stderr.count("attempt 2/2") == 1


def test_sigterm_mid_attempt_still_prints_the_contract_line():
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--device", "cpu",
         *IMG_TINY, "--num-iters", "50", "--steps-per-dispatch", "2"],
        env=_env(), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = ""
    while "attempt 1/" not in line:
        line = proc.stderr.readline()
        assert line, "the supervisor exited before announcing an attempt"
    time.sleep(1)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["metric"], rec["unit"]) == ("img/sec_win2",
                                            "img/sec/card_win2")
    assert rec["value"] is None and "signal" in rec["error"]


def test_deterministic_failure_is_tried_once_with_its_reason():
    rec, proc = _bench("--model", "transformer_lm", "--fused-bn",
                       extra_env={"HVD_BENCH_ATTEMPTS": "3",
                                  "HVD_BENCH_BACKOFF": "0.1"})
    assert (rec["metric"], rec["unit"]) == ("tokens/sec", "tokens/sec/card")
    assert rec["value"] is None
    assert "deterministic" in rec["error"]
    assert "ValueError: --fused-bn applies to the ResNet" in rec["error"]
    assert proc.stderr.count("attempt 1/3") == 1
    assert "attempt 2/" not in proc.stderr


def test_a_supervised_success_and_the_probe_only_record():
    rec, proc = _bench(*IMG_TINY, "--mesh", "tp=1,dp=1")
    assert rec["metric"] == "img/sec" and rec["value"] > 0
    assert rec["mesh"] == "dp=1,tp=1"
    assert "probe_tflops" in rec and rec["card"] == "cpu"
    probe, _ = _bench("--probe-only")
    assert (probe["metric"], probe["unit"]) == ("chip_probe_tflops",
                                                "TFLOP/s")
    assert probe["value"] == probe["probe_tflops"]
    assert probe["value"] is None or probe["value"] > 0


@pytest.mark.parametrize("var", ["HOROVOD_RANK", "RANK",
                                 "HVD_BENCH_NO_SUPERVISOR", None])
def test_no_supervisor_under_a_launcher(monkeypatch, capsys, var):
    for k in ("HOROVOD_RANK", "RANK", "HVD_BENCH_NO_SUPERVISOR"):
        monkeypatch.delenv(k, raising=False)
    if var:
        monkeypatch.setenv(var, "1" if var.startswith("HVD") else "0")
    calls = []
    monkeypatch.setattr(bench, "supervise",
                        lambda argv, args: calls.append("supervise") or 0)
    monkeypatch.setattr(bench, "run", lambda args: calls.append("run") or
                        {"metric": "img/sec", "value": 1.0})
    assert bench.cli(["--device", "cpu"]) == 0
    assert calls == (["supervise"] if var is None else ["run"])
    if var:
        assert json.loads(capsys.readouterr().out) == {
            "metric": "img/sec", "value": 1.0}


def test_a_child_classifies_its_failure(tmp_path, monkeypatch):
    def boom(args):
        raise RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(bench, "run", boom)
    # A library call raises; the command line's child returns the code.
    with pytest.raises(RuntimeError, match="out of memory"):
        bench.main(["--device", "cpu"])
    emit = str(tmp_path / "rec.json")
    assert bench.cli(["--device", "cpu", "--_child", "--_emit", emit]) \
        == bench.RC_DETERMINISTIC
    assert "out of memory" in open(emit + ".err").read()
    assert not os.path.exists(emit)
    assert bench.classify(ConnectionError("Connection refused")) == 1
    assert bench.classify(RuntimeError("NCCL error: unhandled system")) == 1
    assert bench.classify(ValueError("bad flag")) == bench.RC_DETERMINISTIC


@pytest.mark.parametrize("argv,want", [
    ([], ("tokens/sec", "tokens/sec/card")),
    (["--steps-per-dispatch", "4"], ("tokens/sec_win4",
                                     "tokens/sec/card_win4")),
    (["--model", "vgg16"], ("img/sec", "img/sec/card")),
    (["--compile-only"], ("transformer_lm_first_step_secs", "secs")),
    (["--compile-only", "--model", "resnet50", "--steps-per-dispatch",
      "2"], ("resnet50_first_step_secs_win2", "secs")),
    (["--probe-only"], ("chip_probe_tflops", "TFLOP/s")),
])
def test_metric_contract(argv, want):
    assert bench.metric_contract(bench.build_parser().parse_args(argv)) \
        == want


# ------------------------------------------- mesh, aliases, the probe


def test_mesh_canonicalizes_and_rejects_invalid_configs(capsys):
    parser = bench.build_parser()
    assert parser.parse_args(["--mesh", "tp=4,dp=8"]).mesh == "dp=8,tp=4"
    assert parser.parse_args([]).mesh is None
    for bad in ("dp=banana", "tp", ""):
        with pytest.raises(SystemExit) as e:
            parser.parse_args(["--mesh", bad])
        assert e.value.code == 2
    rec = _run(LM_TINY + ["--mesh", "tp=1,dp=1"])
    assert rec["mesh"] == "dp=1,tp=1"
    assert _run(LM_TINY)["mesh"] is None


def test_aliases():
    parser = bench.build_parser()
    assert parser.parse_args([]).lm_dim == 768
    assert parser.parse_args(["--d-model", "1024"]).lm_dim == 1024
    assert parser.parse_args(["--flash-attention"]).attention == "flash"
    assert parser.parse_args(["--flash-attention", "--attention",
                              "flash"]).attention == "flash"
    with pytest.raises(SystemExit):
        parser.parse_args(["--flash-attention", "--attention", "dense"])
    rec = _run([a if a != "--lm-dim" else "--d-model" for a in LM_TINY]
               + ["--flash-attention"])
    assert rec["attention"] == "flash" and rec["d_model"] == 16
    assert rec["flash_grid"]["bwd"] == "kernel"


@pytest.mark.parametrize("k", [1, 2])
def test_compile_only_times_one_first_step(k):
    rec = _run(LM_TINY + ["--compile-only", "--steps-per-dispatch", str(k)])
    suffix = f"_win{k}" if k > 1 else ""
    assert rec["metric"] == f"transformer_lm_first_step_secs{suffix}"
    assert rec["unit"] == "secs" and rec["value"] > 0
    assert np.isfinite(rec["loss"]) and "probe_tflops" in rec


def test_probe_is_null_when_the_longer_chain_is_not_longer(monkeypatch):
    ticks = iter([0.0, 1.0] * 3 + [0.0, 0.5] * 3)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    assert bench.probe_chip(torch.device("cpu"), log=lambda *a, **k: None) \
        is None


def test_probe_rate_is_the_marginal_one(monkeypatch):
    # chain(2) takes 1 s, chain(6) 3 s: 4 matmuls of 2 * 512^3 in 2 s.
    ticks = iter([0.0, 1.0] * 3 + [0.0, 3.0] * 3)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    got = bench.probe_chip(torch.device("cpu"), log=lambda *a, **k: None)
    assert got == round(2 * 512 ** 3 * 4 / 2.0 / 1e12, 1)


# ------------------------------------------------------ --bf16-momentum


@pytest.mark.parametrize("lane,extra", [
    ("lm", []), ("lm", ["--steps-per-dispatch", "2"]), ("lm", ["--zero"]),
    ("image", []), ("image", ["--steps-per-dispatch", "2"]),
    ("image", ["--zero"]),
])
def test_bf16_momentum_runs_and_stamps_the_state_dtype(lane, extra):
    base = (LM_TINY if lane == "lm" else IMG_TINY) + extra
    rec16 = _run(base + ["--bf16-momentum"])
    rec32 = _run(base)
    assert np.isfinite(rec16["loss"]) and rec16["replicas_in_sync"]
    if lane == "lm":
        assert rec16["opt_state_dtype"] == {"mu": "bfloat16",
                                            "nu": "float32"}
        assert rec32["opt_state_dtype"] == {"mu": "float32",
                                            "nu": "float32"}
        # mu halves, nu stays: 3/4 of the float32 state.
        assert rec16["opt_state_bytes"] * 4 == rec32["opt_state_bytes"] * 3
    else:
        assert rec16["opt_state_dtype"] == {"momentum": "bfloat16"}
        assert rec32["opt_state_dtype"] == {"momentum": "float32"}
        assert rec16["opt_state_bytes"] * 2 == rec32["opt_state_bytes"]
    if "--zero" in extra:
        assert rec16["zero"] == rec32["zero"]


def test_bf16_momentum_is_no_longer_left_for_later():
    assert not any(flag == "--bf16-momentum" for _, flag, _ in bench._LATER)
