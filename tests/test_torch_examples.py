"""The port's examples (``horovod_tpu_torch/examples/``) at their smoke
sizes on the CPU, each passing its own assertions, as
``tests/test_examples_models.py::TestExamples`` runs the JAX ones.

Each runs as ``python -m horovod_tpu_torch.examples.<name> --device cpu``,
the multi-rank ones under ``python -m horovod_tpu_torch.run -np N`` over
gloo (2 ranks; ``gpt_parallel`` 4, its dp=1 x sp=2 x tp=2 mesh, where
the JAX test runs 8 virtual devices), one thread a rank. The examples'
data generators are pinned byte for byte to the JAX examples' own:
``jax_mnist.make_dataset``, ``jax_word2vec.make_batches`` and
``jax_gpt_parallel``'s bigram successor corpus (its lines of the file,
run as they stand).
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("HVD_BENCH_NO_SUPERVISOR", None)
    return env


def _run(name, *args, np_ranks=None, cwd=None, timeout=300):
    cmd = [sys.executable, "-m", f"horovod_tpu_torch.examples.{name}",
           "--device", "cpu", *args]
    if np_ranks:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
               str(np_ranks), "--", *cmd]
    proc = subprocess.run(cmd, env=_env(), cwd=cwd or str(REPO),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"{name} rc={proc.returncode}\nstdout: {proc.stdout[-2000:]}\n"
        f"stderr: {proc.stderr[-3000:]}")
    return proc


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------ the data, byte for byte


@pytest.mark.parametrize("n,classes,seed", [(2048, 10, 0), (512, 10, 1),
                                            (64, 7, 3)])
def test_mnist_dataset_is_the_jax_examples(n, classes, seed):
    from horovod_tpu_torch.examples import mnist

    want = _jax_example("jax_mnist").make_dataset(n, classes, seed)
    got = mnist.make_dataset(n, classes, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("args", [(96, 8, 64, 400, 5), (2048, 32, 128, 3, 5)])
def test_word2vec_corpus_is_the_jax_examples(args):
    from horovod_tpu_torch.examples import word2vec

    want = _jax_example("jax_word2vec").make_batches(*args)
    got = word2vec.make_batches(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("vocab,batch,seq_len", [(64, 4, 64),
                                                 (256, 8, 256)])
def test_gpt_parallel_corpus_is_the_jax_examples(vocab, batch, seq_len):
    """The JAX example builds its corpus inline: its own lines, from the
    successor table to the sequences, run as they stand."""
    from horovod_tpu_torch.examples import gpt_parallel

    src = (EXAMPLES / "jax_gpt_parallel.py").read_text()
    start = src.index("    succ = np.random.RandomState(1)")
    end = src.index("    tokens = jnp.asarray(seq)")
    scope = {"np": np, "args": types.SimpleNamespace(
        vocab=vocab, batch=batch, seq_len=seq_len)}
    exec(textwrap.dedent(src[start:end]), scope)
    succ, seq = gpt_parallel.successor_corpus(vocab, batch, seq_len)
    assert succ.tobytes() == scope["succ"].tobytes()
    assert seq.dtype == scope["seq"].dtype
    assert seq.tobytes() == scope["seq"].tobytes()


# ------------------------------------------------------------ the runs


def test_mnist_two_ranks():
    """The JAX test's flags at its global batch (8 virtual devices of 8,
    here 2 ranks of 32); the example exits 1 below 0.9 accuracy."""
    proc = _run("mnist", "--epochs", "3", "--batch-size", "32",
                "--train-size", "2048", "--test-size", "512", np_ranks=2)
    accs = [float(line.split("test_acc=")[1].split()[0])
            for line in proc.stdout.splitlines() if "test_acc=" in line]
    assert len(accs) == 3 and accs[-1] >= 0.9


def test_synthetic_benchmark_prints_one_supervised_record():
    proc = _run("synthetic_benchmark", "--model", "resnet18",
                "--image-size", "32", "--batch-size", "2", "--fp32",
                "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
                "--num-iters", "1")
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "img/sec" and rec["value"] > 0
    assert rec["model"] == "resnet18" and rec["device"] == "cpu"
    assert "[bench supervisor] attempt 1/" in proc.stderr


def test_synthetic_benchmark_defaults_to_resnet50(monkeypatch):
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.examples import synthetic_benchmark

    seen = []
    monkeypatch.setattr(bench, "cli", lambda argv: seen.append(argv) or 0)
    assert synthetic_benchmark.main(["--device", "cpu"]) == 0
    assert synthetic_benchmark.main(["--model", "vgg16"]) == 0
    assert seen == [["--model", "resnet50", "--device", "cpu"],
                    ["--model", "vgg16"]]


def test_imagenet_resnet50_trains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck.msgpack")
    first = _run("imagenet_resnet50", "--smoke", "--epochs", "2",
                 "--steps-per-epoch", "3", "--checkpoint", ck, np_ranks=2)
    assert "history:" in first.stdout and os.path.exists(ck)
    assert "Resuming" not in first.stdout
    second = _run("imagenet_resnet50", "--smoke", "--epochs", "3",
                  "--steps-per-epoch", "3", "--checkpoint", ck, np_ranks=2)
    assert "Resuming from epoch 2" in second.stdout
    history = second.stdout.split("history:")[1]
    assert history.count("loss") == 1          # the one epoch left


def test_transformer_zero_trains_then_resumes(tmp_path):
    ck = str(tmp_path / "zck")
    first = _run("transformer_zero", "--smoke", "--ckpt-dir", ck,
                 np_ranks=2)
    assert float(first.stdout.strip().splitlines()[-1]) > 0
    assert sorted(os.listdir(ck))
    second = _run("transformer_zero", "--smoke", "--ckpt-dir", ck,
                  np_ranks=2)
    assert "resuming from step 6" in second.stderr
    assert second.stdout.strip() == ""


def test_word2vec_loss_falls_and_topics_cluster():
    proc = _run("word2vec", "--smoke", np_ranks=2)
    assert float(proc.stdout.strip().splitlines()[-1]) > 0
    assert "intra-topic" in proc.stderr


def test_long_context_ring_attention_matches_dense_and_ulysses():
    proc = _run("long_context_ring_attention", "--smoke", np_ranks=2)
    assert "ring vs dense max |err|" in proc.stdout
    assert "ulysses vs ring" in proc.stdout
    # The Ulysses check counts its K1-K3 launches; on the CPU the
    # wrappers run their plain versions, which count none.
    line, = [l for l in proc.stdout.splitlines()
             if l.startswith("ulysses kernel launches ")]
    assert json.loads(line.split("launches ", 1)[1]) == {
        "flash_forward": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert "sequence-parallel training OK" in proc.stdout


def test_gpt_parallel_four_ranks():
    """dp=1 x sp=2 x tp=2; the example asserts the NLL halves and the
    decoded successor accuracy exceeds 0.9."""
    proc = _run("gpt_parallel", "--smoke", np_ranks=4)
    assert "mesh dp=1 x sp=2 x tp=2" in proc.stderr
    assert float(proc.stdout.strip().splitlines()[-1]) < 1.0
