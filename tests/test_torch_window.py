"""The port's multi-step windows against ``horovod_tpu.jax.window``.

* ``make_windowed_train_step`` on the small TransformerLM of
  tests/test_torch_transformer.py (the flax weights carried across with
  ``params_from_flax``) against JAX's ``models.make_windowed_train_step``
  on the same numpy tokens: K = 3 over 6 batches, and K = 4 over 6 (a
  trailing window of 2). JAX's step is the image-shaped one
  (``batch["image"]``, ``batch["label"]``); fed ``tokens[:, :-1]`` and
  ``tokens[:, 1:]``, its causal model scores exactly the next-token loss
  the port's LM step takes over ``tokens``. Per-window loss means agree
  to ``rtol 1e-5`` and the final parameters to ``atol 2e-6``, the
  tolerances (and the reason for them) of
  test_torch_transformer.py::test_three_adam_steps_match_jax.
* ``windowed(f, 1) is f``; K < 1 raises; ``stack_batches`` and
  ``repeat_batch`` give the JAX shapes and values; ``run_steps`` over an
  empty iterator is a no-op, and over 5 batches in windows of 2 returns
  the means of the eager steps' metrics, exactly (on the CPU a window
  runs the same step eagerly); the image window's loss and accuracy
  means too; the timeline marks each window, spans its dispatch and its
  boundary sync; ``backward_passes_per_step > 1`` under a window raises.

On the CPU a window runs its step eagerly, since the caller asked for the
CPU: the CUDA graph capture and replay exist only on the card, where
``chip_smoke.py``'s window phase holds a replayed window against the same
number of eager steps bit for bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu.jax.window import repeat_batch as jrepeat_batch
from horovod_tpu.jax.window import stack_batches as jstack_batches
from horovod_tpu.models.transformer import TransformerLM as JLM
from horovod_tpu_torch import distributed as hvd_t
from horovod_tpu_torch._graphs import CapturedStep
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed.window import (repeat_batch, run_steps,
                                                  stack_batches,
                                                  stage_synthetic_window,
                                                  windowed)
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                  flax_parameter_map,
                                                  params_from_flax)

CFG = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
           max_len=32)
N_BATCHES = 6


@pytest.fixture(scope="module")
def token_batches():
    rng = np.random.default_rng(0)
    return rng.integers(0, 32, (N_BATCHES, 2, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params(token_batches):
    params = JLM(**CFG, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(token_batches[0, :, :-1]),
        train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def world():
    """A gloo world of one for the port's collectives."""
    basics.init(device="cpu")
    yield
    basics.shutdown()


def _windows(n, k):
    return [(lo, min(lo + k, n)) for lo in range(0, n, k)]


@pytest.mark.parametrize("k", [3, 4])
def test_windowed_lm_matches_jax_window(hvd, world, flax_params,
                                        token_batches, k):
    jmodel = JLM(**CFG, dtype=jnp.float32)
    state, opt = jmodels.create_train_state(
        jax.random.PRNGKey(0), jmodel, optax.adam(1e-4),
        jnp.asarray(token_batches[0, :, :-1]))
    state["params"] = jax.tree_util.tree_map(jnp.asarray, flax_params)
    jwin = jmodels.make_windowed_train_step(jmodel, opt, k)

    model = params_from_flax(flax_params,
                             TransformerLM(**CFG, dtype=torch.float32,
                                           device="cpu"))
    topt = ttrain.create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-4), device="cpu")
    twin = ttrain.make_windowed_train_step(model, topt, k)

    for lo, hi in _windows(N_BATCHES, k):
        toks = token_batches[lo:hi]
        state, jm = jwin(state, {"image": jnp.asarray(toks[:, :, :-1]),
                                 "label": jnp.asarray(toks[:, :, 1:])})
        tloss = twin(torch.tensor(toks, dtype=torch.long))
        assert tloss.shape == ()
        np.testing.assert_allclose(float(tloss), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"window {lo}-{hi}")
    final = jax.tree_util.tree_map(np.asarray, state["params"])
    moved = 0.0
    for path, p, t in flax_parameter_map(model):
        want = functools.reduce(lambda d, key: d[key], path, final)
        got = p.detach().numpy()
        got = got.T if t else got
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                   err_msg="/".join(path))
        start = functools.reduce(lambda d, key: d[key], path, flax_params)
        moved = max(moved, float(np.abs(got - start).max()))
    assert moved > 4e-4        # six steps of lr 1e-4 really moved them


def test_k1_is_the_identity_and_k_below_1_raises():
    def step(batch):
        return batch

    assert windowed(step, 1) is step
    assert stage_synthetic_window(step, "b", 1) == (step, "b")
    for bad in (0, -2):
        with pytest.raises(ValueError, match=">= 1"):
            windowed(step, bad)
        with pytest.raises(ValueError, match=">= 1"):
            run_steps(step, [], bad, device="cpu")


def test_stack_and_repeat_batch_match_jax():
    rng = np.random.default_rng(3)
    batches = [{"x": rng.standard_normal((2, 3)).astype(np.float32),
                "y": rng.integers(0, 9, (2,))} for _ in range(3)]
    want = jstack_batches([jax.tree_util.tree_map(jnp.asarray, b)
                           for b in batches])
    got = stack_batches([{k: torch.tensor(v) for k, v in b.items()}
                         for b in batches])
    for key in ("x", "y"):
        assert tuple(got[key].shape) == want[key].shape == (3, 2) + (
            (3,) if key == "x" else ())
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    want = jrepeat_batch(jnp.asarray(batches[0]["x"]), 4)
    got = repeat_batch(torch.tensor(batches[0]["x"]), 4)
    assert tuple(got.shape) == want.shape == (4, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="at least one"):
        stack_batches([])


def test_run_steps_over_nothing_is_a_no_op():
    calls = []
    assert run_steps(calls.append, iter([]), 3, device="cpu") == []
    assert run_steps(calls.append, [], 1, device="cpu") == []
    assert calls == []


def _lm_step(seed=0):
    model = TransformerLM(**CFG, dtype=torch.float32, seed=seed,
                          device="cpu")
    opt = ttrain.create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu")
    return model, ttrain.make_train_step(model, opt)


def test_run_steps_means_equal_the_eager_steps(world, token_batches):
    """5 batches in windows of 2 (a tail of 1): each window's mean is the
    mean of the same eager steps' losses, and the parameters end equal,
    exactly: on the CPU a window runs the step eagerly."""
    batches = list(token_batches[:5].astype(np.int64))
    model, step = _lm_step()
    eager = [float(step(torch.tensor(b))) for b in batches]
    want = [p.detach().clone() for p in model.parameters()]
    model, step = _lm_step()
    means = run_steps(step, batches, 2, device="cpu")
    assert len(means) == 3
    for m, (lo, hi) in zip(means, _windows(5, 2)):
        assert float(m) == float(torch.tensor(eager[lo:hi]).sum()
                                 / (hi - lo))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), want))
    per_step = run_steps(step, batches[:2], 1, device="cpu")
    assert len(per_step) == 2 and per_step[0].shape == ()


def test_image_window_means_equal_the_eager_steps(world):
    rng = np.random.default_rng(4)
    batches = [{"image": torch.tensor(rng.standard_normal(
                    (2, 32, 32, 3), dtype=np.float32)),
                "label": torch.tensor(rng.integers(0, 10, 2))}
               for _ in range(3)]

    def build():
        model = resnet.build("resnet18", num_classes=10,
                             dtype=torch.float32, seed=0, device="cpu")
        opt = ttrain.create_train_state(model, torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9), device="cpu")
        return model, opt

    model, opt = build()
    step = ttrain.make_image_train_step(model, opt, average_loss=False)
    eager = [step(b) for b in batches]
    want = [p.detach().clone() for p in model.parameters()]
    model, opt = build()
    win = ttrain.make_windowed_image_train_step(model, opt, 3,
                                                average_loss=False)
    got = win(stack_batches(batches))
    for key in ("loss", "accuracy"):
        assert float(got[key]) == float(
            (eager[0][key] + eager[1][key] + eager[2][key]) / 3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), want))


def _events(path):
    return [json.loads(line.rstrip(",\n"))
            for line in path.read_text().splitlines()[1:]
            if line.strip().rstrip(",")]


def test_run_steps_marks_windows_and_sync_spans(tmp_path, monkeypatch,
                                                token_batches):
    """Each window is marked (WINDOW_START with its index and steps), its
    dispatch spans WINDOW and, with ``sync_each_window``, its boundary
    wait spans WINDOW_SYNC on the ``hvd.window`` track; ``window_sync``
    alone records the same span (tests/test_window.py's pin)."""
    from horovod_tpu_torch.utils.devsync import window_sync
    from horovod_tpu_torch.utils.timeline import Timeline

    path = tmp_path / "trace.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    basics.init(device="cpu")
    try:
        _, step = _lm_step()
        run_steps(step, list(token_batches[:5].astype(np.int64)), 2,
                  sync_each_window=True, device="cpu")
    finally:
        basics.shutdown()
    events = _events(path)
    marks = [e["args"] for e in events if e.get("name") == "WINDOW_START"]
    assert marks == [{"window": 0, "steps": 2}, {"window": 1, "steps": 2},
                     {"window": 2, "steps": 1}]
    for name in ("WINDOW", "WINDOW_SYNC"):
        begins = [e for e in events if e.get("name") == name
                  and e["ph"] == "B"]
        assert len(begins) == 3, name
    syncs = [e["args"] for e in events
             if e.get("name") == "WINDOW_SYNC" and e["ph"] == "B"]
    assert syncs == [{"steps": 2}, {"steps": 2}, {"steps": 1}]

    path = tmp_path / "alone.json"
    tl = Timeline(str(path))
    tl.mark_window(0, 30)
    assert window_sync(torch.ones(4), timeline=tl, steps=30) >= 0.0
    tl.close()
    names = [e.get("name") for e in _events(path)]
    assert "WINDOW_START" in names and "WINDOW_SYNC" in names
    assert window_sync({"a": torch.full((2,), 3.0)}) >= 0.0


def test_backward_passes_per_step_above_one_raises(world):
    model = TransformerLM(**CFG, dtype=torch.float32, device="cpu")
    opt = ttrain.create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-3),
        backward_passes_per_step=2, device="cpu")
    step = ttrain.make_train_step(model, opt)
    with pytest.raises(NotImplementedError,
                       match="backward_passes_per_step=2.*ROADMAP.md Queue 3"):
        windowed(step, 2)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        hvd_t.run_steps(step, [np.zeros((2, 16), np.int64)], 2,
                        device="cpu")


def test_captured_step_runs_eagerly_on_the_cpu():
    """On the CPU a CapturedStep is its function: no warm-up, capture or
    replay; tensors on two devices are refused."""
    seen = []
    cs = CapturedStep(lambda x: seen.append(x) or x * 2)
    out = cs(torch.ones(2))
    assert torch.equal(out, torch.full((2,), 2.0)) and len(seen) == 1
    assert (cs.captures, cs.replays) == (0, 0)
    with pytest.raises(ValueError, match="one device"):
        cs(torch.ones(1), torch.ones(1, device="meta"))
