"""``HOROVOD_AUTOTUNE`` in the port (``horovod_tpu_torch.distributed.
autotune`` and its surrogate ``_bayes``) against the JAX package's
``horovod_tpu.jax.autotune`` and the native ``ei_next``.

Both tuners run under one fake clock (``time.perf_counter`` patched,
which both modules read), where a step's time is a function of the
candidate the step runs under; each test of tests/test_autotune_jax.py
has its counterpart here:

* the sweep converges through a dispatch handle (``spmd_fn`` over
  ``fused_reduce`` on both sides), and the two TSV logs are equal line
  for line;
* the winner reaches the optimizer after the final move: the plan the
  next update runs is ``plan_buckets`` at the winning threshold;
* the EI strategy probes the JAX tuner's candidates in its order and
  picks its winner, on several score curves; ``ei_next`` returns the
  native index on every hypothesis case, the -1 cases included, and the
  GP passes the native self-test;
* the hierarchy flip, with ``_hier_available`` patched alike in both
  packages (a world of one cannot ladder);
* owner handoff: both tuners converge after the same dispatches;
* the tuner changes the optimizer's plan: after each move the plan of
  the next update equals the JAX ``plan_buckets`` at the tuner's
  threshold, issued from the gradient hooks when it has two buckets or
  more; a window call is one dispatch and captures again after a move;
* the env knob creates the tuner at ``init`` and ``shutdown`` closes it;
* ``end_window`` waits for the output before it reads the clock;
* a quantized ladder under the tuner: the JAX package fails at the move
  (its residuals are laid out for the old plan), the port raises
  ``NotImplementedError`` when the optimizer is built.

The slice as a whole: the small TransformerLM of
tests/test_torch_transformer.py trained under the tuner ends bit-equal
to the untuned run, with losses within ``rtol 1e-5`` of the JAX lane's
step and parameters within ``atol 2e-6`` (that test's tolerances). In a
gloo world of two ranks with different clocks (``start_world`` over
tests/torch_autotune_ranks.py, which imports no JAX), both ranks probe
rank 0's sequence, take its float32 scores and its winner, only rank 0
writes the log, and the tuned parameters equal the untuned ones bit for
bit.
"""

import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

import horovod_tpu.jax as jhvd
from horovod_tpu import models as jmodels
from horovod_tpu.common.state import global_state
from horovod_tpu.jax import autotune as jat
from horovod_tpu.jax.fusion import fused_reduce as jfused_reduce
from horovod_tpu.jax.fusion import plan_buckets as jplan_buckets
from horovod_tpu.models.transformer import TransformerLM as JLM
from horovod_tpu_torch import distributed as thvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed import _bayes
from horovod_tpu_torch.distributed import autotune as tat
from horovod_tpu_torch.distributed import fusion as tfusion
from horovod_tpu_torch.distributed import optimizer as toptimizer
from horovod_tpu_torch.distributed.window import _signature_key, windowed
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                  flax_parameter_map,
                                                  params_from_flax)

from test_torch_tp import start_world
from torch_autotune_ranks import MB, Clock, make_net, net_loss, xform

CFG = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
           max_len=32)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


@pytest.fixture(autouse=True)
def _restore_jax(hvd):
    """Every JAX tuner writes the live config; put it back."""
    st_ = global_state()
    cfg = st_.config
    saved = (cfg.fusion_threshold, cfg.hierarchical_allreduce,
             cfg.hierarchical_inner_size, cfg.hierarchical)
    yield
    st_.autotuner = None
    (cfg.fusion_threshold, cfg.hierarchical_allreduce,
     cfg.hierarchical_inner_size, cfg.hierarchical) = saved


@pytest.fixture
def world():
    """The port's gloo world of one; its config is fresh each time."""
    basics.init(device="cpu")
    yield basics.config()
    basics.shutdown()


def _install(tuner):
    basics._state.autotuner = tuner
    return tuner


# Step times (s) as functions of (threshold, hierarchical).
CURVES = {
    "valley_8mb": lambda t, h: 1.0 + (xform(t) - math.log2(9.0)) ** 2,
    "bumpy": lambda t, h: 1.0 + 0.3 * math.sin(3.0 * xform(t)) + 0.05 * xform(t),
    "falling": lambda t, h: 2.0 - 0.1 * xform(t),
}


def _drive(tuner, cfg, clock, curve, limit=400):
    """Step ``tuner`` directly, each step taking ``curve``'s time for the
    candidate it runs under; returns the steps taken."""
    for steps in range(1, limit + 1):
        clock.now += curve(cfg.fusion_threshold, cfg.hierarchical_allreduce)
        if tuner.step_done():
            tuner.end_window()
        if tuner.converged:
            return steps
    raise AssertionError("the tuner never converged")


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _plan(plan):
    return [tuple(b) for b in plan]


# ------------------------------------------------------------ the sweep


def test_sweep_converges_and_logs_equal_the_jax_tuners(world, clock,
                                                       tmp_path):
    """tests/test_autotune_jax.py::test_step_autotuner_sweeps_and_converges
    on both sides, through an ``spmd_fn`` handle over ``fused_reduce``."""
    curve = CURVES["falling"]
    jcfg = global_state().config
    logs, winners = {}, {}
    for side in ("jax", "torch"):
        clock.now = 0.0
        cfg = jcfg if side == "jax" else world
        path = str(tmp_path / f"{side}.tsv")
        if side == "jax":
            tuner = jat.StepAutotuner(cfg, log_path=path,
                                      candidates=[0, 64 * MB], window=2)
            global_state().autotuner = tuner

            def step(x, y):
                a, b = jfused_reduce([x, y], average=False)
                return a + 1.0, b + 1.0

            run = jhvd.spmd_fn(step, in_specs=(JP(), JP()),
                               out_specs=(JP(), JP()))
            x, y = jnp.ones((64,), jnp.float32), jnp.ones((32,), jnp.float32)
        else:
            tuner = _install(tat.StepAutotuner(
                cfg, log_path=path, candidates=[0, 64 * MB], window=2))

            def step(x, y):
                a, b = thvd.fused_reduce([x, y], average=False)
                return a + 1.0, b + 1.0

            run = thvd.spmd_fn(step)
            x, y = torch.ones(64), torch.ones(32)
        for _ in range(40):
            clock.now += curve(cfg.fusion_threshold, False)
            x, y = run(x, y)
            if tuner.converged:
                break
        assert tuner.converged
        assert cfg.fusion_threshold == tuner.best_threshold
        assert np.isfinite(np.asarray(x)).all()
        logs[side] = _lines(path)
        winners[side] = (tuner.best_threshold, tuner.best_score)
    assert logs["torch"] == logs["jax"]
    kinds = [ln.split("\t")[1] for ln in logs["torch"]]
    assert kinds.count("sample") == 2 and kinds[-1] == "converged"
    assert winners["torch"] == winners["jax"]


# ------------------------------------------ the optimizer's bucket plans


def _jleaves(net):
    return [jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32) for p in net]


@pytest.fixture
def executed(monkeypatch):
    """The plan of every reduction the optimizer runs, in order."""
    plans = []
    finish = tfusion.BucketExchange.finish

    def spy(self, fetch):
        if self._name == "grads":
            plans.append(_plan(self.plan))
        return finish(self, fetch)

    monkeypatch.setattr(tfusion.BucketExchange, "finish", spy)
    return plans


def test_winner_applied_to_the_optimizer_after_convergence(world, clock,
                                                           executed):
    """tests/test_autotune_jax.py::test_winner_applied_to_dispatch_after_
    convergence: the final move (the winner) re-plans the next update."""
    tuner = _install(tat.StepAutotuner(world, candidates=[0, 64 * MB],
                                       window=1))
    net = make_net()
    opt = thvd.DistributedOptimizer(torch.optim.SGD(net.parameters(),
                                                    lr=0.1))
    curve = CURVES["falling"]
    for i in range(20):
        clock.now += curve(world.fusion_threshold, False)
        opt.zero_grad()
        net_loss(net, i).backward()
        opt.step()
        if tuner.converged:
            break
    assert tuner.converged
    opt.zero_grad()
    net_loss(net, 99).backward()
    opt.step()                  # the first update after the final move
    assert executed[-1] == _plan(jplan_buckets(_jleaves(net),
                                                  tuner.best_threshold))
    assert tuner.best_threshold == 64 * MB   # "falling": larger is faster


@pytest.mark.parametrize("candidates", [
    [0, 4096, 16384, 64 * MB],
    [16384, 0, 12288, 2048, 4096],
], ids=["sweep", "ei"])
def test_the_tuner_changes_the_optimizers_plan(world, clock, executed,
                                               candidates):
    """tests/test_autotune_jax.py::test_tuner_changes_bucket_plan: after
    each move, the next update runs the JAX ``plan_buckets`` at the
    tuner's threshold; with two buckets or more the gradient hooks issue
    every bucket during the backward pass (the hooks follow the new
    exchange)."""
    tuner = _install(tat.StepAutotuner(world, candidates=candidates,
                                       window=1))
    net = make_net()
    opt = thvd.DistributedOptimizer(torch.optim.SGD(net.parameters(),
                                                    lr=0.1))
    seen = set()
    for i in range(40):
        threshold = world.fusion_threshold
        clock.now += CURVES["bumpy"](threshold, False)
        opt.zero_grad()
        net_loss(net, i).backward()
        want = _plan(jplan_buckets(_jleaves(net), threshold))
        if len(want) > 1:
            # The hooks planned the new exchange and issued every bucket.
            assert _plan(opt._hvd_exchange.plan) == want
            assert opt._hvd_exchange._issued == len(want)
        else:
            assert opt._hvd_exchange is None
        opt.step()
        assert executed[-1] == want, (i, threshold)
        seen.add(len(want))
        if tuner.converged and i > 2 * len(candidates) + 2:
            break
    assert tuner.converged and len(seen) >= 3
    assert len(tuner.probed) == (len(candidates) if len(candidates) < 5
                                 else tuner.max_probes)


def test_a_window_call_is_one_dispatch_and_keys_on_the_generation(
        world, clock):
    """Under a window (the CPU runs its steps eagerly) the window call is
    the handle: the optimizer's steps inside it are not counted, and the
    capture's signature moves with the tuner's generation."""
    tuner = _install(tat.StepAutotuner(world, candidates=[0, 64 * MB],
                                       window=3))
    net = make_net()
    opt = thvd.DistributedOptimizer(torch.optim.SGD(net.parameters(),
                                                    lr=0.1))

    def step(batch):
        opt.zero_grad()
        loss = net_loss(net, int(batch))
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    step.optimizer = opt
    window = windowed(step, 4)
    key = _signature_key(step)
    k0 = key()

    def win():
        clock.now += 1.0
        return window(torch.arange(4.0))

    win()
    win()
    assert tuner._steps_in_window == 2 and tuner.generation == 1
    win()                           # the window's end: the warm-up
    win()
    win()
    win()                           # the scored window: a move
    assert tuner.generation == 2 and key() != k0
    # An spmd_fn region around a step counts once as well.
    tuner = _install(tat.StepAutotuner(world, candidates=[0, 64 * MB],
                                       window=3))
    run = thvd.spmd_fn(lambda b: step(b)["loss"])
    run(torch.tensor(1.0))
    assert tuner._steps_in_window == 1 and tuner._owner is run


# ---------------------------------------------------------- EI and GP


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_ei_strategy_probes_the_jax_sequence(world, clock, curve):
    """tests/test_autotune_jax.py::test_ei_strategy_converges_near_optimum
    _with_fewer_probes: the same 9 candidates, the same probes in the
    same order, the same scores and winner."""
    got = {}
    for side, mod, cfg in (("jax", jat, global_state().config),
                           ("torch", tat, world)):
        clock.now = 0.0
        tuner = mod.StepAutotuner(cfg, window=1, strategy="ei")
        steps = _drive(tuner, cfg, clock, CURVES[curve])
        got[side] = (tuner.candidates, list(tuner.probed.items()),
                     tuner.best_threshold, tuner.max_probes, steps)
        assert cfg.fusion_threshold == tuner.best_threshold
    assert got["torch"] == got["jax"]
    cands, probed, best, max_probes, _ = got["torch"]
    assert len(cands) == 9 and len(probed) == max_probes == 6
    if curve == "valley_8mb":
        assert best in (4 * MB, 8 * MB, 16 * MB)


_POS = st.one_of(st.integers(0, 8).map(float),
                 st.floats(-20.0, 20.0, allow_nan=False))


@settings(max_examples=300, deadline=None, database=None)
@given(xs=st.lists(_POS, max_size=12),
       ys=st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=12,
                   max_size=12),
       cands=st.lists(_POS, max_size=12),
       xi=st.sampled_from([0.0, 0.01, 0.5]))
def test_ei_next_equals_the_native_index(xs, ys, cands, xi):
    """The port's ``ei_next`` against ``horovod_tpu.native.ei_next`` (the
    C++ surrogate, built here with g++): fewer than 2 observations, no
    candidate and a span of 0 give -1 on both sides."""
    from horovod_tpu import native

    ys = ys[:len(xs)]
    want = native.ei_next(xs, ys, cands, xi)
    assert _bayes.ei_next(xs, ys, cands, xi) == want
    if len(xs) < 2 or not cands or max(xs + cands) == min(xs + cands):
        assert want == -1


def test_ei_next_picks_near_the_observed_peak():
    """tests/test_autotune_jax.py::test_native_ei_next_suggests_near_peak."""
    cands = [1.0, 3.0, 5.0, 7.0]
    i = _bayes.ei_next([0.0, 9.0, 4.0], [1.0, 2.0, 8.0], cands)
    assert cands[i] in (3.0, 5.0)


def test_gp_passes_the_native_self_test():
    """``hvdtpu_gp_selftest`` (csrc/c_api.cc): the fitted length scale is
    shorter for a wiggly target than for a linear one, and both fits
    interpolate."""
    from horovod_tpu import native

    xs = [[i / 19.0] for i in range(20)]
    lin, wig = _bayes.GaussianProcess(), _bayes.GaussianProcess()
    assert lin.fit_with_hyperparameters(xs, [2.0 * x - 1.0 for x, in xs])
    assert wig.fit_with_hyperparameters(
        xs, [math.sin(12.0 * x) for x, in xs])
    assert wig.length_scale < lin.length_scale
    assert abs(lin.predict([0.5])[0]) <= 0.05
    assert abs(wig.predict([0.125])[0] - math.sin(1.5)) <= 0.1
    assert native.load_library().hvdtpu_gp_selftest() == 1


def test_cholesky_refuses_a_matrix_that_is_not_positive_definite():
    a = [1.0, 2.0, 2.0, 1.0]
    assert not _bayes.cholesky_factor(a, 2)
    a = [4.0, 2.0, 2.0, 3.0]
    assert _bayes.cholesky_factor(a, 2)
    assert a == [2.0, 0.0, 1.0, math.sqrt(2.0)]
    assert _bayes.ei_next([0.0, 0.0], [1.0, 2.0], [0.0]) == -1


# ---------------------------------------------- hierarchy and handoff


@pytest.mark.parametrize("strategy", ["sweep", "ei"])
@pytest.mark.parametrize("hier_faster", [True, False])
def test_tuner_flips_hierarchy_by_measured_speed(world, clock, monkeypatch,
                                                 strategy, hier_faster):
    """tests/test_autotune_jax.py::test_tuner_flips_hierarchy_by_measured_
    speed with ``_hier_available`` patched alike: the same 18 candidates
    and probes, the winner's category, and the tri-state knob pinned."""
    monkeypatch.setattr(jat, "_hier_available", lambda st_: True)
    monkeypatch.setattr(tat, "_hier_available", lambda: True)

    def curve(t, h):
        base = 1.0 + 0.01 * xform(t)
        return base * (0.5 if h == hier_faster else 1.0)

    got = {}
    for side, mod, cfg in (("jax", jat, global_state().config),
                           ("torch", tat, world)):
        clock.now = 0.0
        cfg.fusion_threshold = 8 * MB
        cfg.hierarchical_allreduce = False
        tuner = mod.StepAutotuner(cfg, window=1, strategy=strategy)
        _drive(tuner, cfg, clock, curve)
        got[side] = (tuner.candidates, list(tuner.probed),
                     tuner.best_threshold, tuner.best_hierarchical)
        assert cfg.hierarchical_allreduce is hier_faster
        assert cfg.hierarchical == ("on" if hier_faster else "off")
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == 18
    assert got["torch"][3] is hier_faster


def test_owner_hands_off_when_the_first_handle_goes_idle(world, clock):
    """tests/test_autotune_jax.py::test_owner_handoff_when_first_handle_
    goes_idle: a handle that dispatches once and never again, then the
    training handle; both packages converge after the same dispatches."""
    import horovod_tpu.jax as jhvd

    got = {}
    for side in ("jax", "torch"):
        clock.now = 0.0
        if side == "jax":
            cfg = global_state().config
            tuner = jat.StepAutotuner(cfg, candidates=[0, 64 * MB],
                                      window=1)
            global_state().autotuner = tuner

            def step(x):
                return jfused_reduce([x], average=False)[0] * 0.5

            warmup = jhvd.spmd_fn(step, in_specs=JP(), out_specs=JP())
            train = jhvd.spmd_fn(step, in_specs=JP(), out_specs=JP())
            x = jnp.ones((16,), jnp.float32)
        else:
            cfg = world
            tuner = _install(tat.StepAutotuner(cfg, candidates=[0, 64 * MB],
                                               window=1))

            def step(x):
                return thvd.fused_reduce([x], average=False)[0] * 0.5

            warmup, train = thvd.spmd_fn(step), thvd.spmd_fn(step)
            x = torch.ones(16)
        warmup(x)
        for calls in range(1, 31):
            clock.now += CURVES["falling"](cfg.fusion_threshold, False)
            x = train(x)
            if tuner.converged:
                break
        assert tuner.converged, "tuner stalled on an idle owner"
        assert cfg.fusion_threshold == tuner.best_threshold
        got[side] = (calls, tuner.best_threshold, list(tuner.probed))
    assert got["torch"] == got["jax"]


# ------------------------------------------- init, the clock, the ladder


def test_env_knob_creates_the_tuner_and_shutdown_closes_it(monkeypatch,
                                                           tmp_path):
    """tests/test_autotune_jax.py::test_env_knob_creates_tuner:
    ``HOROVOD_AUTOTUNE=1`` makes ``init`` create a ``StepAutotuner`` over
    the JAX default space (no raise), ``HOROVOD_AUTOTUNE_LOG`` gets the
    log, and ``shutdown`` drops the tuner."""
    log = tmp_path / "env_autotune.tsv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    basics.init(device="cpu")
    try:
        tuner = basics._state.autotuner
        assert isinstance(tuner, tat.StepAutotuner)
        assert tat.active() is tuner and tat.generation() == 1
        jtuner = jat.StepAutotuner(global_state().config)
        assert (tuner.candidates, tuner.max_probes,
                tuner._strategy_resolved) == (
            jtuner.candidates, jtuner.max_probes,
            jtuner._strategy_resolved)
        tuner.window = 1
        tuner.candidates = tuner.candidates[:2]
        run = thvd.spmd_fn(
            lambda x: thvd.fused_reduce([x], average=False)[0] * 0.5)
        x = torch.ones(16)
        for _ in range(10):
            x = run(x)
            if tuner.converged:
                break
        assert tuner.converged
    finally:
        basics.shutdown()
    assert basics._state.autotuner is None and tat.active() is None
    assert "converged" in log.read_text()
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "0")
    basics.init(device="cpu")
    try:
        assert tat.active() is None and tat.generation() == 0
    finally:
        basics.shutdown()


def test_end_window_syncs_before_it_reads_the_clock(world, monkeypatch):
    """tests/test_autotune_jax.py::test_end_window_forces_device_sync_
    before_clock: ``end_window(out)`` waits on ``out`` through
    ``utils.devsync.window_sync`` first; the score comes from a later
    clock read."""
    from horovod_tpu_torch.utils import devsync

    clock = [0.0]

    def tick():
        clock[0] += 1.0
        return clock[0]

    monkeypatch.setattr(time, "perf_counter", tick)
    events = []
    sync = devsync.window_sync

    def recording(tree, *a, **k):
        events.append(("sync", clock[0], tree))
        return sync(tree, *a, **k)

    monkeypatch.setattr(devsync, "window_sync", recording)
    tuner = tat.StepAutotuner(world, candidates=[world.fusion_threshold],
                              window=1)
    out = {"loss": torch.ones(())}
    assert tuner.step_done()
    tuner.end_window(out)           # warm-up
    events.clear()
    assert tuner.step_done()
    tuner.end_window(out)
    assert events and events[0][2] is out
    assert tuner.converged and clock[0] > events[0][1]
    assert tuner.best_score > 0


def test_quantized_ladder_under_the_tuner(world, monkeypatch):
    """With ``Compression.int8`` on an engaged ladder the error-feedback
    residuals are laid out for one plan. The JAX package fails at the
    first move to another threshold (fusion.py's layout check); the port
    refuses the optimizer at once, while a flat int8 optimizer under the
    tuner and a ladder without the tuner are built."""
    import horovod_tpu.jax as jhvd
    from horovod_tpu.jax.fusion import ef_residual_specs

    st_ = global_state()
    cfg = st_.config
    cfg.hierarchical_inner_size = 4
    cfg.fusion_threshold, cfg.hierarchical_allreduce = 0, True
    bases = [np.ones(s, np.float32) for s in (100, 300, 50)]
    leaves = [jax.ShapeDtypeStruct(b.shape, jnp.float32) for b in bases]
    res0 = tuple(jnp.zeros(s.shape, s.dtype)
                 for s in ef_residual_specs(leaves, 0, 8, 4))
    spec = tuple(JP("hvd") for _ in res0)
    st_.autotuner = jat.StepAutotuner(
        cfg, candidates=[(0, True), (64 * MB, True)], window=1)

    def step(res):
        ts = [jnp.asarray(b) for b in bases]
        out, new = jfused_reduce(ts, average=True,
                                 compression=jhvd.Compression.int8,
                                 residuals=res)
        return tuple(out), new

    run = jhvd.spmd_fn(step, in_specs=(spec,),
                       out_specs=((JP(),) * len(bases), spec))
    res = res0
    _, res = run(res)                # warm-up window
    _, res = run(res)                # scored: the tuner moves to 64 MB
    with pytest.raises(Exception, match="error-feedback residuals"):
        run(res)

    net = make_net()
    int8 = thvd.Compression.int8
    _install(tat.StepAutotuner(world, candidates=[0, 64 * MB], window=1))
    thvd.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.1),
                              compression=int8)     # flat: no residuals
    monkeypatch.setattr(toptimizer, "resolve_hierarchical",
                        lambda mode, n: 2)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        thvd.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.1),
                                  compression=int8)
    monkeypatch.undo()
    _install(tat.StepAutotuner(world, candidates=[(0, False), (0, True)],
                               window=1))
    with pytest.raises(NotImplementedError, match="one bucket plan"):
        thvd.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.1),
                                  compression=int8)


# ------------------------------------------------------ the whole slice


@pytest.fixture(scope="module")
def lm_tokens():
    return np.random.default_rng(0).integers(0, 32, (2, 16)).astype(np.int32)


def _lm_run(flax_params, tokens, steps, tuner, clock):
    """``steps`` Adam steps of the port's LM lane on one batch, under
    ``tuner`` (or none); returns the losses and the model."""
    model = params_from_flax(flax_params, TransformerLM(
        **CFG, dtype=torch.float32, device="cpu"))
    opt = ttrain.create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-4), device="cpu")
    step = ttrain.make_train_step(model, opt)
    tt = torch.tensor(tokens, dtype=torch.long)
    losses = []
    for _ in range(steps):
        if tuner is not None:
            clock.now += CURVES["bumpy"](basics.config().fusion_threshold,
                                         False)
        losses.append(float(step(tt)))
    return losses, model


def test_lm_under_the_tuner_equals_the_untuned_run_and_the_jax_step(
        world, clock, lm_tokens):
    """The slice on the CPU: 12 steps of the small LM while the tuner
    sweeps five thresholds (window 1) that give the LM's 27 tensors 27,
    16, 12, 5 and 1 buckets; the parameters equal the untuned run's bit
    for bit, and the losses and parameters match the JAX lane's step."""
    jmodel = JLM(**CFG, dtype=jnp.float32)
    state, opt = jmodels.create_train_state(
        jax.random.PRNGKey(0), jmodel, optax.adam(1e-4),
        jnp.asarray(lm_tokens))
    start = jax.tree_util.tree_map(np.asarray, state["params"])
    steps = 12
    tuner = _install(tat.StepAutotuner(
        world, candidates=[0, 2048, 4096, 8192, 64 * MB], window=1,
        strategy="sweep"))
    tuned, model_t = _lm_run(start, lm_tokens, steps, tuner, clock)
    assert tuner.converged and len(tuner.probed) == 5
    basics._state.autotuner = None
    world.fusion_threshold = 64 * MB
    untuned, model_u = _lm_run(start, lm_tokens, steps, None, clock)
    assert tuned == untuned
    for a, b in zip(model_t.parameters(), model_u.parameters()):
        assert torch.equal(a, b)

    jt = jnp.asarray(lm_tokens)

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jt, train=False)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        return jnp.mean(-jnp.take_along_axis(logp, jt[:, 1:, None], -1))

    @jax.jit
    def step(s):
        loss, grads = jax.value_and_grad(loss_fn)(s["params"])
        return loss, jmodels.apply_gradients(opt, s, grads)

    for i in range(steps):
        jloss, state = step(state)
        np.testing.assert_allclose(tuned[i], float(jloss), rtol=1e-5)
    final = jax.tree_util.tree_map(np.asarray, state["params"])
    for path, p, t in flax_parameter_map(model_t):
        want = functools.reduce(lambda d, k: d[k], path, final)
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if t else got, want, rtol=0,
                                   atol=2e-6, err_msg="/".join(path))


def test_bench_lm_lane_tunes_under_the_env_knob(monkeypatch):
    """``HOROVOD_AUTOTUNE=1`` tunes the bench's LM lane with no new flag;
    the record's ``buckets`` stamp is the plan at the threshold the run
    started with, as the JAX bench stamps it before its timed windows."""
    from horovod_tpu_torch import bench

    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    args = bench.build_parser().parse_args([
        "--seq-len", "16", "--batch-size", "2", "--lm-layers", "2",
        "--lm-dim", "16", "--lm-heads", "2", "--vocab", "32", "--fp32",
        "--num-warmup-batches", "1", "--num-batches-per-iter", "10",
        "--num-iters", "3"])
    try:
        rec = bench.run(args, device="cpu")
        tuner = tat.active()
        default = tuner.candidates[0][0]
        assert tuner._samples >= 3 and tuner.generation >= 2
    finally:
        basics.shutdown()
    model = TransformerLM(vocab_size=32, num_layers=2, num_heads=2,
                          embed_dim=16, max_len=2048, dtype=torch.float32,
                          device="cpu")
    assert rec["buckets"] == tfusion.plan_summary(tfusion.plan_buckets(
        list(model.parameters()), default))
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]


# --------------------------------------------------- two ranks over gloo


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("autotune")
    return out, start_world(2, str(out), "torch_autotune_ranks")


def test_two_ranks_follow_rank_0(two_ranks):
    out, ranks = two_ranks
    r0, r1 = ranks
    assert r0["converged"] and r1["converged"]
    assert r1["probed"] == r0["probed"] and r1["best"] == r0["best"]
    assert r0["threshold"] == r1["threshold"] == r0["best"][0]
    # Rank 0's float32 score reached both ranks; rank 1 measured others.
    want = [float(np.float32(v)) for v in r0["raw"]]
    assert r0["synced"] == want and r1["synced"] == want
    assert r1["raw"] != r0["raw"]
    assert [v for _, v in r0["probed"]] == want
    assert len(r0["probed"]) == 5
    assert (out / "log0.tsv").exists() and not (out / "log1.tsv").exists()
    lines = _lines(out / "log0.tsv")
    assert [ln.split("\t")[1] for ln in lines] == \
        ["warmup", "sample"] * 5 + ["converged"]


def test_two_ranks_tuned_equal_untuned(two_ranks):
    _, (r0, r1) = two_ranks
    assert r0["tuned_equals_untuned"] and r1["tuned_equals_untuned"]
    for a, b in zip(r0["tuned"], r1["tuned"]):
        np.testing.assert_array_equal(a, b)
