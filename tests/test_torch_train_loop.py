"""Parity of the port's train state and training loop
(``horovod_tpu_torch.models.train``: ``TrainState``, ``apply_gradients``,
``state_partition_specs``; ``horovod_tpu_torch.training``: ``TrainLoop``,
the callbacks, the hyperparameter surgery) with the JAX package's
(``horovod_tpu.models.train``, ``horovod_tpu.flax``).

Inputs come from numpy seeds and go to both packages. Tolerances, float32
throughout: the applied learning rate is the same float32 on both sides
(each side rounds the same Python float), so it is compared exactly; the
updates differ in the order of float32 operations (optax ``params +
(-lr * trace)`` against torch's ``add_(buf, alpha=-lr)``; Adam's bias
corrections applied before or after the square root). Observed on the
CPU: parameters within 1.2e-7 (SGD) and 1.9e-8 (Adam) absolute after
three updates, the linear problem's epoch losses and weights within
5.9e-7 relative, the 2-layer LM's losses within 9.6e-7 absolute; pinned
at rtol 1e-5 and atol 1e-6, and the LM's losses at 1e-5 absolute.

One gloo world of two ranks serves the module (``start_world``): the
broadcast, the metric average and the warmup at size 2 against their
closed forms.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_tp import start_world

LR = 0.05
N, F = 64, 6                       # the linear problem's rows, features


def _linear_problem(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(F).astype(np.float32)
    X = rng.standard_normal((N, F)).astype(np.float32)
    return X, (X @ w).astype(np.float32)


class _Linear(torch.nn.Module):
    def __init__(self, w=None):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(F) if w is None
                                    else torch.as_tensor(w).clone())


def _torch_step(opt):
    from horovod_tpu_torch.models.train import apply_gradients

    def step(state, batch):
        X, y = batch
        w = state["params"]["w"]
        loss = ((X @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        apply_gradients(opt, state, {"w": g})
        return state, {"loss": loss.detach()}

    return step


def _jax_step(optimizer):
    import jax
    import jax.numpy as jnp
    import optax

    def step(state, batch):
        X, y = batch

        def loss_fn(p):
            return jnp.mean((X @ p - y) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = optimizer.update(g, state["opt_state"],
                                              state["params"])
        return {"params": optax.apply_updates(state["params"], updates),
                "opt_state": opt_state}, {"loss": loss}

    return step


def _sgd_state(lr=LR, momentum=0.9):
    from horovod_tpu_torch.models.train import TrainState

    model = _Linear()
    opt = torch.optim.SGD(model.parameters(), lr=torch.tensor(lr),
                          momentum=momentum)
    return model, opt, TrainState.from_model(model, opt)


# ------------------------------------------------------------ TrainState


class _Net(torch.nn.Module):
    """Two layers and a BatchNorm (buffers for ``batch_stats``)."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = torch.nn.Linear(5, 4)
        self.bn = torch.nn.BatchNorm1d(4)
        self.fc2 = torch.nn.Linear(4, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        return self.fc2(torch.relu(self.bn(self.fc1(x))))


def _net_loss(model, seed=1):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 5)).astype(np.float32))
    return model(x).square().mean()


def test_train_state_leaves_are_the_live_tensors():
    from horovod_tpu_torch.models.train import TrainState

    model = _Net()
    lr = torch.tensor(1e-2)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    state = TrainState.from_model(model, opt)
    assert list(state) == ["params", "batch_stats", "opt_state", "step"]
    for name, p in model.named_parameters():
        assert state["params"][name] is p
        for k, t in opt.state[p].items():
            assert state["opt_state"][name][k] is t
    for name, b in model.named_buffers():
        assert state["batch_stats"][name] is b
    assert state["opt_state"]["hyperparams"][0]["lr"] is lr
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    # An update in place is what the view reads next.
    loss = _net_loss(model)
    loss.backward()
    opt.step()
    for name, p in model.named_parameters():
        assert int(state["opt_state"][name]["step"]) == 1
        assert torch.equal(state["opt_state"][name]["exp_avg"],
                           opt.state[p]["exp_avg"])
    assert int(model.bn.num_batches_tracked) == 1 == \
        int(state["batch_stats"]["bn.num_batches_tracked"])


def test_flatten_orders_keys_as_the_jax_train_state():
    import jax

    from horovod_tpu.models.train import TrainState as JTrainState
    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.models.train import TrainState

    model = _Net()
    opt = torch.optim.SGD(model.parameters(), lr=torch.tensor(0.1),
                          momentum=0.9)
    state = TrainState.from_model(model, opt, step=7)
    leaves, spec = flatten(state)

    def numpy_tree(tree):
        if isinstance(tree, dict):
            return {k: numpy_tree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [numpy_tree(v) for v in tree]
        return tree.detach().numpy().copy()

    jstate = JTrainState(**{k: numpy_tree(v) for k, v in state.items()})
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(jleaves) == len(leaves)
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    # torch's own pytree knows the class too, with sorted keys.
    flat, tspec = torch.utils._pytree.tree_flatten(state)
    assert tspec.context == sorted(state)
    back = torch.utils._pytree.tree_unflatten(flat, tspec)
    assert type(back) is TrainState and back["step"] is state["step"]
    assert type(torch.utils._pytree.tree_unflatten(leaves, spec)) \
        is TrainState


_OPTIMIZERS = {
    "adam": lambda ps: torch.optim.Adam(ps, lr=torch.tensor(1e-2)),
    "adamw_amsgrad": lambda ps: torch.optim.AdamW(ps, lr=1e-2,
                                                  weight_decay=0.1,
                                                  amsgrad=True),
    "sgd_momentum": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
    "sgd_nesterov": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9,
                                               nesterov=True),
    "sgd_plain": lambda ps: torch.optim.SGD(ps, lr=0.1),
}


@pytest.mark.parametrize("kind", sorted(_OPTIMIZERS))
def test_eager_state_equals_what_a_first_step_builds(kind):
    from horovod_tpu_torch.models.train import TrainState

    runs = []
    for eager in (True, False):
        model = _Net()
        opt = _OPTIMIZERS[kind](model.parameters())
        if eager:
            TrainState.from_model(model, opt)
        for s in range(2):
            opt.zero_grad()
            _net_loss(model, seed=s).backward()
            opt.step()
        runs.append((model, opt))
    (m1, o1), (m2, o2) = runs
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p1, p2)
        assert sorted(o1.state[p1]) == sorted(o2.state[p2])
        for k in o1.state[p1]:
            assert torch.equal(o1.state[p1][k], o2.state[p2][k]), k
            assert o1.state[p1][k].dtype == o2.state[p2][k].dtype
            assert o1.state[p1][k].device == o2.state[p2][k].device


def test_dampening_and_other_optimizers_raise():
    from horovod_tpu_torch.models.train import TrainState

    model = _Net()
    with pytest.raises(ValueError, match="dampening"):
        TrainState.from_model(model, torch.optim.SGD(
            model.parameters(), lr=0.1, momentum=0.9, dampening=0.5))
    with pytest.raises(NotImplementedError, match="RMSprop"):
        TrainState.from_model(model, torch.optim.RMSprop(
            model.parameters(), lr=0.1))


def test_checkpoint_and_snapshot_round_trip_of_a_live_state(tmp_path):
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.models.train import TrainState

    model = _Net()
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(1e-2))
    state = TrainState.from_model(model, opt)

    def train(n):
        for s in range(n):
            opt.zero_grad()
            _net_loss(model, seed=s).backward()
            opt.step()
            state["step"].add_(1)

    train(2)
    saved = [t.clone() for t in flatten(state)[0]]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), backend="numpy")
    ckpt.save(2, state)
    snap = elastic.Snapshotter(
        CheckpointManager(str(tmp_path / "snap"), backend="numpy"),
        every=2)
    assert snap.maybe(2, state)
    train(1)
    assert not torch.equal(flatten(state)[0][-1], saved[-1])
    restored = ckpt.restore(2, template=state)
    snapped, manifest = snap.restore(state)
    assert manifest.step == 2
    for tree in (restored, snapped):
        assert type(tree) is TrainState
        for got, want in zip(flatten(tree)[0], saved):
            assert torch.equal(got, want) and got.dtype == want.dtype


# ------------------------------------------------------- apply_gradients


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(3).astype(np.float32),
            "w": rng.standard_normal((4, 3)).astype(np.float32)}


@pytest.mark.parametrize("source", ["grads", "backward"])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_apply_gradients_matches_the_reference(kind, source):
    """``source``: the gradients by name, or ``grads=None`` over the
    ``.grad`` that ``backward()`` of ``sum(p * g)`` leaves (exactly g)."""
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models.train import TrainState as JTrainState
    from horovod_tpu.models.train import apply_gradients as japply
    from horovod_tpu_torch.models.train import TrainState, apply_gradients

    init = _grads(100)
    jopt = (optax.sgd(0.1, momentum=0.9) if kind == "sgd"
            else optax.adam(1e-3))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = JTrainState(params=jparams, batch_stats={},
                         opt_state=jopt.init(jparams),
                         step=jnp.zeros((), jnp.int32))

    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in init.items()})
    opt = (torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
           if kind == "sgd" else torch.optim.Adam(model.parameters(),
                                                  lr=1e-3))
    state = TrainState.from_model(model, opt)
    for s in range(3):
        g = _grads(s)
        jstate = japply(jopt, jstate, {k: jnp.asarray(v)
                                       for k, v in g.items()})
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if source == "grads":
            out = apply_gradients(opt, state, tg)
        else:
            opt.zero_grad()
            sum((state["params"][k] * v).sum() for k, v in tg.items()
                ).backward()
            out = apply_gradients(opt, state)
        assert out is state
    assert int(state["step"]) == int(jstate["step"]) == 3
    for k in init:
        np.testing.assert_allclose(state["params"][k].detach().numpy(),
                                   np.asarray(jstate["params"][k]),
                                   rtol=1e-5, atol=1e-6)


def test_apply_gradients_copies_batch_stats():
    from horovod_tpu_torch.models.train import TrainState, apply_gradients

    model = _Net()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = TrainState.from_model(model, opt)
    mean = torch.arange(4.0)
    apply_gradients(opt, state, {}, batch_stats={"bn.running_mean": mean})
    assert torch.equal(model.bn.running_mean, mean)
    assert state["batch_stats"]["bn.running_mean"] is \
        model.bn.running_mean


# ------------------------------------------------- state_partition_specs


class _WithResiduals(torch.optim.Adam):
    """An optimizer that holds error-feedback residuals, as
    ``DistributedOptimizer`` does on a quantized ladder."""

    def __init__(self, params, **kw):
        super().__init__(params, **kw)
        self.residuals = [torch.zeros(6), torch.zeros(2)]


def test_state_partition_specs():
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.zero import (
        sharded_distributed_optimizer)
    from horovod_tpu_torch.models.train import (TrainState,
                                                state_partition_specs)
    from horovod_tpu_torch.parallel.spmd import P

    model = _Net()
    plain = state_partition_specs(TrainState.from_model(
        model, torch.optim.Adam(model.parameters(), lr=1e-2)))
    assert plain["params"] == P() and plain["batch_stats"] == P()
    assert plain["step"] == P()
    assert set(torch.utils._pytree.tree_leaves(plain["opt_state"])) == \
        {P()}

    opt = _WithResiduals(model.parameters(), lr=1e-2)
    state = TrainState.from_model(model, opt)
    assert [r is s for r, s in zip(
        state["opt_state"]["hvd_residuals"].residuals,
        opt.residuals)] == [True, True]
    spec = state_partition_specs(state)["opt_state"]
    assert spec["hvd_residuals"].residuals == (P("hvd"), P("hvd"))
    assert spec["fc1.weight"] == {"exp_avg": P(), "exp_avg_sq": P(),
                                  "step": P()}

    basics.init(device="cpu")
    try:
        zopt = sharded_distributed_optimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2))
        zstate = TrainState.from_model(model, zopt)
        zspec = state_partition_specs(zstate)["opt_state"]["zero"]
        assert zspec == {"float32": {"exp_avg": P("hvd"),
                                     "exp_avg_sq": P("hvd"),
                                     "step": P()}}
        shard = zstate["opt_state"]["zero"]["float32"]["exp_avg"]
        assert shard is zopt.state[zopt._leaves["float32"]]["exp_avg"]
    finally:
        basics.shutdown()


# -------------------------------------------------- hyperparameter surgery


def test_get_set_hyperparam_round_trip():
    from horovod_tpu_torch.training import callbacks as cb

    _, opt, state = _sgd_state(0.1)
    lr = cb.get_hyperparam(state["opt_state"], "learning_rate")
    assert lr is opt.param_groups[0]["lr"] and float(lr) == \
        pytest.approx(0.1)
    out = cb.set_hyperparam(state["opt_state"], "learning_rate", 0.025)
    assert out is state["opt_state"]
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == float(np.float32(0.025))


def test_float_lr_raises_naming_the_tensor_rule():
    from horovod_tpu_torch.models.train import TrainState
    from horovod_tpu_torch.training import callbacks as cb

    model = _Linear()
    state = TrainState.from_model(model, torch.optim.SGD(
        model.parameters(), lr=0.1))
    with pytest.raises(KeyError, match="tensor"):
        cb.get_hyperparam(state["opt_state"], "learning_rate")
    with pytest.raises(KeyError, match="tensor"):
        cb.set_hyperparam(state["opt_state"], "learning_rate", 0.2)


def test_scale_momentum_doubles_sgd_and_leaves_adam():
    from horovod_tpu_torch.models.train import TrainState
    from horovod_tpu_torch.training import callbacks as cb

    X, y = (torch.from_numpy(a) for a in _linear_problem())
    _, opt, state = _sgd_state()
    _torch_step(opt)(state, (X, y))
    before = state["opt_state"]["w"]["momentum_buffer"].clone()
    cb.scale_momentum(state["opt_state"], 2.0)
    np.testing.assert_allclose(
        state["opt_state"]["w"]["momentum_buffer"].numpy(),
        2 * before.numpy(), rtol=1e-6)

    model = _Linear()
    adam = torch.optim.Adam(model.parameters(), lr=torch.tensor(0.1))
    astate = TrainState.from_model(model, adam)
    _torch_step(adam)(astate, (X, y))
    moments = {k: v.clone() for k, v in astate["opt_state"]["w"].items()}
    cb.scale_momentum(astate["opt_state"], 2.0)
    for k, v in astate["opt_state"]["w"].items():
        assert torch.equal(v, moments[k]), k


# ------------------------------------------------ TrainLoop vs reference


class _LRLog:
    """Records the applied LR at each batch's start (after the schedule
    callbacks before it) and the hooks in order."""

    def __init__(self, get):
        self.get = get
        self.lrs = []
        self.calls = []


def _recorder(base, log):
    class Recorder(base):
        def on_train_begin(self, logs=None):
            log.calls.append("train_begin")

        def on_epoch_begin(self, epoch, logs=None):
            log.calls.append(f"epoch_begin{epoch}")

        def on_batch_begin(self, batch, logs=None):
            log.calls.append(f"batch_begin{batch}")
            log.lrs.append(log.get(self.loop.state["opt_state"]))

        def on_batch_end(self, batch, logs=None):
            log.calls.append(f"batch_end{batch}")

        def on_epoch_end(self, epoch, logs=None):
            log.calls.append(f"epoch_end{epoch}")

        def on_train_end(self, logs=None):
            log.calls.append("train_end")

    return Recorder()


_SCHEDULES = {
    "plain": None,
    "staircase": dict(multiplier=lambda e: 0.5 ** e, staircase=True),
    "per_batch": dict(multiplier=lambda e: 1.0 / (1.0 + e),
                      staircase=False, steps_per_epoch=4),
    "window": dict(multiplier=0.1, start_epoch=1, end_epoch=3,
                   staircase=True),
}


@pytest.mark.parametrize("schedule", sorted(_SCHEDULES))
def test_train_loop_matches_the_reference(schedule, hvd):
    import jax.numpy as jnp
    import optax

    from horovod_tpu import flax as jflax
    from horovod_tpu.flax import callbacks as jcb
    from horovod_tpu_torch import training
    from horovod_tpu_torch.training import callbacks as cb

    X, y = _linear_problem()
    epochs, batches = 4, 4
    kw = _SCHEDULES[schedule]

    jopt = optax.inject_hyperparams(optax.sgd)(learning_rate=LR,
                                               momentum=0.9)
    jlog = _LRLog(lambda s: float(jcb.get_hyperparam(s, "learning_rate")))
    jcbs = ([jcb.LearningRateScheduleCallback(**kw)] if kw else []) + \
        [_recorder(jcb.Callback, jlog)]
    jparams = jnp.zeros((F,))
    jloop = jflax.TrainLoop(
        {"params": jparams, "opt_state": jopt.init(jparams)},
        _jax_step(jopt), lambda e: [(jnp.asarray(X), jnp.asarray(y))]
        * batches, callbacks=jcbs)
    jhist = jloop.fit(epochs)

    _, opt, state = _sgd_state()
    log = _LRLog(lambda s: float(cb.get_hyperparam(s, "learning_rate")))
    cbs = ([cb.LearningRateScheduleCallback(**kw)] if kw else []) + \
        [_recorder(cb.Callback, log)]
    batch = (torch.from_numpy(X), torch.from_numpy(y))
    loop = training.TrainLoop(state, _torch_step(opt),
                              lambda e: [batch] * batches, callbacks=cbs)
    hist = loop.fit(epochs)

    assert log.calls == jlog.calls
    assert log.lrs == jlog.lrs and len(set(log.lrs)) > (1 if kw else 0)
    assert int(state["step"]) == epochs * batches
    assert [sorted(h) for h in hist] == [["loss"]] * epochs
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose(state["params"]["w"].detach().numpy(),
                               np.asarray(jloop.state["params"]),
                               rtol=1e-5, atol=1e-6)


def test_hook_order_is_the_reference_recorder_sequence():
    from horovod_tpu_torch import training
    from horovod_tpu_torch.training import callbacks as cb

    _, opt, state = _sgd_state()
    log = _LRLog(lambda s: None)
    batch = tuple(torch.from_numpy(a) for a in _linear_problem())
    training.TrainLoop(state, _torch_step(opt), lambda e: [batch] * 2,
                       callbacks=[_recorder(cb.Callback, log)]).fit(2)
    assert log.calls == [
        "train_begin",
        "epoch_begin0", "batch_begin0", "batch_end0", "batch_begin1",
        "batch_end1", "epoch_end0",
        "epoch_begin1", "batch_begin0", "batch_end0", "batch_begin1",
        "batch_end1", "epoch_end1",
        "train_end",
    ]


def test_stop_training_ends_the_fit():
    from horovod_tpu_torch import training
    from horovod_tpu_torch.training import callbacks as cb

    class Stop(cb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            self.loop.stop_training = epoch == 1

    _, opt, state = _sgd_state()
    batch = tuple(torch.from_numpy(a) for a in _linear_problem())
    hist = training.TrainLoop(state, _torch_step(opt), lambda e: [batch],
                              callbacks=[Stop()]).fit(5)
    assert len(hist) == 2 and int(state["step"]) == 2


# ------------------------------------------------------------ checkpoints


def test_checkpoint_callback_schedule_and_final_save(tmp_path):
    from horovod_tpu_torch import training

    batch = tuple(torch.from_numpy(a) for a in _linear_problem())
    for counter, want in ((None, [1, 3, 4]),
                          (lambda s: int(s["step"]), [4, 8, 10])):
        _, opt, state = _sgd_state()
        ckpt = training.CheckpointManager(
            str(tmp_path / str(counter is None)), max_to_keep=10,
            backend="numpy")
        loop = training.TrainLoop(
            state, _torch_step(opt), lambda e: [batch] * 2,
            callbacks=[training.CheckpointCallback(
                ckpt, every_epochs=2, step_counter=counter)])
        loop.fit(5)
        assert ckpt.all_steps() == want
        back = ckpt.restore(want[-1], template=state)
        assert torch.equal(back["params"]["w"], state["params"]["w"])


def _elastic_pieces():
    def step_fn(state, batch):
        state["w"].sub_(0.1 * batch["x"])
        state["step"].add_(1)
        return state, {"loss": state["w"].sum()}

    def data_fn(epoch):
        for i in range(4):
            yield {"x": torch.tensor(float(i + 1))}

    init = {"w": torch.tensor(1.0), "step": torch.tensor(0,
                                                         dtype=torch.int32)}
    return step_fn, data_fn, init


def test_elastic_snapshot_callback_cadence_and_final_flush(tmp_path,
                                                           monkeypatch):
    from horovod_tpu_torch import elastic, training

    monkeypatch.setenv("HOROVOD_HEARTBEAT_DIR", str(tmp_path / "hb"))
    step_fn, data_fn, init = _elastic_pieces()
    with training.CheckpointManager(str(tmp_path), backend="numpy") as m:
        snap = elastic.Snapshotter(m, every=4, spill_every=1)
        loop = training.TrainLoop(
            init, step_fn, data_fn,
            callbacks=[training.ElasticSnapshotCallback(snap)])
        loop.fit(epochs=2)          # 8 steps: a spill at 4, the flush at 8
        assert m.all_steps() == [4, 8]
        assert (tmp_path / "hb" / "hb-0").exists()
        template = {k: torch.zeros_like(v) for k, v in init.items()}
        restored, manifest = snap.restore(template)
        assert manifest.step == 8
        assert torch.equal(restored["w"], loop.state["w"])


def test_elastic_snapshot_callback_preemption_exits_75(tmp_path):
    from horovod_tpu_torch import elastic, training

    step_fn, data_fn, init = _elastic_pieces()
    with training.CheckpointManager(str(tmp_path), backend="numpy") as m:
        snap = elastic.Snapshotter(m, every=100)
        handler = elastic.PreemptionHandler(install=False)

        class TriggerAtStep3(training.Callback):
            def on_batch_end(self, batch, logs=None):
                if int(self.loop.state["step"]) == 3:
                    handler.trigger()

        loop = training.TrainLoop(
            init, step_fn, data_fn,
            callbacks=[TriggerAtStep3(), training.ElasticSnapshotCallback(
                snap, preemption=handler)])
        with pytest.raises(SystemExit) as ei:
            loop.fit(epochs=2)
        assert ei.value.code == elastic.EXIT_PREEMPTED == 75
        assert elastic.latest_manifest(str(tmp_path)).step == 3


# ---------------------------------------------------------------- windows


def _adam_linear(lr=0.05):
    from horovod_tpu_torch.models.train import TrainState

    model = _Linear()
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(lr))
    return opt, TrainState.from_model(model, opt)


def test_windowed_loop_with_a_schedule_equals_the_eager_windows():
    from horovod_tpu_torch import training
    from horovod_tpu_torch.distributed.window import (stack_batches,
                                                      windowed)

    X, y = (torch.from_numpy(a) for a in _linear_problem())
    rng = np.random.default_rng(3)
    steps = [(X + torch.from_numpy(rng.standard_normal((N, F)).astype(
        np.float32)) * 0.1, y) for _ in range(8)]
    windows = [stack_batches(steps[i:i + 2]) for i in range(0, 8, 2)]
    results = []
    for captured in (True, False):
        opt, state = _adam_linear()
        one = _torch_step(opt)

        def per_step(batch, one=one, state=state):
            return one(state, batch)[1]

        per_step.optimizer = opt
        if captured:
            window = windowed(per_step, 2)
        else:
            def window(stacked, per_step=per_step):
                outs = [per_step(tuple(t[i] for t in stacked))
                        for i in range(stacked[0].shape[0])]
                total = outs[0]["loss"].clone()
                for o in outs[1:]:
                    total = total + o["loss"]
                return {"loss": total / len(outs)}

        sched = training.LearningRateScheduleCallback(
            lambda e: 0.5 ** e, staircase=False, steps_per_epoch=2)
        loop = training.TrainLoop(
            state, lambda st, b, window=window: (st, window(b)),
            lambda e: windows[2 * e:2 * e + 2], callbacks=[sched])
        hist = loop.fit(2)
        results.append((hist, state["params"]["w"].detach().clone(),
                        float(state["opt_state"]["hyperparams"][0]["lr"])))
    (h1, w1, lr1), (h2, w2, lr2) = results
    assert h1 == h2 and torch.equal(w1, w2)
    assert lr1 == lr2 == float(np.float32(float(np.float32(0.05))
                                          * 0.5 ** 1.5))


def test_window_refuses_sgd_with_a_tensor_lr_before_capture():
    from horovod_tpu_torch.distributed import window

    p = torch.nn.Parameter(torch.zeros(3))
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="SGD with a tensor lr"):
        window._check_optimizer(torch.optim.SGD(
            [p], lr=torch.tensor(0.1), momentum=0.9), cuda)
    with pytest.raises(ValueError, match="lies on cpu"):
        window._check_optimizer(torch.optim.Adam(
            [p], lr=torch.tensor(0.1), capturable=True), cuda)
    # What a window may capture passes; the CPU runs every form.
    window._check_optimizer(torch.optim.SGD([p], lr=0.1, momentum=0.9),
                            cuda)
    window._check_optimizer(torch.optim.Adam([p], lr=0.1,
                                             capturable=True), cuda)
    window._check_optimizer(torch.optim.SGD([p], lr=torch.tensor(0.1)),
                            torch.device("cpu"))


# ------------------------------------------------------ a 2-layer LM


LM = dict(vocab=128, max_len=32, layers=2, heads=4, head_dim=16, ffn=128)


class _Holder(torch.nn.Module):
    """The parallel_lm's parameter tree as a module's parameters."""

    def __init__(self, tree):
        from horovod_tpu_torch._pytree import flatten

        super().__init__()
        leaves, self.spec = flatten(tree)
        self.leaves = torch.nn.ParameterList(
            [torch.nn.Parameter(t) for t in leaves])

    def tree(self):
        return torch.utils._pytree.tree_unflatten(list(self.leaves),
                                                  self.spec)


def test_lm_train_loop_matches_the_reference(hvd):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu import flax as jflax
    from horovod_tpu.flax import callbacks as jcb
    from horovod_tpu.models import parallel_lm as jplm
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.models.train import TrainState, apply_gradients
    from horovod_tpu_torch.training import callbacks as cb

    jparams = jplm.init_lm_params(jax.random.PRNGKey(0), **LM)
    weights = jax.tree_util.tree_map(np.asarray, jparams)
    toks = np.random.default_rng(11).integers(0, LM["vocab"], (2, 32))
    sched = dict(multiplier=lambda e: 0.5 ** e, staircase=False,
                 steps_per_epoch=3)

    jopt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)

    @jax.jit
    def jstep(state, t):
        def loss_fn(p):
            return jplm.next_token_nll(jplm.lm_apply(p, t), t)

        loss, g = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = jopt.update(g, state["opt_state"],
                                         state["params"])
        return {"params": optax.apply_updates(state["params"], updates),
                "opt_state": opt_state}, {"loss": loss}

    jloop = jflax.TrainLoop(
        {"params": jparams, "opt_state": jopt.init(jparams)}, jstep,
        lambda e: [jnp.asarray(toks)] * 3,
        callbacks=[jcb.LearningRateScheduleCallback(**sched)])
    jhist = jloop.fit(2)

    holder = _Holder(plm.params_from_numpy(weights, device="cpu"))
    opt = torch.optim.Adam(holder.parameters(), lr=torch.tensor(1e-3))
    state = TrainState.from_model(holder, opt)
    names = list(state["params"])

    def step(st, t):
        loss = plm.next_token_nll(plm.lm_apply(holder.tree(), t), t)
        grads = torch.autograd.grad(loss, [st["params"][n] for n in names])
        apply_gradients(opt, st, dict(zip(names, grads)))
        return st, {"loss": loss.detach()}

    loop = training.TrainLoop(
        state, step, lambda e: [torch.from_numpy(toks)] * 3,
        callbacks=[cb.LearningRateScheduleCallback(**sched)])
    hist = loop.fit(2)
    assert int(state["step"]) == 6
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------- two ranks


WARM_LR = 0.8


def _np(tree):
    return torch.utils._pytree.tree_map(
        lambda t: t.detach().numpy().copy() if torch.is_tensor(t) else t,
        tree)


def _worker(rank, n, init, out):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.models.train import TrainState, apply_gradients
    from horovod_tpu_torch.training import callbacks as cb

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    hvd.init(device="cpu")
    res = {}

    # Ranks start apart (weights and Adam's moments); the broadcast at
    # train start makes them rank 0's.
    model = _Net(seed=rank)
    opt = training.create_distributed_optimizer(
        torch.optim.Adam(model.parameters(), lr=torch.tensor(1e-2)),
        named_parameters=model.named_parameters())
    state = TrainState.from_model(model, opt)
    with torch.no_grad():
        for t in flatten(state)[0]:
            t.add_(rank + 1)               # moments, counts and lr apart
    res["before"] = _np(flatten(state)[0])
    training.TrainLoop(state, None, lambda e: [], callbacks=[
        training.BroadcastGlobalVariablesCallback(0)]).fit(1)
    res["after"] = _np(flatten(state)[0])

    logs = {"loss": 1.5 * (rank + 1), "t": torch.tensor(2.0 * rank),
            "note": "kept"}
    avg = training.MetricAverageCallback()
    avg.set_loop(None)
    avg.on_epoch_end(0, logs)
    res["metrics"] = _np(logs)

    X, y = (torch.from_numpy(a) for a in _linear_problem(seed=rank))
    linear = _Linear()
    sgd = training.create_distributed_optimizer(torch.optim.SGD(
        linear.parameters(), lr=torch.tensor(WARM_LR), momentum=0.9))
    sstate = TrainState.from_model(linear, sgd)
    lrs = []

    class Log(cb.Callback):
        def on_batch_begin(self, batch, logs=None):
            lrs.append(float(cb.get_hyperparam(self.loop.state["opt_state"],
                                               "learning_rate")))

    training.TrainLoop(sstate, _torch_step(sgd), lambda e: [(X, y)] * 4,
                       callbacks=[training.LearningRateWarmupCallback(
                           warmup_epochs=2, steps_per_epoch=4),
                           Log()]).fit(3)
    res["warmup_lrs"] = lrs
    res["warmup_w"] = sstate["params"]["w"].detach().numpy().copy()

    # backward() under the wrapper's hooks issues the exchange during the
    # backward pass, and apply_gradients(grads=None) ends it; the step
    # equals the one from gradients handed over by name.
    res["hooked"] = {}
    for source in ("backward", "grads"):
        net = _Net(seed=0)
        hopt = training.create_distributed_optimizer(
            torch.optim.SGD(net.parameters(), lr=0.1),
            named_parameters=net.named_parameters(), overlap="on")
        hstate = TrainState.from_model(net, hopt)
        hopt.zero_grad()
        loss = _net_loss(net, seed=rank)
        if source == "backward":
            loss.backward()
            res["issued_in_backward"] = hopt._hvd_exchange._issued
            apply_gradients(hopt, hstate)
        else:
            grads = torch.autograd.grad(loss,
                                        list(hstate["params"].values()))
            apply_gradients(hopt, hstate,
                            dict(zip(hstate["params"], grads)))
        res["hooked"][source] = _np(dict(hstate["params"]))
    hvd.shutdown()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return start_world(2, str(tmp_path_factory.mktemp("train_loop")),
                       "test_torch_train_loop")


def test_broadcast_global_variables_makes_ranks_equal(two_ranks):
    r0, r1 = two_ranks
    assert any(not np.array_equal(a, b)
               for a, b in zip(r0["before"], r1["before"]))
    for a, b, want in zip(r0["after"], r1["after"], r0["before"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)


def test_metric_average_is_the_mean_over_ranks(two_ranks):
    for r in two_ranks:
        m = r["metrics"]
        assert float(m["loss"]) == pytest.approx((1.5 + 3.0) / 2)
        assert float(m["t"]) == pytest.approx(1.0)
        assert m["note"] == "kept"


def test_warmup_ramps_at_size_two_and_snaps(two_ranks):
    base = float(np.float32(WARM_LR))
    want = []
    for epoch in range(3):
        for b in range(4):
            p = min((epoch + b / 4) / 2, 1.0) if epoch < 2 else 1.0
            want.append(float(np.float32(base * ((1.0 + p * 1) / 2))))
    assert want[0] == float(np.float32(base / 2))
    assert want[-1] == base
    for r in two_ranks:
        assert r["warmup_lrs"] == want
    np.testing.assert_array_equal(two_ranks[0]["warmup_w"],
                                  two_ranks[1]["warmup_w"])


def test_backward_hooks_issue_the_exchange_before_apply_gradients(
        two_ranks):
    for r in two_ranks:
        assert r["issued_in_backward"] == 1
        for k, want in r["hooked"]["grads"].items():
            np.testing.assert_array_equal(r["hooked"]["backward"][k], want)
    for k, want in two_ranks[0]["hooked"]["backward"].items():
        np.testing.assert_array_equal(two_ranks[1]["hooked"]["backward"][k],
                                      want)
