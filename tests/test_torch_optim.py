"""The port's optimizers with narrow state (``training/optim.py``) against
optax's ``accumulator_dtype``/``mu_dtype``, and the bfloat16 state
through the train state, ZeRO, checkpoints and snapshots.

* SGD (``momentum_dtype=torch.bfloat16``) against ``optax.sgd(0.05, 0.9,
  accumulator_dtype=jnp.bfloat16)`` on ``MNISTNet`` (weights carried with
  ``mnist.params_from_flax``, the dropout masks shared as
  ``test_torch_zoo.py`` shares them), and Adam (``mu_dtype``) against
  ``optax.adam(1e-3, mu_dtype=jnp.bfloat16)`` on a 2-layer
  ``TransformerLM``: over 5 steps the narrow state is bfloat16 and
  within one bfloat16 ulp of optax's (both round float32 values formed
  the same way from gradients that agree to float32 rounding), the
  parameters stay float32 and agree within ``PARAM_ATOL``;
* the JAX package's own claim (``tests/test_models.py::
  test_bf16_momentum_tracks_fp32``) on the port: bfloat16 momentum tracks
  float32 momentum within rtol 0.1 over the first 5 of 15 steps, and
  still learns;
* with no state dtype both classes run optax's float32 update, and
  capturable Adam (its step count on the device) passes the same pins;
* ``TrainState.from_model`` makes the narrow state before the first
  step; ``save_model``/``load_model``, ``CheckpointManager``, an elastic
  snapshot and ``load_state_dict`` keep its dtype; a window over the
  optimizers equals their eager steps;
* ZeRO over a 2-rank gloo world keeps bfloat16 shards, ``state_bytes``
  reports their bytes, and its parameters equal the unsharded
  optimizer's.
"""

import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu.models.transformer import TransformerLM as JLM
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                  flax_parameter_map,
                                                  params_from_flax)
from horovod_tpu_torch.training import optim

import gloo_worlds

BF16 = torch.bfloat16
STEPS = 5
#: Parameter agreement after 5 steps (module docstring). SGD: a stored
#: trace that rounds to the other bfloat16 neighbour in one package
#: moves the next update by lr x momentum x one ulp (2.2e-5 at a trace
#: of 0.1), and the later gradients carry it on (8.8e-5 seen in one of
#: MNISTNet's 21,840 weights).
PARAM_ATOL = {"sgd": 2e-4, "adam": 1e-5}
LM_CFG = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
              max_len=32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at ``|x|`` (8 significant bits)."""
    a = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


def _assert_within_bf16_ulp(got, want, what):
    """Within one bfloat16 ulp of optax's, plus ``1e-6`` of the tensor's
    largest entry: near-zero entries inherit the float32 rounding of a
    gradient summed at the tensor's scale."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.maximum(_bf16_ulp(got), _bf16_ulp(want))
    slack = ulp * (1 + 1e-6) + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > slack
    assert not bad.any(), (what, got[bad][:5], want[bad][:5])


def _get(tree, path):
    return functools.reduce(lambda d, k: d[k], path, tree)


def _flax_layout(arr, layout):
    if layout == "hwio":
        return np.transpose(arr, (2, 3, 1, 0))
    return arr.T if layout in ("t", True) else arr


# ------------------------------------------------------ SGD on MNISTNet

MNIST_B = 8
MASKS = [(MNIST_B, 8, 8, 20), (MNIST_B, 50)]


def _mnist_batch(step):
    rng = np.random.default_rng(100 + step)
    return (rng.standard_normal((MNIST_B, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, MNIST_B).astype(np.int32),
            [rng.random(s) >= 0.5 for s in MASKS])


def _jax_dropout(masks):
    it = iter(masks)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        if kwargs.get("deterministic", mod.deterministic):
            return next_fun(*args, **kwargs)
        return jnp.where(next(it), args[0] / (1.0 - mod.rate), 0.0)

    return fnn.intercept_methods(intercept)


def _xent(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, logits.shape[-1]) * logp,
                             -1))


@functools.lru_cache(maxsize=None)
def _mnist_optax():
    """optax's bfloat16-momentum SGD on MNISTNet: the initial params,
    and after each step the params and the trace."""
    jm = jmodels.MNISTNet()
    params = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]

    @jax.jit
    def grad(p, x, y, m1, m2):
        def loss(p):
            with _jax_dropout([m1, m2]):
                return _xent(jm.apply({"params": p}, x, train=True), y)
        return jax.grad(loss)(p)

    tx = optax.sgd(0.05, momentum=0.9, accumulator_dtype=jnp.bfloat16)
    state = tx.init(params)
    update = jax.jit(tx.update)
    init = jax.tree_util.tree_map(np.asarray, params)
    out = []
    for step in range(STEPS):
        x, y, (m1, m2) = _mnist_batch(step)
        g = grad(params, x, y, m1, m2)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append(jax.tree_util.tree_map(np.asarray,
                                          (params, state[0].trace)))
    return init, out


@pytest.fixture
def port_masks(monkeypatch):
    queue = []

    def keep_mask(self, x):
        m = torch.tensor(queue.pop(0))
        return m.permute(0, 3, 1, 2) if m.dim() == 4 else m

    monkeypatch.setattr(tresnet.Dropout, "keep_mask", keep_mask)
    return queue


def _tree(pmap, value):
    """A flax-shaped tree of copies of ``value(tensor)`` in flax's
    layout. Copies: JAX on the CPU may alias an aligned numpy buffer,
    and the port's step writes its tensors in place."""
    out: dict = {}
    for path, t, layout in pmap:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(_flax_layout(value(t), layout))
    return out


def _to_jnp(tree, dtype=None):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _bf16_numpy(t):
    return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))


def test_sgd_bf16_momentum_matches_optax(port_masks):
    """Five steps of each package from the same weights and masks:
    parameters within ``PARAM_ATOL``; and each step's new momentum
    within one bfloat16 ulp of what optax's update makes of the same
    gradient and momentum (the port's), its update within float32
    rounding."""
    init, want = _mnist_optax()
    model = tmnist.params_from_flax(init, tmnist.MNISTNet(device="cpu"))
    opt = optim.SGD(model.parameters(), lr=0.05, momentum=0.9,
                    momentum_dtype=BF16)
    pmap = tmnist.flax_parameter_map(model)
    tx = optax.sgd(0.05, momentum=0.9, accumulator_dtype=jnp.bfloat16)
    empty = tx.init(_to_jnp(init))[1]
    update = jax.jit(tx.update)
    for step in range(STEPS):
        x, y, masks = _mnist_batch(step)
        port_masks.extend(masks)
        model.train()
        opt.zero_grad()
        ttrain.cross_entropy_loss(model(torch.tensor(x)),
                                  torch.tensor(y)).backward()
        before = _tree(pmap, lambda p: p.detach().numpy())
        grads = _tree(pmap, lambda p: p.grad.numpy())
        trace = (_tree(pmap, lambda p: _bf16_numpy(
            opt.state[p]["momentum_buffer"])) if step else
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape, jnp.bfloat16),
                                   before))
        upd, new = jax.block_until_ready(update(
            _to_jnp(grads), (optax.TraceState(trace=_to_jnp(trace)), empty),
            _to_jnp(before)))
        opt.step()
        params, _ = want[step]
        for path, p, layout in pmap:
            buf = opt.state[p]["momentum_buffer"]
            assert buf.dtype == BF16 and p.dtype == torch.float32
            assert _get(new[0].trace, path).dtype == jnp.bfloat16
            _assert_within_bf16_ulp(
                _flax_layout(buf.float().numpy(), layout),
                np.asarray(_get(new[0].trace, path), np.float32),
                f"step {step} trace {path}")
            np.testing.assert_allclose(
                _flax_layout(p.detach().numpy(), layout),
                _get(before, path) + np.asarray(_get(upd, path)),
                rtol=1e-6, atol=1e-9, err_msg=f"step {step} update {path}")
            np.testing.assert_allclose(
                _flax_layout(p.detach().numpy(), layout),
                _get(params, path), rtol=0, atol=PARAM_ATOL["sgd"],
                err_msg=f"step {step} {path}")


# -------------------------------------------------- Adam on the LM

def _lm_tokens(step):
    return np.random.default_rng(300 + step).integers(
        0, 32, (2, 16)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _lm_optax():
    jm = JLM(**LM_CFG, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_lm_tokens(0)),
                     train=False)["params"]

    @jax.jit
    def grad(p, t):
        def loss(p):
            logits = jm.apply({"params": p}, t, train=False)
            logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
            return -jnp.take_along_axis(logp, t[:, 1:, None], -1).mean()
        return jax.grad(loss)(p)

    tx = optax.adam(1e-3, mu_dtype=jnp.bfloat16)
    state = tx.init(params)
    update = jax.jit(tx.update)
    init = jax.tree_util.tree_map(np.asarray, params)
    out = []
    for step in range(STEPS):
        g = grad(params, jnp.asarray(_lm_tokens(step)))
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append(jax.tree_util.tree_map(
            np.asarray, (params, state[0].mu, state[0].nu)))
    return init, out


@pytest.mark.parametrize("capturable", [False, True])
def test_adam_bf16_mu_matches_optax(capturable):
    """As the SGD pin, for Adam's first moment (bfloat16) and second
    moment (float32) on the LM."""
    init, want = _lm_optax()
    model = params_from_flax(init, TransformerLM(
        **LM_CFG, dtype=torch.float32, device="cpu"))
    opt = optim.Adam(model.parameters(), lr=1e-3, mu_dtype=BF16,
                     capturable=capturable)
    pmap = flax_parameter_map(model)
    tx = optax.adam(1e-3, mu_dtype=jnp.bfloat16)
    update = jax.jit(tx.update)
    zero = tx.init(_to_jnp(init))
    for step in range(STEPS):
        t = torch.tensor(_lm_tokens(step), dtype=torch.long)
        opt.zero_grad()
        ttrain.next_token_loss(model(t), t).backward()
        before = _tree(pmap, lambda p: p.detach().numpy())
        grads = _tree(pmap, lambda p: p.grad.numpy())
        if step:
            adam = optax.ScaleByAdamState(
                count=jnp.asarray(step, jnp.int32),
                mu=_to_jnp(_tree(pmap, lambda p: _bf16_numpy(
                    opt.state[p]["exp_avg"]))),
                nu=_to_jnp(_tree(pmap, lambda p: opt.state[p][
                    "exp_avg_sq"].numpy())))
            state = (adam,) + tuple(zero[1:])
        else:
            state = zero
        upd, new = jax.block_until_ready(
            update(_to_jnp(grads), state, _to_jnp(before)))
        opt.step()
        params, _, _ = want[step]
        for path, p, tr in pmap:
            st = opt.state[p]
            assert st["exp_avg"].dtype == BF16
            assert st["exp_avg_sq"].dtype == torch.float32
            assert p.dtype == torch.float32
            assert float(st["step"]) == step + 1
            assert (st["step"].device == p.device) if capturable else \
                st["step"].device.type == "cpu"
            _assert_within_bf16_ulp(
                _flax_layout(st["exp_avg"].float().numpy(), tr),
                np.asarray(_get(new[0].mu, path), np.float32),
                f"step {step} mu {path}")
            np.testing.assert_allclose(
                _flax_layout(st["exp_avg_sq"].numpy(), tr),
                _get(new[0].nu, path), rtol=1e-6, atol=0,
                err_msg=f"step {step} nu {path}")
            np.testing.assert_allclose(
                _flax_layout(p.detach().numpy(), tr),
                _get(before, path) + np.asarray(_get(upd, path)),
                rtol=1e-6, atol=1e-9, err_msg=f"step {step} update {path}")
            np.testing.assert_allclose(
                _flax_layout(p.detach().numpy(), tr), _get(params, path),
                rtol=0, atol=PARAM_ATOL["adam"],
                err_msg=f"step {step} {path}")


# ----------------------------------------- the JAX test's own claim


def _port_mnist_run(momentum_dtype, steps=15):
    model = tmnist.MNISTNet(seed=0, device="cpu")
    opt = optim.SGD(model.parameters(), lr=0.05, momentum=0.9,
                    momentum_dtype=momentum_dtype)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((16, 28, 28, 1)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, 16))
    losses = []
    for _ in range(steps):
        model.train()
        opt.zero_grad()
        loss = ttrain.cross_entropy_loss(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return model, opt, losses


def test_bf16_momentum_tracks_fp32_and_learns():
    m16, o16, l16 = _port_mnist_run(BF16)
    _, o32, l32 = _port_mnist_run(None)
    assert {str(s["momentum_buffer"].dtype) for s in o16.state.values()} \
        == {"torch.bfloat16"}
    assert {str(s["momentum_buffer"].dtype) for s in o32.state.values()} \
        == {"torch.float32"}
    np.testing.assert_allclose(l16[:5], l32[:5], rtol=0.1)
    assert min(l16[5:]) < l16[0]
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    b16 = optim.state_bytes(o16)
    assert b16["momentum_buffer"] * 2 == optim.state_bytes(o32)[
        "momentum_buffer"]
    assert b16["dtypes"] == {"momentum_buffer": "bfloat16"}


@pytest.mark.parametrize("kind", ["sgd", "sgd_nesterov", "adam"])
def test_float32_state_equals_optax(kind):
    """With no state dtype both classes run optax's float32 update: the
    same gradients give the same parameters within float32 rounding."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((6, 3)).astype(np.float32)
    grads = [rng.standard_normal((6, 3)).astype(np.float32)
             for _ in range(4)]
    if kind == "adam":
        tx = optax.adam(1e-2)
        p = torch.nn.Parameter(torch.tensor(w0))
        opt = optim.Adam([p], lr=1e-2)
    else:
        nesterov = kind == "sgd_nesterov"
        tx = optax.sgd(0.1, momentum=0.9, nesterov=nesterov)
        p = torch.nn.Parameter(torch.tensor(w0))
        opt = optim.SGD([p], lr=0.1, momentum=0.9, nesterov=nesterov)
    w, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        upd, state = jax.jit(tx.update)(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
        p.grad = torch.tensor(g)
        opt.step()
    key = "exp_avg" if kind == "adam" else "momentum_buffer"
    assert opt.state[p][key].dtype == torch.float32
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------ the train state


@pytest.fixture
def world():
    basics.init(device="cpu")
    yield
    basics.shutdown()


def _lm_opt(kind, model, capturable=False):
    if kind == "sgd":
        return optim.SGD(model.parameters(), lr=0.05, momentum=0.9,
                         momentum_dtype=BF16)
    return optim.Adam(model.parameters(), lr=1e-3, mu_dtype=BF16,
                      capturable=capturable)


NARROW = {"sgd": "momentum_buffer", "adam": "exp_avg"}


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("wrap", ["plain", "distributed", "zero"])
def test_from_model_makes_narrow_state_before_the_first_step(world, kind,
                                                             wrap):
    model = TransformerLM(**LM_CFG, dtype=torch.float32, device="cpu")
    opt = _lm_opt(kind, model)
    if wrap != "plain":
        opt = ttrain.create_train_state(model, opt, device="cpu",
                                        zero=wrap == "zero")
    state = ttrain.TrainState.from_model(model, opt)
    leaves = (state["opt_state"]["zero"].values() if wrap == "zero"
              else state["opt_state"].values())
    key = NARROW[kind]
    assert leaves and all(st[key].dtype == BF16 for st in leaves)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if kind == "adam":
        assert all(st["exp_avg_sq"].dtype == torch.float32 for st in leaves)
    # The state made at step 0 is the state the first step uses.
    t = torch.tensor(_lm_tokens(0), dtype=torch.long)
    ref = TransformerLM(**LM_CFG, dtype=torch.float32, device="cpu")
    ref.load_state_dict(model.state_dict())
    ropt = _lm_opt(kind, ref)
    for m, o in ((model, opt), (ref, ropt)):
        o.zero_grad()
        ttrain.next_token_loss(m(t), t).backward()
        o.step()
    for a, b in zip(model.parameters(), ref.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)
    leaves = (state["opt_state"]["zero"].values() if wrap == "zero"
              else state["opt_state"].values())
    assert any(float(st[key].float().abs().max()) > 0 for st in leaves)


def _trained(kind):
    model = TransformerLM(**LM_CFG, dtype=torch.float32, device="cpu")
    opt = _lm_opt(kind, model)
    state = ttrain.TrainState.from_model(model, opt)
    for step in range(2):
        t = torch.tensor(_lm_tokens(step), dtype=torch.long)
        opt.zero_grad()
        ttrain.next_token_loss(model(t), t).backward()
        ttrain.apply_gradients(opt, state)
    return model, opt, state


def _narrow_leaves(state, kind):
    return {n: st[NARROW[kind]] for n, st in state["opt_state"].items()
            if isinstance(st, dict) and NARROW[kind] in st}


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("route", ["save_model", "checkpoint", "snapshot",
                                   "state_dict"])
def test_narrow_state_round_trips_keep_bf16(tmp_path, kind, route):
    import json

    from horovod_tpu_torch import training
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.elastic.snapshot import Snapshotter

    _, opt, state = _trained(kind)
    saved = _narrow_leaves(state, kind)
    assert saved and all(t.dtype == BF16 for t in saved.values())
    _, opt2, fresh = _trained(kind)
    for t in _narrow_leaves(fresh, kind).values():
        t.zero_()
    if route == "save_model":
        training.save_model(str(tmp_path / "m.msgpack"), state)
        training.load_model(str(tmp_path / "m.msgpack"), fresh)
    elif route == "checkpoint":
        mgr = CheckpointManager(str(tmp_path / "ck"), backend="numpy")
        mgr.save(2, state)
        mgr.wait_until_finished()
        shards = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "ck")
                  for f in fs if f.endswith(".json") and "shard" in f]
        names = {leaf["dtype"] for s in shards
                 for leaf in json.load(open(s))["leaves"]}
        assert "bfloat16" in names, names
        fresh = CheckpointManager(str(tmp_path / "ck"),
                                  backend="numpy").restore(2, template=fresh)
    elif route == "snapshot":
        snap = Snapshotter(every=1)
        snap.take(2, state, sync=True)
        step, fresh = snap.latest
        assert step == 2
    else:
        opt2.load_state_dict(opt.state_dict())
        fresh = {"opt_state": {
            n: opt2.state[p] for n, p in zip(
                state["opt_state"], [q for g in opt2.param_groups
                                     for q in g["params"]])}}
    got = _narrow_leaves(fresh, kind)
    assert set(got) == set(saved)
    for n, t in got.items():
        assert t.dtype == BF16, (route, n, t.dtype)
        assert torch.equal(t, saved[n]), (route, n)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_window_over_narrow_state_equals_eager_steps(world, kind):
    """A window (eager on the CPU) over the bf16-state optimizers runs
    the same updates as its steps one by one."""
    from horovod_tpu_torch.distributed.window import windowed

    def make():
        model = TransformerLM(**LM_CFG, dtype=torch.float32, seed=3,
                              device="cpu")
        opt = ttrain.create_train_state(model, _lm_opt(kind, model),
                                        device="cpu")
        return model, ttrain.make_train_step(model, opt)

    toks = torch.tensor(np.stack([_lm_tokens(s) for s in range(3)]),
                        dtype=torch.long)
    m1, step = make()
    win = windowed(step, 3)
    mean = win(toks)
    m2, step2 = make()
    losses = [float(step2(toks[i])) for i in range(3)]
    np.testing.assert_allclose(float(mean), np.mean(losses), rtol=1e-6)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)


# -------------------------------------------------------- ZeRO, 2 ranks

ZSHAPES = {"a": (3,), "b": (4,), "c": (2,)}


def _zdata(rank, step):
    rng = np.random.default_rng(500 + 10 * rank + step)
    return {n: torch.tensor(rng.standard_normal(s).astype(np.float32))
            for n, s in ZSHAPES.items()}


def _zsteps(kind, zero, rank):
    from horovod_tpu_torch.distributed.zero import (
        shard_info, sharded_distributed_optimizer)

    rng = np.random.default_rng(21)
    params = {n: torch.nn.Parameter(torch.tensor(
        rng.standard_normal(s).astype(np.float32)))
        for n, s in ZSHAPES.items()}
    opt = (optim.SGD(list(params.values()), lr=0.05, momentum=0.9,
                     momentum_dtype=BF16) if kind == "sgd" else
           optim.Adam(list(params.values()), lr=1e-2, mu_dtype=BF16))
    if zero:
        opt = sharded_distributed_optimizer(opt)
    for step in range(3):
        opt.zero_grad()
        x = _zdata(rank, step)
        # The unsharded run takes the mean gradient by hand.
        xs = x if zero else {n: (_zdata(0, step)[n] + _zdata(1, step)[n])
                             / 2 for n in ZSHAPES}
        sum((xs[n] * p ** 2).sum() for n, p in params.items()).backward()
        opt.step()
    out = {"params": {n: p.detach().numpy() for n, p in params.items()}}
    if zero:
        out["info"] = shard_info(opt)
        out["state"] = optim.state_bytes(opt)
    return out


def _zworker(rank, init, out):
    from datetime import timedelta

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2, timeout=timedelta(seconds=30))
    hvd.init(device="cpu")
    res = {(kind, zero): _zsteps(kind, zero, rank)
           for kind in ("sgd", "adam") for zero in (True, False)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def zero_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("optim_zero"))
    init = gloo_worlds.init_url(out)
    gloo_worlds.spawn("test_torch_optim", "_zworker",
                      [(r, init, out) for r in range(2)], 90)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_zero_keeps_bf16_shards_and_matches_the_unsharded_optimizer(
        zero_ranks, kind):
    n = sum(int(np.prod(s)) for s in ZSHAPES.values())
    pad = n + n % 2
    for rank in range(2):
        z = zero_ranks[rank][(kind, True)]
        plain = zero_ranks[rank][(kind, False)]
        for name in ZSHAPES:
            np.testing.assert_allclose(z["params"][name],
                                       plain["params"][name], rtol=0,
                                       atol=1e-6, err_msg=name)
        (length, per), = z["info"].values()
        assert (length, per) == (pad, pad // 2)
        if kind == "sgd":
            assert z["state"] == {"momentum_buffer": per * 2,
                                  "dtypes": {"momentum_buffer": "bfloat16"}}
        else:
            assert z["state"] == {
                "exp_avg": per * 2, "exp_avg_sq": per * 4,
                "dtypes": {"exp_avg": "bfloat16", "exp_avg_sq": "float32"}}
