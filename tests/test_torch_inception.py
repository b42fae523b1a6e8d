"""Parity of the port's Inception V3 with the JAX package, and the route
of its 40 1x1 ConvBNs through K5's wrapper.

A flax ``horovod_tpu.models.inception.InceptionV3`` (float32, 5 classes)
takes the variables of a seeded port model (its tree checked against a
flax init's), and the port's module takes them back through
``inception.params_from_flax``; the same numpy-seeded images
(2 x 128^2, the reference's own test size, tests/test_conv_bn.py:346-376)
go through both, fused and unfused, with the same Dropout mask (the JAX
side through ``flax.linen.intercept_methods``, the port's through
``resnet.Dropout.keep_mask``). The JAX fused route runs its Pallas kernel
in interpret mode on the CPU; the port's runs K5's plain version.
Inception's gradient path through K5's plain version is the ResNets'
(pinned against ``jax.grad`` in tests/test_torch_resnet.py), so this
file pins the forward. Tolerances, each with its reason:

* training-mode logits ``rtol 2e-2, atol 5e-3`` and batch statistics
  ``rtol 1e-3, atol 1e-4``: the reference's own bounds for fused against
  unfused (tests/test_conv_bn.py:369-376): float32 sums in another order
  amplified through 94 BatchNorms over small batches (the last blocks
  normalise 2 x 2 x 2 values a channel);
* eval-mode logits ``atol 1e-4``: running statistics, but 94 float32
  convolutions deep;
* fused against unfused inside the port: the same bounds.
"""

import collections
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu_torch import models as tmodels
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.ops import conv_bn as tcb

CLASSES = 5
SHAPE = (2, 128, 128, 3)
LOGIT_TOL = dict(rtol=2e-2, atol=5e-3)
STATS_TOL = dict(rtol=1e-3, atol=1e-4)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _jmodel(fused):
    return jmodels.InceptionV3(num_classes=CLASSES, dtype=jnp.float32,
                               fused_bn=fused)


def _images(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


MASK = np.random.default_rng(7).random((SHAPE[0], 2048)) >= 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch on 2 threads: at one thread a core (its default), tests
    sharing the cores with others' stall for seconds in a convolution."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _from_port_layout(arr, layout):
    if layout == "hwio":
        return np.transpose(arr, (2, 3, 1, 0))
    return arr.T if layout == "t" else arr


@functools.lru_cache(maxsize=None)
def _variables():
    """The flax variables of a seeded port model (a JAX init would take
    a full-model compile), mapped to numpy: the layouts turned back, the
    running statistics off their (0, 1) start, so that eval mode and the
    momentum update are exercised (small shifts: 94 BatchNorm + ReLU
    layers would zero every activation under large ones)."""
    model = tinc.InceptionV3(num_classes=CLASSES, dtype=torch.float32,
                             seed=3, device="cpu")
    rng = np.random.default_rng(1)
    tree = {}
    for path, t, layout in tinc.flax_parameter_map(model):
        arr = _from_port_layout(t.detach().numpy(), layout)
        if path[0] == "batch_stats":
            arr = (arr * rng.uniform(0.8, 1.2, arr.shape)
                   + rng.uniform(-0.05, 0.05, arr.shape))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(arr, np.float32)
    return tree


def _intercept(next_fun, args, kwargs, context):
    mod = context.module
    if isinstance(mod, fnn.Dropout) and context.method_name == "__call__" \
            and not kwargs.get("deterministic", mod.deterministic):
        return jnp.where(jnp.asarray(MASK), args[0] / 0.5, 0.0)
    return next_fun(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def _jax_train(fused):
    """JAX's train-mode logits and new batch statistics."""
    jm = _jmodel(fused)

    def fwd(v, x):
        with fnn.intercept_methods(_intercept):
            return jm.apply(v, x, train=True, mutable=["batch_stats"])

    logits, mut = jax.jit(fwd)(_variables(), jnp.asarray(_images()))
    return np.asarray(logits), {
        p: np.asarray(a) for p, a in _leaves(
            {"batch_stats": mut["batch_stats"]})}


def _tmodel(fused):
    model = tinc.InceptionV3(num_classes=CLASSES, dtype=torch.float32,
                             fused_bn=fused, device="cpu")
    return tinc.params_from_flax(_variables(), model)


@pytest.fixture
def shared_mask(monkeypatch):
    monkeypatch.setattr(tresnet.Dropout, "keep_mask",
                        lambda self, x: torch.tensor(MASK))


@functools.lru_cache(maxsize=None)
def _port_train(fused):
    model = _tmodel(fused).train()
    with torch.no_grad():
        logits = model(torch.tensor(_images())).numpy()
    stats = {p: t.numpy().copy() for p, t, _ in
             tinc.flax_parameter_map(model) if p[0] == "batch_stats"}
    return logits, stats


@pytest.mark.parametrize("fused", [False, True])
def test_training_logits_and_batch_stats_match_flax(fused, shared_mask):
    want_logits, want = _jax_train(fused)
    logits, stats = _port_train(fused)
    np.testing.assert_allclose(logits, want_logits, **LOGIT_TOL)
    assert set(stats) == set(want) and len(stats) == 2 * 94
    for path, got in stats.items():
        np.testing.assert_allclose(got, want[path], **STATS_TOL,
                                   err_msg="/".join(path))


def test_fused_equals_unfused_in_the_port(shared_mask):
    (lf, sf), (lu, su) = _port_train(True), _port_train(False)
    np.testing.assert_allclose(lf, lu, **LOGIT_TOL)
    for path in sf:
        np.testing.assert_allclose(sf[path], su[path], **STATS_TOL,
                                   err_msg="/".join(path))


def test_eval_logits_match_flax_and_ignore_fused_bn():
    x = _images(3)
    want = np.asarray(jax.jit(functools.partial(
        _jmodel(False).apply, train=False))(_variables(), jnp.asarray(x)))
    assert np.abs(want).max() > 1e-2
    outs = []
    for fused in (False, True):
        model = _tmodel(fused).eval()
        with torch.no_grad():
            outs.append(model(torch.tensor(x)).numpy())
        np.testing.assert_allclose(outs[-1], want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_variable_tree_and_parameter_count_match_flax():
    jm = jmodels.build("inception_v3", num_classes=1000)
    shapes = jax.eval_shape(functools.partial(
        jm.init, jax.random.PRNGKey(0), train=False),
        jnp.zeros((1, 299, 299, 3)))
    want = {p: tuple(s.shape) for p, s in _leaves(shapes)}
    model = tmodels.build("inception3", device="cpu")
    got = {p: _from_port_layout(np.empty(t.shape), layout).shape
           for p, t, layout in tinc.flax_parameter_map(model)}
    assert got == want
    assert len(got) == len(list(model.parameters())) + len(
        list(model.buffers()))
    assert sum(p.numel() for p in model.parameters()) == 23_834_568
    n_params = sum(int(np.prod(s)) for p, s in want.items()
                   if p[0] == "params")
    assert n_params == 23_834_568


# The sides of INCEPTION_V3_K5 (at 299^2) at a 139^2 input.
SIDES_AT_139 = {73: 33, 35: 15, 17: 7, 8: 3}


@pytest.mark.parametrize("fused,train,want", [
    (True, True, 40), (True, False, 0), (False, True, 0)])
def test_the_40_1x1s_ride_k5_s_wrapper(monkeypatch, fused, train, want):
    """A training forward of ``fused_bn=True`` calls K5's wrapper 40
    times, never with the prologue, at the shapes of ``INCEPTION_V3_K5``
    (K, N and count; the sides scaled to a 139^2 input); eval mode and
    ``fused_bn=False`` call it never. On the CPU the wrapper runs its
    plain version."""
    calls = collections.Counter()
    real = tcb.bn_stats_forward

    def counting(x, w, a=None, b=None):
        calls[(x.shape[1], x.shape[3], w.shape[1], a is not None)] += 1
        return real(x, w, a, b)

    monkeypatch.setattr(tcb, "bn_stats_forward", counting)
    model = tinc.InceptionV3(fused_bn=fused, dtype=torch.float32,
                             device="cpu").train(train)
    with torch.no_grad():
        out = model(torch.tensor(_images(shape=(1, 139, 139, 3))))
    assert out.shape == (1, 1000) and bool(torch.isfinite(out).all())
    assert sum(calls.values()) == want
    if want:
        table = collections.Counter()
        for side, K, N, count in tinc.INCEPTION_V3_K5:
            table[(SIDES_AT_139[side], K, N, False)] += count
        assert calls == table


def test_bench_inception_lane_runs_one_fused_step_on_the_cpu():
    from horovod_tpu_torch import bench

    args = bench.build_parser().parse_args(
        ["--model", "inception_v3", "--fused-bn", "--image-size", "75",
         "--batch-size", "2", "--fp32", "--num-warmup-batches", "0",
         "--num-batches-per-iter", "1", "--num-iters", "1"])
    try:
        rec = bench.run(args, device="cpu")
    finally:
        basics.shutdown()
    assert rec["metric"] == "img/sec" and rec["fused_bn"] is True
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]
