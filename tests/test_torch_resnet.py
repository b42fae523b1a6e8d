"""Parity of the port's ResNet and image train step with the JAX package.

A flax ``horovod_tpu.models.resnet.ResNet`` is initialised by JAX; its
variables (``params`` and ``batch_stats``), mapped to numpy, are carried
into the port's module with ``params_from_flax``; the same numpy-seeded
NHWC images go through both. The small models cover every ConvBN flavour:
a bottleneck ResNet with ``stage_sizes [1, 1, 1, 1]`` at ``num_filters 8``
(stride-2 3x3s, strided ``proj``, and with ``fused_bn`` the K5 prologue)
and a basic-block one, on 32x32 images, batch 2, float32. Where JAX fuses,
``fits_fused`` is True, so both packages take the fused route. Tolerances,
each with its reason:

* training-mode logits ``atol 5e-4`` on logits of unit scale and batch
  statistics ``atol 5e-5``: float32 sums in another order, amplified by
  BatchNorm over tiny batches (at batch 2 the last stage normalises 2
  values per channel, dividing by their spread);
* gradients, ``rtol`` and an absolute bound of the same factor times each
  gradient's largest entry: ``1e-3`` in float32 at batch 4, ``1e-5`` in
  float64 at batch 2. At batch 2 the last stage's BatchNorm over 2 values
  per channel makes float32 gradients ill-conditioned: the two packages
  differ there by up to 4e-3 of a gradient's scale in float32 but agree
  to 4e-7 in float64 (the float32 head and parameters bound that), so
  float32 is pinned at batch 4 (4 values per channel, 2e-5 measured) and
  the batch of 2 in float64;
* eval-mode logits ``atol 1e-5``: running statistics, nothing amplified;
* fused against unfused inside the port in float64: loss ``rtol 1e-9``,
  gradients ``rtol 1e-7, atol 1e-9`` (tests/test_conv_bn.py:340);
* three SGD-momentum steps at batch 4: losses ``rtol 1e-5``, parameters
  and batch statistics ``atol 1e-5``: each step moves a parameter by up to
  ``lr * |momentum buffer|``, about 1e-2, so a wrong gradient shows far
  above it.
"""

import collections
import functools
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from horovod_tpu import models as jmodels
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.ops.conv_bn import fits_fused
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.ops import conv_bn as tcb

import gloo_worlds

REPO = Path(__file__).resolve().parent.parent
BLOCKS = {"bottleneck": (jresnet.BottleneckResNetBlock,
                         tresnet.BottleneckResNetBlock),
          "basic": (jresnet.ResNetBlock, tresnet.ResNetBlock)}
SMALL = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, num_filters=8)
B, HW = 2, 32
LR, MOMENTUM = 0.01, 0.9


def _batch(seed=0, b=B, hw=HW):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def _jmodel(block, fused, dtype=jnp.float32):
    return jresnet.ResNet(block_cls=BLOCKS[block][0], dtype=dtype,
                          fused_bn=fused, **SMALL)


def _tmodel(block, fused, variables=None, dtype=torch.float32):
    model = tresnet.ResNet(block_cls=BLOCKS[block][1], dtype=dtype,
                           fused_bn=fused, device="cpu", **SMALL)
    if variables is not None:
        tresnet.params_from_flax(variables, model)
    return model


@functools.lru_cache(maxsize=None)
def _variables(block):
    x, _ = _batch()
    v = jax.jit(functools.partial(_jmodel(block, False).init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    # Running statistics away from their (0, 1) start, so that eval mode
    # and the momentum update are really exercised.
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def _xent(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, 10) * logp, -1))


@functools.lru_cache(maxsize=None)
def _jax_train(block, fused, dtype="float32", b=B):
    """JAX's training-mode loss, logits, updated batch stats and
    gradients for the small model on ``b`` images of batch 0."""
    if dtype == "float64":
        with jax.enable_x64():
            return _jax_train.__wrapped__(block, fused, "x64", b)
    v = _variables(block)
    x, y = _batch(b=b)
    model = _jmodel(block, fused,
                    jnp.float64 if dtype == "x64" else jnp.float32)

    def loss_fn(params):
        logits, mut = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return _xent(logits, jnp.asarray(y)), (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    tree = jax.tree_util.tree_map(np.asarray, {"params": grads,
                                               "batch_stats": stats})
    return float(loss), np.asarray(logits), dict(_leaves(tree))


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _from_port_layout(arr, layout):
    """A port tensor in the flax layout: the inverse of
    ``resnet.to_port_layout``."""
    if layout == "hwio":
        return np.transpose(arr, (2, 3, 1, 0))
    return arr.T if layout == "t" else arr


def _port_train(model, x, y):
    model.train()
    model.zero_grad()
    logits = model(torch.tensor(x))
    loss = ttrain.cross_entropy_loss(logits, torch.tensor(y))
    loss.backward()
    return loss, logits


# ----------------------------------------------------------- the model


def test_jax_takes_the_fused_route_at_the_test_shapes():
    # Every 1x1 of the small bottleneck model: (M, K, N) at batch 2, 32^2.
    for m, k, n in [(128, 8, 8), (128, 8, 32), (128, 32, 16), (32, 32, 64),
                    (32, 16, 64), (8, 64, 32), (8, 32, 128), (2, 128, 64),
                    (2, 64, 256)]:
        assert fits_fused(m, k, n, itemsize=4)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_training_logits_and_batch_stats_match_flax(block, fused):
    loss, want_logits, want = _jax_train(block, fused)
    x, y = _batch()
    model = _tmodel(block, fused, _variables(block))
    got_loss, logits = _port_train(model, x, y)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(float(got_loss.detach()), loss, rtol=1e-5)
    n = 0
    for path, t, _ in tresnet.flax_parameter_map(model):
        if path[0] == "batch_stats":
            np.testing.assert_allclose(t.numpy(), want[path], rtol=0,
                                       atol=5e-5, err_msg="/".join(path))
            n += 1
    # stem, the convs of 4 blocks and the projections (the basic model's
    # first block keeps its width and stride, so it has none).
    want_n = 1 + 3 * 4 + 4 if block == "bottleneck" else 1 + 2 * 4 + 3
    assert n == 2 * want_n


# float32 at batch 4; float64 at the batch of 2, where float32 is
# ill-conditioned (see the module docstring), for the bottleneck model,
# whose fused route runs both K5 variants.
GRAD_CASES = [(block, fused, "float32", 4, 1e-3) for block in sorted(BLOCKS)
              for fused in (False, True)] + [
    ("bottleneck", fused, "float64", 2, 1e-5) for fused in (False, True)]


@pytest.mark.parametrize("block,fused,dtype,b,tol", GRAD_CASES)
def test_gradients_match_jax_grad(block, fused, dtype, b, tol):
    _, _, want = _jax_train(block, fused, dtype, b)
    x, y = _batch(b=b)
    model = _tmodel(block, fused, _variables(block),
                    dtype=getattr(torch, dtype))
    _port_train(model, x, y)
    for path, t, layout in tresnet.flax_parameter_map(model):
        if path[0] != "params":
            continue
        got = _from_port_layout(t.grad.numpy(), layout)
        w = want[path]
        np.testing.assert_allclose(got, w, rtol=tol,
                                   atol=tol * np.abs(w).max() + 1e-12,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_eval_logits_match_flax_and_ignore_fused_bn(block):
    v = _variables(block)
    x, _ = _batch(2)
    want = np.asarray(jax.jit(functools.partial(
        _jmodel(block, False).apply, train=False))(v, jnp.asarray(x)))
    calls = []
    for fused in (False, True):
        model = _tmodel(block, fused, v).eval()
        before = dict(model.state_dict())
        with torch.no_grad():
            got = model(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        calls.append(got)
        for k, t in model.state_dict().items():   # eval updates nothing
            assert torch.equal(t, before[k]), k
    np.testing.assert_array_equal(calls[0], calls[1])


def test_fused_equals_unfused_in_float64():
    x, y = _batch(3)
    out = {}
    for fused in (False, True):
        model = _tmodel("bottleneck", fused, _variables("bottleneck"),
                        dtype=torch.float64)
        loss, _ = _port_train(model, x, y)
        out[fused] = (float(loss.detach()), [p.grad.clone() for p in
                                    model.parameters()],
                      [b.clone() for b in model.buffers()])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-9)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7,
                                   atol=1e-9)
    for a, b in zip(out[True][2], out[False][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_three_sgd_momentum_steps_match_jax(hvd):
    """The bench lane's optimizer and step: ``make_train_step(model,
    optax.sgd(0.01, momentum=0.9), average_loss=False)`` against the
    port's image step under ``DistributedOptimizer`` (a gloo world of
    one), fused BatchNorm, three steps on one batch."""
    v = _variables("bottleneck")
    jmodel = _jmodel("bottleneck", True)
    opt = hvd.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM))
    state = jmodels.train.TrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=opt.init(v["params"]), step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jmodels.make_train_step(jmodel, opt,
                                            average_loss=False))
    x, y = _batch(4, b=4)
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}

    basics.init(device="cpu")
    try:
        model = _tmodel("bottleneck", True, v)
        topt = ttrain.create_train_state(
            model, torch.optim.SGD(model.parameters(), lr=LR,
                                   momentum=MOMENTUM), device="cpu")
        tstep = ttrain.make_image_train_step(model, topt,
                                             average_loss=False)
        tbatch = {"image": torch.tensor(x), "label": torch.tensor(y)}
        for _ in range(3):
            state, jm = jstep(state, jbatch)
            tm = tstep(tbatch)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            assert float(tm["accuracy"]) == float(jm["accuracy"])
    finally:
        basics.shutdown()
    final = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, {"params": state["params"],
                     "batch_stats": state["batch_stats"]})))
    start = dict(_leaves(v))
    moved = 0.0
    for path, t, layout in tresnet.flax_parameter_map(model):
        got = _from_port_layout(t.detach().numpy(), layout)
        np.testing.assert_allclose(got, final[path], rtol=0, atol=1e-5,
                                   err_msg="/".join(path))
        if path[0] == "params":
            moved = max(moved, float(np.abs(got - start[path]).max()))
    assert moved > 1e-3


def test_cross_entropy_matches_jax():
    logits = np.random.default_rng(5).standard_normal((4, 10)).astype(
        np.float32)
    labels = np.array([0, 3, 9, 3], np.int32)
    want = float(jmodels.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(labels)))
    got = float(ttrain.cross_entropy_loss(torch.tensor(logits),
                                          torch.tensor(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ----------------------------------------------------- SAME and names


@pytest.mark.parametrize("size,want", [(8, (0, 1)), (7, (1, 1)),
                                       (112, (0, 1)), (56, (0, 1))])
def test_same_pads_are_flax_s(size, want):
    assert tresnet.same_pads(size, 3, 2) == want
    assert tresnet.same_pads(size, 3, 1) == (1, 1)
    assert tresnet.same_pads(size, 1, 2) == (0, 0)


@pytest.mark.parametrize("hw", [8, 7])
def test_stride2_3x3_conv_is_flax_same(hw):
    x, w = (np.random.default_rng(6).standard_normal(s).astype(np.float32)
            for s in ((2, hw, hw, 4), (3, 3, 4, 5)))
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    cb = tresnet.ConvBN(4, 5, (3, 3), (2, 2), dtype=torch.float32)
    got = cb._conv(torch.tensor(x).permute(0, 3, 1, 2),
                   torch.tensor(tresnet.to_port_layout(w, "hwio")))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [8, 7])
def test_max_pool_is_flax_same(hw):
    x = np.random.default_rng(7).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = tresnet.max_pool_same(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_build_names_and_errors():
    assert set(tresnet._FAMILY) == set(jresnet._FAMILY)
    for name in ("resnet18", "ResNet50"):
        model = tresnet.build(name, num_filters=2, num_classes=3,
                              device="cpu")
        assert isinstance(model, tresnet.ResNet)
    with pytest.raises(ValueError, match="Unknown ResNet"):
        tresnet.build("resnet7", device="cpu")


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_variable_tree_matches_flax(name):
    jm = jresnet.build(name, num_classes=3, num_filters=2)
    shapes = jax.eval_shape(functools.partial(jm.init, jax.random.PRNGKey(0),
                                              train=False),
                            jnp.zeros((1, 32, 32, 3)))
    want = {p: tuple(s.shape) for p, s in _leaves(shapes)}
    model = tresnet.build(name, num_classes=3, num_filters=2, device="cpu")
    got = {p: tuple(_from_port_layout(np.empty(t.shape), layout).shape)
           for p, t, layout in tresnet.flax_parameter_map(model)}
    assert got == want
    n_tensors = len(list(model.parameters())) + len(list(model.buffers()))
    assert len(got) == n_tensors


def test_params_from_flax_rejects_a_mismatched_tree():
    v = _variables("basic")
    with pytest.raises(ValueError, match="missing"):
        tresnet.params_from_flax({"params": v["params"]},
                                 _tmodel("basic", False))
    with pytest.raises(ValueError, match="shape"):
        tresnet.params_from_flax(v, tresnet.ResNet(
            block_cls=tresnet.ResNetBlock, dtype=torch.float32,
            device="cpu", **{**SMALL, "num_classes": 7}))


@pytest.mark.parametrize("fused,train,want", [
    (True, True, (20, 16)), (True, False, (0, 0)), (False, True, (0, 0))])
def test_resnet50_k5_calls_per_forward(monkeypatch, fused, train, want):
    """16 K5 calls with the prologue (the last 1x1 of every block) and 20
    without (the first 1x1 of every block and the 4 projections)."""
    calls = []
    real = tcb.bn_stats_forward

    def counting(x, w, a=None, b=None):
        calls.append(a is not None)
        return real(x, w, a, b)

    monkeypatch.setattr(tcb, "bn_stats_forward", counting)
    model = tresnet.build("resnet50", num_filters=2, num_classes=3,
                          dtype=torch.float32, fused_bn=fused, device="cpu")
    model.train(train)
    x, _ = _batch(b=1)
    with torch.set_grad_enabled(train):
        out = model(torch.tensor(x))
    assert out.shape == (1, 3) and bool(torch.isfinite(out).all())
    assert (calls.count(False), calls.count(True)) == want


def test_resnet50_k5_table_lists_the_model_s_fused_1x1s(monkeypatch):
    """``RESNET50_K5`` (the shapes the chip smoke and the K5 tune script
    time) is every fused 1x1 of a full-width ResNet-50 training forward:
    K, N, stride, prologue and count, at a 64^2 image (sides 16/8/4/2
    for the table's 56/28/14/7)."""
    calls = collections.Counter()
    real = tcb.bn_stats_forward

    def counting(x, w, a=None, b=None):
        calls[(x.shape[1], x.shape[3], w.shape[1], a is not None)] += 1
        return real(x, w, a, b)

    monkeypatch.setattr(tcb, "bn_stats_forward", counting)
    model = tresnet.build("resnet50", num_classes=3, dtype=torch.float32,
                          fused_bn=True, device="cpu")
    model.train()
    with torch.no_grad():
        model(torch.zeros((1, 64, 64, 3)))
    want = collections.Counter()
    for side, K, N, stride, prologue, count in tresnet.RESNET50_K5:
        want[(side * 64 // 224 // stride, K, N, prologue)] += count
    assert calls == want
    assert sum(want.values()) == 36


# ------------------------------------------------ two ranks over gloo


# The two-rank case, as source so that the rank processes run it without
# importing this module (and with it JAX): the batch and the seeded model.
_CASE = """
import numpy as np
import torch
from horovod_tpu_torch.models import resnet as tresnet

LR, MOMENTUM = 0.01, 0.9


def case_batch():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 4).astype(np.int32))


def case_model():
    return tresnet.ResNet(
        stage_sizes=[1, 1, 1, 1], block_cls=tresnet.BottleneckResNetBlock,
        num_classes=10, num_filters=8, dtype=torch.float32, fused_bn=True,
        seed=3, device="cpu")
"""
exec(_CASE)

# One rank of a 2-process gloo world: one image step of the case model on
# its half of the case batch under DistributedOptimizer.
_WORKER = _CASE + """
import os
import torch.distributed as dist
from horovod_tpu_torch import distributed as hvd
from horovod_tpu_torch.models import train as ttrain

rank = int(os.environ["CASE_RANK"])
dist.init_process_group("gloo", init_method=os.environ["CASE_INIT"],
                        rank=rank, world_size=2)
hvd.init(device="cpu")
x, y = case_batch()
model = case_model()
opt = ttrain.create_train_state(model, torch.optim.SGD(
    model.parameters(), lr=LR, momentum=MOMENTUM), device="cpu")
step = ttrain.make_image_train_step(model, opt)
half = slice(2 * rank, 2 * rank + 2)
m = step({"image": torch.tensor(x[half]), "label": torch.tensor(y[half])})
torch.save({"params": [p.detach().clone() for p in model.parameters()],
            "buffers": [b.clone() for b in model.buffers()],
            "loss": float(m["loss"])},
           os.path.join(os.environ["CASE_OUT"], f"rank{rank}.pt"))
dist.destroy_process_group()
"""


def test_two_rank_step_equals_the_averaged_half_batch_steps(tmp_path):
    """Data parallelism with per-rank BatchNorm: each rank normalises with
    its own half batch's statistics, so the step is NOT the full-batch
    step. The reference therefore runs, in this process, each half's
    forward and backward with its own statistics (what each rank does),
    averages the two gradients (the DistributedOptimizer's average) and
    takes one SGD step; each rank's parameters must equal it, and each
    rank's running statistics must equal its own half's."""
    init = gloo_worlds.init_url(tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env={**os.environ, "PYTHONPATH": str(REPO), "CASE_RANK": str(r),
             "CASE_INIT": init,
             "CASE_OUT": str(tmp_path)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=180)
            logs.append(stdout + stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    x, y = case_batch()
    grads, stats, losses = [], [], []
    for r in range(2):
        model = case_model()
        loss, _ = _port_train(model, x[2 * r:2 * r + 2], y[2 * r:2 * r + 2])
        grads.append([p.grad.clone() for p in model.parameters()])
        stats.append([b.clone() for b in model.buffers()])
        losses.append(float(loss.detach()))
    model = case_model()
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    for p, g0, g1 in zip(model.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    opt.step()
    # The average of two float32 gradients is summed in another order by
    # the collective: 1e-6 (tests/test_torch_distributed.py's bound).
    for r, res in enumerate(ranks):
        for got, want in zip(res["params"], model.parameters()):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                       rtol=0, atol=1e-6)
        for got, want in zip(res["buffers"], stats[r]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6)
        # average_loss: every rank reports the mean of the two losses.
        np.testing.assert_allclose(res["loss"], np.mean(losses), rtol=1e-6)
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        assert torch.equal(a, b)


# ------------------------------------------------------ the bench lane


def test_bench_image_defaults_are_the_jax_lane_defaults():
    import bench as jbench

    from horovod_tpu_torch import bench

    for argv in (["--model", "resnet50"], ["--model", "resnet18",
                                            "--fused-bn"]):
        want = jbench.build_parser().parse_args(argv)
        got = bench.build_parser().parse_args(argv)
        for f in ("model", "image_size", "fused_bn", "fp32",
                  "num_warmup_batches", "num_batches_per_iter", "num_iters"):
            assert getattr(got, f) == getattr(want, f), f
        # The JAX lane resolves batch None to 64 images per chip.
        assert want.batch_size is None and got.batch_size == 64
        assert got.attention is None


@pytest.mark.parametrize("fused", [False, True])
def test_bench_image_lane_runs_a_tiny_model_on_the_cpu(fused):
    from horovod_tpu_torch import bench

    argv = ["--model", "resnet18", "--image-size", "32", "--batch-size",
            "2", "--fp32", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "2", "--num-iters", "2"]
    args = bench.build_parser().parse_args(argv + ["--fused-bn"] * fused)
    try:
        rec = bench.run(args, device="cpu")
    finally:
        basics.shutdown()
    assert rec["metric"] == "img/sec" and rec["value"] > 0
    assert rec["unit"] == "img/sec/card" and rec["fused_bn"] == fused
    assert (rec["device"], rec["card"], rec["world_size"]) == ("cpu", "cpu",
                                                              1)
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]
    assert rec["buckets"]["count"] >= 1 and rec["image_size"] == 32


@pytest.mark.parametrize("argv,match", [
    (["--model", "resnet50", "--attention", "flash"], "--attention"),
    (["--fused-bn"], "--fused-bn"),
])
def test_bench_rejects_the_other_lanes_flags(argv, match):
    from horovod_tpu_torch import bench

    with pytest.raises(ValueError, match=match):
        bench.run(bench.build_parser().parse_args(argv), device="cpu")
    assert not basics.is_initialized()
