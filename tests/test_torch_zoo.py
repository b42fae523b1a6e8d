"""Parity of the port's MNIST, VGG and ViT, the ``build`` registry, the
eval step and the bench's zoo lanes with the JAX package.

A flax model of ``horovod_tpu.models`` is initialised by JAX; its
variables, mapped to numpy, are carried into the port's module with the
submodule's ``params_from_flax``; the same numpy-seeded NHWC images go
through both, in float32. Dropout draws other numbers in each package, so
in train mode both take the same numpy masks: the JAX side through
``flax.linen.intercept_methods`` on ``nn.Dropout.__call__`` (inside this
test only), the port's through ``resnet.Dropout.keep_mask``. VGG-11 runs
at 64^2, so five pools leave 2x2 before the NHWC flatten (at 32^2 the
flatten is 1x1 and its order cannot show). Tolerances, each with its
reason:

* MNIST logits ``atol 1e-5`` and gradients ``rtol 1e-4`` with an
  absolute bound of ``1e-4`` of each gradient's largest entry: float32
  convolutions and products summed in another order, nothing amplified;
* VGG-11 train-mode logits ``atol 2e-4`` and batch statistics ``atol
  1e-4``, gradients ``rtol 1e-3`` (same absolute form): float32 sums in
  another order, amplified by eight BatchNorms over 2 images (the last
  normalises 8 values a channel);
* eval-mode logits ``atol 1e-5``: running statistics, nothing amplified;
* ViT (two blocks) logits ``atol 1e-5``, gradients ``rtol 1e-4``: float32
  products and LayerNorms in another order;
* the eval step's loss ``rtol 1e-5`` and its counts exactly.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu.models import train as jtrain
from horovod_tpu_torch import models as tmodels
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models import vgg as tvgg
from horovod_tpu_torch.models import vit as tvit

CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch on 2 threads: at one thread a core (its default), tests
    sharing the cores with others' stall for seconds in a convolution."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _from_port_layout(arr, layout):
    if layout == "hwio":
        return np.transpose(arr, (2, 3, 1, 0))
    return arr.T if layout == "t" else arr


def _images(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, CLASSES, shape[0]).astype(np.int32))


def _masks(shapes, seed=7):
    """Keep masks (True = kept) at rate 0.5, in flax's NHWC shapes."""
    rng = np.random.default_rng(seed)
    return [rng.random(s) >= 0.5 for s in shapes]


def _jax_dropout(masks):
    """``nn.Dropout.__call__`` in train mode returns ``x / keep`` where
    the next mask keeps it, else 0."""
    it = iter(masks)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", mod.deterministic)
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = 1.0 - mod.rate
        return jnp.where(jnp.asarray(next(it)), x / keep, 0.0)

    return fnn.intercept_methods(intercept)


@pytest.fixture
def port_masks(monkeypatch):
    """``set(masks)``: the port's Dropout takes ``masks`` in call order
    (an NHWC mask is permuted to the port's NCHW)."""
    queue = []

    def keep_mask(self, x):
        m = torch.tensor(queue.pop(0))
        return m.permute(0, 3, 1, 2) if m.dim() == 4 else m

    monkeypatch.setattr(tresnet.Dropout, "keep_mask", keep_mask)
    return lambda masks: queue.extend(masks)


def _xent(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, logits.shape[-1]) * logp,
                             -1))


# ---------------------------------------------------------------- cases

# name -> (JAX model, port model given variables, images shape, dropout
# mask shapes in train mode, has batch_stats, module with the map)
def _mnist_case():
    jm = jmodels.MNISTNet()
    build = lambda: tmnist.MNISTNet(device="cpu")  # noqa: E731
    return jm, build, (2, 28, 28, 1), [(2, 8, 8, 20), (2, 50)], tmnist


def _vgg_case():
    jm = jmodels.VGG11(num_classes=CLASSES, dtype=jnp.float32, hidden=32)
    build = lambda: tvgg.VGG11(num_classes=CLASSES,  # noqa: E731
                               dtype=torch.float32, hidden=32,
                               image_size=64, device="cpu")
    return jm, build, (2, 64, 64, 3), [(2, 32), (2, 32)], tvgg


def _vit_case():
    kw = dict(num_classes=CLASSES, patch_size=8, embed_dim=32, depth=2,
              num_heads=2)
    jm = jmodels.VisionTransformer(dtype=jnp.float32, **kw)
    build = lambda: tvit.VisionTransformer(  # noqa: E731
        dtype=torch.float32, image_size=32, device="cpu", **kw)
    return jm, build, (2, 32, 32, 3), [], tvit


CASES = {"mnist": _mnist_case, "vgg11": _vgg_case, "vit": _vit_case}


@functools.lru_cache(maxsize=None)
def _variables(name):
    jm, _, shape, _, _ = CASES[name]()
    v = jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        jm.init, train=False))(jax.random.PRNGKey(0), jnp.zeros(shape)))
    if "batch_stats" in v:
        # Running statistics away from their (0, 1) start, so that eval
        # mode and the momentum update are really exercised: a train-mode
        # pass's batch statistics (``new = 0.9 * old + 0.1 * batch``) on
        # other images, the variances scaled by 1.0-1.2. With shifted
        # (0, 1) statistics eight BatchNorm + ReLU layers would zero every
        # activation and the logits with them.
        x, _ = _images(shape, seed=11)
        _, mut = jax.jit(functools.partial(
            jm.apply, train=True, mutable=["batch_stats"]))(
                v, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(1)})
        rng = np.random.default_rng(1)
        batch = {}
        for path, new in _leaves(jax.tree_util.tree_map(
                np.asarray, mut["batch_stats"])):
            old = 0.0 if path[-1] == "mean" else 1.0
            stat = (new - 0.9 * old) / 0.1
            if path[-1] == "var":
                stat = stat * rng.uniform(1.0, 1.2, stat.shape)
            node = batch
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = stat.astype(np.float32)
        v["batch_stats"] = batch
    return v


def _port_model(name):
    _, build, _, _, mod = CASES[name]()
    v = _variables(name)
    model = build()
    mod.params_from_flax(v if "batch_stats" in v else v["params"], model)
    return model


@functools.lru_cache(maxsize=None)
def _jax_train(name):
    """JAX's train-mode loss, logits, new batch stats and gradients on
    images 0 with the shared masks."""
    jm, _, shape, mshapes, _ = CASES[name]()
    v = _variables(name)
    x, y = _images(shape)
    stats = v.get("batch_stats", {})

    def loss_fn(params):
        with _jax_dropout(_masks(mshapes)):
            logits, mut = jm.apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(x),
                train=True, mutable=["batch_stats"])
        return _xent(logits, jnp.asarray(y)), (logits, mut)

    (loss, (logits, mut)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": grads, "batch_stats": mut.get("batch_stats", {})})
    return float(loss), np.asarray(logits), dict(_leaves(tree))


def _port_train(name, port_masks):
    _, _, shape, mshapes, mod = CASES[name]()
    model = _port_model(name).train()
    port_masks(_masks(mshapes))
    x, y = _images(shape)
    logits = model(torch.tensor(x))
    loss = ttrain.cross_entropy_loss(logits, torch.tensor(y))
    loss.backward()
    return model, float(loss.detach()), logits.detach().numpy(), mod


def _paths(mod, model):
    """``(path in the gradient / stats tree, tensor, layout)``: the
    models without batch statistics name bare parameter paths."""
    for path, t, layout in mod.flax_parameter_map(model):
        if path[0] not in ("params", "batch_stats"):
            path = ("params",) + path
        yield path, t, layout


# ----------------------------------------------------------- the models


TRAIN_TOL = {"mnist": (1e-5, 1e-4), "vgg11": (2e-4, 1e-3),
             "vit": (1e-5, 1e-4)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_training_logits_and_batch_stats_match_flax(name, port_masks):
    loss, want_logits, want = _jax_train(name)
    model, got_loss, logits, mod = _port_train(name, port_masks)
    atol = TRAIN_TOL[name][0]
    np.testing.assert_allclose(logits, want_logits, rtol=0, atol=atol)
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    n = 0
    for path, t, _ in _paths(mod, model):
        if path[0] == "batch_stats":
            np.testing.assert_allclose(t.numpy(), want[path], rtol=0,
                                       atol=1e-4, err_msg="/".join(path))
            n += 1
    assert n == (16 if name == "vgg11" else 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax_grad(name, port_masks):
    _, _, want = _jax_train(name)
    model, _, _, mod = _port_train(name, port_masks)
    tol = TRAIN_TOL[name][1]
    n = 0
    for path, t, layout in _paths(mod, model):
        if path[0] != "params":
            continue
        got = _from_port_layout(t.grad.numpy(), layout)
        w = want[path]
        np.testing.assert_allclose(got, w, rtol=tol,
                                   atol=tol * np.abs(w).max() + 1e-12,
                                   err_msg="/".join(path))
        n += 1
    assert n == len(list(model.parameters()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_logits_match_flax(name):
    jm, _, shape, _, _ = CASES[name]()
    x, _ = _images(shape, seed=3)
    want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        _variables(name), jnp.asarray(x)))
    model = _port_model(name).eval()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for k, t in model.state_dict().items():          # eval updates nothing
        assert torch.equal(t, before[k]), k


def test_vgg_flatten_reads_nhwc_rows_at_2x2():
    """At 64^2 VGG-11's flatten is 2x2x512: an NCHW flatten would feed
    ``Dense_0`` its rows in another order, which the eval logits catch;
    here the same weights with the rows of ``Dense_0`` permuted to the
    NCHW order must disagree with flax."""
    model = _port_model("vgg11").eval()
    assert model.dense[0].in_features == 2 * 2 * 512
    jm, _, shape, _, _ = CASES["vgg11"]()
    x, _ = _images(shape, seed=3)
    want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        _variables("vgg11"), jnp.asarray(x)))
    w = model.dense[0].weight.data
    perm = torch.arange(2048).reshape(2, 2, 512).permute(2, 0, 1).reshape(-1)
    model.dense[0].weight.data = w[:, perm]
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    assert np.abs(got - want).max() > 1e-3


@pytest.mark.parametrize("name,kw,shape", [
    ("mnist", {}, (1, 28, 28, 1)),
    ("vgg11", dict(num_classes=3, hidden=8), (1, 64, 64, 3)),
    ("vgg13", dict(num_classes=3, hidden=8), (1, 32, 32, 3)),
    ("vgg16", dict(num_classes=3, hidden=8), (1, 32, 32, 3)),
    ("vgg19", dict(num_classes=3, hidden=8), (1, 32, 32, 3)),
    ("vit_s16", dict(num_classes=3, depth=2), (1, 32, 32, 3)),
    ("vit_b16", dict(num_classes=3, depth=1), (1, 48, 48, 3)),
])
def test_variable_tree_matches_flax(name, kw, shape):
    if name == "mnist":
        jm, mod = jmodels.MNISTNet(), tmnist
        model = tmnist.MNISTNet(device="cpu")
    else:
        jm = jmodels.build(name, **kw)
        sized = dict(kw, image_size=shape[1], device="cpu")
        model = tmodels.build(name, **sized)
        mod = tvgg if name.startswith("vgg") else tvit
    shapes = jax.eval_shape(functools.partial(
        jm.init, jax.random.PRNGKey(0), train=False), jnp.zeros(shape))
    want = {p: tuple(s.shape) for p, s in _leaves(shapes)}
    got = {("params",) + p if p[0] not in ("params", "batch_stats") else p:
           tuple(_from_port_layout(np.empty(t.shape), layout).shape)
           for p, t, layout in mod.flax_parameter_map(model)}
    assert got == want
    n_tensors = len(list(model.parameters())) + len(list(model.buffers()))
    assert len(got) == n_tensors


def test_published_parameter_counts():
    """VGG-16 138,361,768 and ViT-S/16 22,036,840 at 224^2 and 1000
    classes, the JAX models' counts; ViT-B/16's 86,540,008 from a
    one-block model and eleven more blocks."""
    vgg = tvgg.VGG16(device="cpu")
    assert sum(p.numel() for p in vgg.parameters()) == 138_361_768
    del vgg
    vit = tvit.ViT_S16(device="cpu")
    assert sum(p.numel() for p in vit.parameters()) == 22_036_840
    one = tvit.ViT_B16(depth=1, device="cpu")
    n1 = sum(p.numel() for p in one.parameters())
    block = sum(p.numel() for p in one.blocks[0].parameters())
    assert n1 + 11 * block == 86_540_008


def test_vit_rejects_an_image_the_patch_does_not_divide():
    jm = jmodels.VisionTransformer(patch_size=8, embed_dim=16, depth=1,
                                   num_heads=2, dtype=jnp.float32)
    with pytest.raises(ValueError) as want:
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 30, 32, 3)))
    model = tvit.VisionTransformer(patch_size=8, embed_dim=16, depth=1,
                                   num_heads=2, image_size=32, device="cpu")
    with pytest.raises(ValueError) as got:
        model(torch.zeros(1, 30, 32, 3))
    assert str(got.value) == str(want.value)


def test_dropout_masks_repeat_from_one_seed():
    """Two MNIST models from one seed draw the same masks (their own
    generators): equal train-mode logits, bit for bit; another seed's
    generator draws other masks."""
    x, _ = _images((4, 28, 28, 1))
    outs = []
    for seed in (0, 0, 1):
        model = tmnist.MNISTNet(seed=seed, device="cpu").train()
        tmnist.params_from_flax(_variables("mnist")["params"], model)
        outs.append(model(torch.tensor(x)).detach())
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    d = tresnet.Dropout(0.5, seed=(3, 1)).train()
    y = d(torch.ones(1000))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 400 < int((y == 0).sum()) < 600
    assert torch.equal(d.eval()(torch.ones(3)), torch.ones(3))


def test_pools_are_flax_s():
    x = np.random.default_rng(2).standard_normal((2, 9, 8, 3)).astype(
        np.float32)
    t = torch.tensor(x).permute(0, 3, 1, 2)
    for got, want in (
            (tresnet.max_pool(t, 3, 2),
             fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2))),
            (tresnet.avg_pool_same(t),
             fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                          padding="SAME")),
            (tresnet.avg_pool_same(t, 3, 2),
             fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                          padding="SAME"))):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------- registry and eval


def test_build_takes_the_reference_names_and_its_error():
    assert set(tmodels._FAMILY) == set(jmodels._FAMILY)
    for name, cls in (("VGG11", tvgg.VGG), ("vit_s16", tvit.VisionTransformer),
                      ("ResNet18", tresnet.ResNet)):
        kw = dict(num_classes=3, device="cpu")
        kw.update({"vgg11": dict(hidden=4, image_size=32),
                   "vit_s16": dict(depth=1, image_size=16),
                   "resnet18": dict(num_filters=2)}[name.lower()])
        assert type(tmodels.build(name, **kw)) is cls
    assert tmodels.constructor("inception3") is tmodels.constructor(
        "inception_v3")
    assert tmodels.constructor("transformer_lm") is tmodels.TransformerLM
    with pytest.raises(ValueError) as want:
        jmodels.build("vgg7")
    with pytest.raises(ValueError) as got:
        tmodels.build("vgg7", device="cpu")
    assert str(got.value) == str(want.value)


def test_eval_step_matches_jax():
    """``make_eval_step`` over the live state against the JAX step over
    the same variables: the mean loss, the correct count and the batch
    size; the model's mode is left as it was."""
    jm, _, shape, _, _ = CASES["vgg11"]()
    v = _variables("vgg11")
    x, y = _images((4,) + shape[1:], seed=5)
    y[:2] = np.argmax(np.asarray(jax.jit(functools.partial(
        jm.apply, train=False))(v, jnp.asarray(x[:2]))), -1)
    want = jax.jit(jtrain.make_eval_step(jm))(
        {"params": v["params"], "batch_stats": v["batch_stats"]},
        {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    model = _port_model("vgg11").train()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = ttrain.TrainState.from_model(model, opt)
    got = tmodels.make_eval_step(model)(
        state, {"image": torch.tensor(x), "label": torch.tensor(y)})
    assert model.training
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("correct", "count"):
        assert got[k].dtype == torch.float32
        assert float(got[k]) == float(want[k]), k
    assert float(got["correct"]) >= 2


# -------------------------------------------------------- the bench lanes


def _bench(argv):
    from horovod_tpu_torch import bench

    args = bench.build_parser().parse_args(argv)
    try:
        return bench.run(args, device="cpu")
    finally:
        basics.shutdown()


def test_bench_image_models_are_the_registry_s():
    from horovod_tpu_torch import bench

    assert bench.IMAGE_MODELS == sorted(
        k for k in jmodels._FAMILY if k != "transformer_lm")


@pytest.mark.parametrize("model", ["vgg11", "vit_s16"])
def test_bench_zoo_lane_runs_one_step_on_the_cpu(model):
    rec = _bench(["--model", model, "--image-size", "32", "--batch-size",
                  "2", "--fp32", "--num-warmup-batches", "0",
                  "--num-batches-per-iter", "1", "--num-iters", "1"])
    assert rec["metric"] == "img/sec" and rec["value"] > 0
    assert rec["model"] == model and rec["image_size"] == 32
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]
    assert rec["buckets"]["count"] >= 1 and rec["fused_bn"] is False


@pytest.mark.parametrize("model", ["vgg16", "vit_b16"])
def test_bench_fused_bn_is_the_resnet_and_inception_families_only(model):
    from horovod_tpu_torch import bench

    with pytest.raises(ValueError, match="^--fused-bn applies to the "
                                         "ResNet and Inception families$"):
        bench.run(bench.build_parser().parse_args(
            ["--model", model, "--fused-bn"]), device="cpu")
    assert not basics.is_initialized()
