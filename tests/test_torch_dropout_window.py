"""Windows over models with dropout: the call path that registers each
``Dropout`` generator with the captured step's CUDA graph
(``_graphs.register_generators``, ``module_generators``,
``check_registered``; ``models.resnet.Dropout.generator``).

On the CPU a window runs its steps eagerly and nothing is captured, so
the registration itself is a no-op here: these tests pin the path (which
modules are named, which generators a graph is given, the error that
names a module whose generator a capture did not register) with a fake
graph, and that a window over MNISTNet equals its eager steps from the
same generator seeds. That two replays draw fresh masks, and that a
captured window's losses match eager steps, is held on the card by
``chip_smoke.py``'s harness phase (VGG-16 at full width).
"""

import types

import numpy as np
import pytest
import torch

from horovod_tpu_torch import _graphs
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed.window import windowed
from horovod_tpu_torch.models import build
from horovod_tpu_torch.models import train as ttrain
from horovod_tpu_torch.models.mnist import MNISTNet
from horovod_tpu_torch.models.resnet import Dropout


class FakeGraph:
    def __init__(self):
        self.registered = []

    def register_generator_state(self, gen):
        self.registered.append(gen)


@pytest.fixture
def world():
    basics.init(device="cpu")
    yield
    basics.shutdown()


def _model(name, **kwargs):
    if name == "mnist":
        return MNISTNet(device="cpu", **kwargs)
    return build(name, num_classes=10, dtype=torch.float32, device="cpu",
                 image_size=32, **kwargs)


@pytest.mark.parametrize("name,n_drop", [("mnist", 2), ("vgg11", 2),
                                         ("vit_s16", 1)])
def test_module_generators_name_every_dropout(name, n_drop):
    model = _model(name)
    named = _graphs.module_generators(model)()
    assert len(named) == n_drop
    assert all(isinstance(m, Dropout) for _, m in named)
    assert [n for n, _ in named] == [n for n, m in model.named_modules()
                                     if isinstance(m, Dropout)]


def test_register_generators_takes_the_live_ones_once():
    model = _model("mnist")
    named = _graphs.module_generators(model)()
    dev = torch.device("cpu")
    graph = FakeGraph()
    rec = _graphs.register_generators(graph, named, dev)
    assert graph.registered == [] and rec["generators"] == set()
    assert sorted(rec["names"].values()) == ["drop1", "drop2"]
    model.train()
    model(torch.zeros(2, 28, 28, 1))
    gens = [m.generator(dev) for _, m in named]
    assert all(isinstance(g, torch.Generator) for g in gens)
    graph = FakeGraph()
    rec = _graphs.register_generators(graph, named + named[:1], dev)
    assert graph.registered == gens
    assert rec["generators"] == {id(g) for g in gens}
    assert all(m.generator("cuda") is None for _, m in named)


def test_an_unregistered_generator_in_a_capture_raises_naming_it(
        monkeypatch):
    owner = Dropout(0.5)
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    # Outside a capture, and for a CPU generator, nothing is checked.
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _graphs.check_registered(fake, owner)
    capturing[0] = True
    _graphs.check_registered(torch.Generator(), owner)
    monkeypatch.setattr(_graphs, "_capture", {
        "generators": set(), "names": {id(owner): "classifier.drop"}})
    with pytest.raises(_graphs.CaptureError, match="'classifier.drop'"):
        _graphs.check_registered(fake, owner)
    monkeypatch.setattr(_graphs, "_capture", {
        "generators": {id(fake)}, "names": {id(owner): "classifier.drop"}})
    _graphs.check_registered(fake, owner)
    monkeypatch.setattr(_graphs, "_capture", None)
    with pytest.raises(_graphs.CaptureError, match="do not name"):
        _graphs.check_registered(fake, Dropout(0.5))


def test_a_window_names_its_models_generators(world):
    model = _model("mnist")
    opt = ttrain.create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        device="cpu")
    win = windowed(ttrain.make_image_train_step(model, opt), 2)
    assert [n for n, _ in win.step.generators()] == ["drop1", "drop2"]


def test_mnist_window_equals_its_eager_steps(world):
    """Both runs from the same seeds draw the same masks, so the window
    (eager here) and the steps one by one agree bit for bit."""
    rng = np.random.default_rng(0)
    images = torch.tensor(rng.standard_normal((3, 4, 28, 28, 1)),
                          dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 10, (3, 4)))

    def make():
        model = _model("mnist", seed=5)
        opt = ttrain.create_train_state(
            model, torch.optim.SGD(model.parameters(), lr=0.05,
                                   momentum=0.9), device="cpu")
        return model, ttrain.make_image_train_step(model, opt)

    m1, step = make()
    mean = windowed(step, 3)({"image": images, "label": labels})
    m2, step2 = make()
    losses = [float(step2({"image": images[i], "label": labels[i]})["loss"])
              for i in range(3)]
    np.testing.assert_allclose(float(mean["loss"]), np.mean(losses),
                               rtol=1e-6)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
