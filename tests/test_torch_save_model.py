"""``save_model``/``load_model`` of the port (``horovod_tpu_torch.
training``, over its own msgpack codec ``training/_msgpack.py``) against
the JAX package's (``horovod_tpu.flax``, over ``flax.serialization``).

The same trees, made from numpy seeds, are saved by both packages: the
files are equal byte for byte (float32, int32, uint32, bool, bfloat16 and
0-d leaves; nested dicts, lists, tuples, a named tuple; Python ints,
floats, strings and None), also with both packages' chunk size
monkeypatched to 64 bytes, and each package's ``load_model`` restores
the other's file to equal values, exactly. The port writes the values
into its template's tensors (a live ``TrainState``'s model sees them).
One gloo world of two ranks: only rank 0 writes, and with
``broadcast=True`` rank 1 reads nothing and ends with rank 0's values.
"""

import collections
import os

import numpy as np
import pytest
import torch

from test_torch_tp import start_world

Pair = collections.namedtuple("Pair", "first second")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31 - 1, (7,)).astype(np.int32),
        "u32": rng.integers(0, 2**32 - 1, (2, 2), dtype=np.uint32),
        "bool": rng.random(9) > 0.5,
        "bf16": rng.standard_normal((4, 3)).astype(np.float32),
        "scalar": np.float32(rng.standard_normal()),
        "long": rng.standard_normal(40).astype(np.float32),
    }


def _tree(a, arr, bf16):
    """One tree over both packages: ``arr`` makes an array leaf,
    ``bf16`` a bfloat16 one."""
    return {
        "params": {"w": arr(a["f32"]), "b": arr(a["f32"][0]),
                   "half": bf16(a["bf16"])},
        "ints": [arr(a["i32"]), arr(a["u32"]), (arr(a["bool"]), 3)],
        "zero_d": arr(np.asarray(a["scalar"])),
        "pair": Pair(arr(a["long"]), {"k": arr(a["i32"][:2])}),
        "py": [0, 127, 128, 65536, -1, -33, -129, 2**40, True, False,
               0.25, -1e-30, None, "name"],
    }


def _jax_tree(a):
    import jax.numpy as jnp

    return _tree(a, jnp.asarray,
                 lambda x: jnp.asarray(x).astype(jnp.bfloat16))


def _torch_tree(a):
    return _tree(a, lambda x: torch.from_numpy(np.array(x)),
                 lambda x: torch.from_numpy(x).to(torch.bfloat16))


def _zeros_like(tree):
    return torch.utils._pytree.tree_map(
        lambda t: torch.zeros_like(t) if torch.is_tensor(t) else t, tree)


def _assert_tree_equal(got, want):
    """Leaf for leaf, exact: arrays (bfloat16 compared as float32) and
    Python values."""
    import jax

    g = jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)
    w = jax.tree_util.tree_leaves(want, is_leaf=torch.is_tensor)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        if isinstance(x, (bool, int, float, str)):
            assert x == y and type(x) is type(y)
            continue
        x = (x.float().numpy() if torch.is_tensor(x)
             else np.asarray(x, np.float32) if x.dtype.name == "bfloat16"
             else np.asarray(x))
        y = (y.float().numpy() if torch.is_tensor(y)
             else np.asarray(y, np.float32) if y.dtype.name == "bfloat16"
             else np.asarray(y))
        np.testing.assert_array_equal(x, y)
        assert x.shape == y.shape


@pytest.mark.parametrize("chunk", [None, 64])
def test_files_equal_byte_for_byte_and_cross_load(chunk, hvd, tmp_path,
                                                  monkeypatch):
    from flax import serialization

    from horovod_tpu import flax as jflax
    from horovod_tpu_torch import training
    from horovod_tpu_torch.training import _msgpack

    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", chunk)
    a = _arrays(0)
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jflax.save_model(jpath, _jax_tree(a))
    training.save_model(tpath, _torch_tree(a))
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        jbytes, tbytes = f.read(), g.read()
    assert jbytes == tbytes
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in tbytes
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    b = _arrays(1)                       # other values in the templates
    template = _zeros_like(_torch_tree(b))
    keep = torch.utils._pytree.tree_leaves(template)
    got = training.load_model(jpath, template)
    assert got is template
    assert all(x is y for x, y in zip(
        torch.utils._pytree.tree_leaves(got), keep) if torch.is_tensor(x))
    _assert_tree_equal(got, _torch_tree(a))
    jgot = jflax.load_model(tpath, _jax_tree(b), broadcast=False)
    _assert_tree_equal(jgot, _jax_tree(a))


def test_loading_a_live_state_updates_the_model(tmp_path):
    from horovod_tpu_torch import training
    from horovod_tpu_torch._pytree import flatten
    from horovod_tpu_torch.models.train import TrainState

    def build(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                    torch.nn.BatchNorm1d(3))
        opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(1e-3))
        state = TrainState.from_model(model, opt, step=seed)
        with torch.no_grad():
            for t in flatten(state)[0]:
                if t.is_floating_point():
                    t.add_(seed)
        return model, opt, state

    model, _, state = build(1)
    path = str(tmp_path / "live.msgpack")
    training.save_model(path, state)
    other, opt, ostate = build(2)
    weight = other[0].weight
    assert training.load_model(path, ostate) is ostate
    assert other[0].weight is weight
    assert torch.equal(other[0].weight, model[0].weight)
    assert torch.equal(other[1].running_var, model[1].running_var)
    assert int(ostate["step"]) == 1
    assert float(opt.param_groups[0]["lr"]) == float(
        state["opt_state"]["hyperparams"][0]["lr"])
    for x, y in zip(flatten(ostate)[0], flatten(state)[0]):
        assert torch.equal(x, y)


def test_a_truncated_file_raises_as_the_reference(hvd, tmp_path):
    from horovod_tpu import flax as jflax
    from horovod_tpu_torch import training

    a = _arrays(0)
    path = str(tmp_path / "m.msgpack")
    training.save_model(path, _torch_tree(a))
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="incomplete input"):
        jflax.load_model(path, _jax_tree(a), broadcast=False)
    with pytest.raises(ValueError, match="incomplete input"):
        training.load_model(path, _zeros_like(_torch_tree(a)))


@pytest.mark.parametrize("change", ["missing_key", "list_length",
                                    "namedtuple_field"])
def test_a_structure_mismatch_raises_as_the_reference(change, hvd,
                                                      tmp_path):
    from horovod_tpu import flax as jflax
    from horovod_tpu_torch import training

    a = _arrays(0)
    path = str(tmp_path / "m.msgpack")
    training.save_model(path, _torch_tree(a))

    def alter(tree):
        if change == "missing_key":
            tree["params"]["extra"] = tree["params"]["w"]
        elif change == "list_length":
            tree["ints"] = tree["ints"] + [tree["ints"][0]]
        else:
            other = collections.namedtuple("Pair", "first third")
            tree["pair"] = other(*tree["pair"])
        return tree

    match = {"missing_key": "keys do not match",
             "list_length": "size of the list",
             "namedtuple_field": "field names"}[change]
    with pytest.raises(ValueError, match=match):
        jflax.load_model(path, alter(_jax_tree(a)), broadcast=False)
    with pytest.raises(ValueError, match=match):
        training.load_model(path, alter(_zeros_like(_torch_tree(a))))


def test_a_shape_that_differs_raises(tmp_path):
    from horovod_tpu_torch import training

    path = str(tmp_path / "m.msgpack")
    training.save_model(path, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="does not fit"):
        training.load_model(path, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="does not fit"):
        training.load_model(path, {"w": torch.zeros(3, dtype=torch.int32)})


# ---------------------------------------------------------- two ranks


def _worker(rank, n, init, out):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=n)
    hvd.init(device="cpu")
    a = _arrays(rank)
    state = _torch_tree(a)
    path = os.path.join(out, f"model-{rank}.msgpack")
    training.save_model(path, state)
    dist.barrier()
    res = {"exists": [os.path.exists(os.path.join(out, f"model-{r}.msgpack"))
                      for r in range(n)]}
    # Every rank names its own path; only the root's exists, and only the
    # root reads.
    template = _zeros_like(_torch_tree(_arrays(10 + rank)))
    got = training.load_model(path, template, root_rank=0)
    res["same_object"] = got is template
    res["tree"] = torch.utils._pytree.tree_map(
        lambda t: t.float().numpy() if torch.is_tensor(t) else t, got)
    # A bfloat16 array where the template holds no tensor: the root takes
    # it as a tensor, and every rank still walks the template's leaves
    # alike (the tensor after it comes from the root).
    mixed = os.path.join(out, f"mixed-{rank}.msgpack")
    training.save_model(mixed, {"a": torch.full((2,), 1.5 + rank,
                                                 dtype=torch.bfloat16),
                                "b": torch.full((3,), 2.0 + rank),
                                "c": "name"})
    dist.barrier()
    got = training.load_model(mixed, {"a": None, "b": torch.zeros(3),
                                      "c": 0}, root_rank=0)
    res["mixed"] = {k: v.float().numpy() if torch.is_tensor(v) else v
                    for k, v in got.items()}
    res["mixed_a_dtype"] = got["a"].dtype
    hvd.shutdown()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return start_world(2, str(tmp_path_factory.mktemp("save_model")),
                       "test_torch_save_model")


def test_only_rank0_writes_and_the_root_alone_reads(two_ranks):
    want = torch.utils._pytree.tree_map(
        lambda t: t.float().numpy() if torch.is_tensor(t) else t,
        _torch_tree(_arrays(0)))
    for r in two_ranks:
        assert r["exists"] == [True, False]
        assert r["same_object"]
        _assert_tree_equal(r["tree"], want)


def test_a_bfloat16_value_in_a_leaf_that_is_no_tensor_reaches_every_rank(
        two_ranks):
    for r in two_ranks:
        assert r["mixed_a_dtype"] == torch.bfloat16
        np.testing.assert_array_equal(r["mixed"]["a"], [1.5, 1.5])
        np.testing.assert_array_equal(r["mixed"]["b"], [2.0, 2.0, 2.0])
        assert r["mixed"]["c"] == "name"
