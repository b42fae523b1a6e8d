"""Cross-replica BatchNorm: ``ConvBN`` / ``ResNet(axis_name="hvd")`` in a
2-rank gloo world against one rank over the whole batch, and against the
JAX package.

Sync-BN over 2 ranks with B/2 images each takes the statistics of all B
images, so each rank's logits are the single-rank model's on its half,
each rank's new running statistics are the single rank's, and, with each
rank's loss its images' summed cross-entropy over B (the single rank's
mean, split), the gradients summed over the ranks are the single rank's:
the statistics' all-reduce carries every rank's cotangent to every other
rank in the backward pass. The model is tests/test_torch_resnet.py's small
bottleneck ResNet (``stage_sizes [1, 1, 1, 1]``, 8 filters, float32,
32^2, 4 images), fused (K5's plain version; the ``s1``/``s2``/``n`` sums
reduced) and unfused (the two moments' means reduced). Then the single
rank is held against flax on the same 4 images, and the two ranks against
the JAX model with ``axis_name="hvd"`` under ``shard_map`` over 2 CPU
devices. Tolerances, each with its reason:

* ranks against the single rank: logits and running statistics ``atol
  1e-5``, summed gradients ``rtol 1e-4`` with an absolute bound of 1e-4
  of each gradient's largest entry: the same float32 values, the
  statistics summed in two parts and then across ranks;
* against flax: logits ``atol 5e-4`` and statistics ``atol 5e-5``, the
  bounds of tests/test_torch_resnet.py at this model (float32 sums in
  another order, amplified by BatchNorm over few values a channel).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.parallel import _collectives as coll

import gloo_worlds

B, HW, CLASSES, SEED = 4, 32, 10, 3
SMALL = dict(stage_sizes=[1, 1, 1, 1], num_classes=CLASSES, num_filters=8)


def _batch():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((B, HW, HW, 3)).astype(np.float32),
            rng.integers(0, CLASSES, B).astype(np.int64))


def _model(fused, axis_name=None):
    return tresnet.ResNet(block_cls=tresnet.BottleneckResNetBlock,
                          dtype=torch.float32, fused_bn=fused,
                          axis_name=axis_name, seed=SEED, device="cpu",
                          **SMALL)


def _step(model, x, y):
    """Train-mode forward and backward of ``sum(CE) / B`` on ``x``:
    logits, new running statistics and gradients by name."""
    model.train()
    logits = model(torch.tensor(x))
    logp = torch.log_softmax(logits, -1)
    loss = -logp[torch.arange(len(y)), torch.tensor(y)].sum() / B
    loss.backward()
    return {"logits": logits.detach().numpy(),
            "stats": {n: b.numpy().copy() for n, b in model.named_buffers()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()}}


def _worker(rank, init, out):
    from datetime import timedelta

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    hvd.init(device="cpu")
    x, y = _batch()
    half = slice(rank * B // 2, (rank + 1) * B // 2)
    res = {fused: _step(_model(fused, "hvd"), x[half], y[half])
           for fused in (False, True)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sync_bn"))
    init = gloo_worlds.init_url(out)
    gloo_worlds.spawn("test_torch_sync_bn", "_worker",
                      [(r, init, out) for r in range(2)], 180)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@functools.lru_cache(maxsize=None)
def _single(fused):
    x, y = _batch()
    return _step(_model(fused), x, y)


@pytest.mark.parametrize("fused", [False, True])
def test_two_ranks_equal_one_rank_over_the_whole_batch(ranks, fused):
    one = _single(fused)
    logits = np.concatenate([r[fused]["logits"] for r in ranks])
    np.testing.assert_allclose(logits, one["logits"], rtol=0, atol=1e-5)
    for r in ranks:
        for name, want in one["stats"].items():
            np.testing.assert_allclose(r[fused]["stats"][name], want,
                                       rtol=0, atol=1e-5, err_msg=name)
    for name, want in one["grads"].items():
        got = ranks[0][fused]["grads"][name] + ranks[1][fused]["grads"][name]
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_per_rank_statistics_would_differ(ranks, fused):
    """Without the reduction each rank normalises with its own half's
    statistics: the synced ranks' logits are not those."""
    x, y = _batch()
    local = np.concatenate([
        _step(_model(fused), x[h], y[h])["logits"]
        for h in (slice(0, B // 2), slice(B // 2, B))])
    synced = np.concatenate([r[fused]["logits"] for r in ranks])
    assert np.abs(local - synced).max() > 1e-2


def _flax_variables(model):
    """The port model's variables as a flax tree (the inverse layouts)."""
    tree = {}
    for path, t, layout in tresnet.flax_parameter_map(model):
        arr = t.detach().numpy()
        if layout == "hwio":
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif layout == "t":
            arr = arr.T
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(arr)
    return tree


def _jmodel(fused, axis_name=None):
    return jresnet.ResNet(block_cls=jresnet.BottleneckResNetBlock,
                          dtype=jnp.float32, fused_bn=fused,
                          axis_name=axis_name, **SMALL)


def _port_stats_by_path(model, stats):
    by_name = {id(b): n for n, b in model.named_buffers()}
    return {path: stats[by_name[id(t)]] for path, t, _ in
            tresnet.flax_parameter_map(model) if path[0] == "batch_stats"}


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


@pytest.mark.parametrize("fused", [False, True])
def test_one_rank_matches_flax(fused):
    x, _ = _batch()
    model = _model(fused)
    v = _flax_variables(model)
    logits, mut = jax.jit(functools.partial(
        _jmodel(fused).apply, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
    one = _single(fused)
    np.testing.assert_allclose(one["logits"], np.asarray(logits), rtol=0,
                               atol=5e-4)
    want = dict(_leaves({"batch_stats": mut["batch_stats"]}))
    for path, got in _port_stats_by_path(model, one["stats"]).items():
        np.testing.assert_allclose(got, want[path], rtol=0, atol=5e-5,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("fused", [False, True])
def test_two_ranks_match_jax_axis_name_under_shard_map(ranks, fused):
    """The JAX model with ``axis_name="hvd"`` under ``shard_map`` over 2
    devices, half the batch each: its logits and psum'd statistics are
    the port's ranks'."""
    x, _ = _batch()
    model = _model(fused)
    v = _flax_variables(model)
    jm = _jmodel(fused, "hvd")

    def fwd(v, x):
        logits, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return logits, mut["batch_stats"]

    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    logits, stats = jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(P(), P("hvd")),
        out_specs=(P("hvd"), P()), check_vma=False))(v, jnp.asarray(x))
    got = np.concatenate([r[fused]["logits"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(logits), rtol=0, atol=5e-4)
    want = dict(_leaves({"batch_stats": stats}))
    for r in ranks:
        for path, t in _port_stats_by_path(model, r[fused]["stats"]).items():
            np.testing.assert_allclose(t, want[path], rtol=0, atol=5e-5,
                                       err_msg="/".join(path))


def test_named_axis_resolution():
    """The SPMD region's axis by its name, then a bound mesh's axis, then
    the job's ``"hvd"``; another name raises. In a world of one every
    axis has size 1 and ``psum`` returns its input."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.parallel import LogicalMesh, bind

    hvd.init(device="cpu")
    try:
        assert coll.named_axis("hvd") == (basics.job_group(), 1)
        with pytest.raises(InvalidArgumentError, match="'batch'"):
            coll.named_axis("batch")
        with bind(LogicalMesh.from_config("dp=1")):
            assert coll.named_axis("dp")[1] == 1
        token = basics.set_spmd_axis(basics.SpmdAxis("batch", None, 1, 0))
        try:
            assert coll.named_axis("batch") == (None, 1)
        finally:
            basics.reset_spmd_axis(token)
        t = torch.ones(3, requires_grad=True)
        assert coll.psum(t, "hvd") is t
        assert torch.equal(coll.pmean(t, "hvd"), t)
        cb = tresnet.ConvBN(3, 4, (1, 1), dtype=torch.float32,
                            axis_name="hvd", fuse=True).train()
        ref = tresnet.ConvBN(3, 4, (1, 1), dtype=torch.float32,
                             fuse=True).train()
        with torch.no_grad():
            cb.weight.normal_()
        ref.load_state_dict(cb.state_dict())
        x = torch.randn(2, 3, 4, 4)
        assert torch.allclose(cb(x), ref(x), rtol=0, atol=1e-6)
    finally:
        basics.shutdown()
