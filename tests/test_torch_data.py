"""The port's data package against ``horovod_tpu.data``.

``horovod_tpu_torch.data.sharding`` is a copy of the JAX package's numpy
code with the port's rank and size, so every case of tests/test_data.py
must give the same integers, exactly. The stager
(``prefetch_to_device`` / ``window_batches`` / ``prefetch_windows``) must
group and order as the JAX one does, the trailing short window and the
no-axis ``K = 1`` path included; on the CPU it yields tensors. The copy
onto the card (pinned memory, a side stream, an event the consumer waits
on) runs only there, driven by ``chip_smoke.py``'s window phase.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu_torch import data
from horovod_tpu_torch.common import basics

SHARD_CASES = [
    dict(n=103, epoch=0, rank=r, size=8) for r in (0, 3, 7)] + [
    dict(n=103, epoch=0, rank=r, size=8, drop_remainder=True)
    for r in (0, 5)] + [
    dict(n=64, epoch=e, rank=1, size=4) for e in (0, 1)] + [
    dict(n=8, rank=1, size=4, shuffle=False),
    dict(n=3, rank=7, size=8), dict(n=3, rank=0, size=8),
    dict(n=10, rank=2, size=4, seed=5),
]


@pytest.mark.parametrize("kw", SHARD_CASES, ids=str)
def test_shard_indices_equal_jax(kw):
    np.testing.assert_array_equal(data.shard_indices(**kw),
                                  jdata.shard_indices(**kw))


def test_bad_rank_rejected_like_jax():
    with pytest.raises(ValueError) as want:
        jdata.shard_indices(8, rank=4, size=4)
    with pytest.raises(ValueError) as got:
        data.shard_indices(8, rank=4, size=4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,rank,size,drop", [(10, 0, 4, False),
                                              (3, 7, 8, False),
                                              (103, 2, 8, True)])
def test_sampler_equals_jax_across_epochs(n, rank, size, drop):
    got = data.DistributedSampler(n, rank=rank, size=size,
                                  drop_remainder=drop)
    want = jdata.DistributedSampler(n, rank=rank, size=size,
                                    drop_remainder=drop)
    assert len(got) == len(want)
    for epoch in (0, 1, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want)


def test_sampler_defaults_to_the_port_world():
    """Rank and size come from the port's world: one process, so the
    sampler covers everything, initialised or not."""
    assert sorted(data.DistributedSampler(16)) == list(range(16))
    basics.init(device="cpu")
    try:
        s = data.DistributedSampler(16)
        assert (s.rank, s.size) == (0, 1)
        assert sorted(s) == list(range(16))
    finally:
        basics.shutdown()


@pytest.mark.parametrize("kw", [dict(rank=0, size=2, shuffle=False),
                                dict(rank=1, size=2, shuffle=True, seed=3),
                                dict(rank=0, size=3, epoch=2)], ids=str)
def test_iterate_sharded_equals_jax(kw):
    arrays = {"x": np.arange(64).reshape(32, 2), "y": np.arange(32)}
    got = list(data.iterate_sharded(arrays, batch_size=3, **kw))
    want = list(jdata.iterate_sharded(arrays, batch_size=3, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_iterate_sharded_length_mismatch_rejected():
    with pytest.raises(ValueError, match="lengths differ"):
        next(data.iterate_sharded({"x": np.zeros(4), "y": np.zeros(5)},
                                  batch_size=2))


def test_prefetch_yields_everything_in_order_as_tensors():
    items = [{"x": np.full((2,), i), "t": (np.float32(i),)}
             for i in range(7)]
    out = list(data.prefetch_to_device(items, size=3, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), [i, i])
        assert float(b["t"][0]) == i


def test_prefetch_pulls_at_most_size_ahead():
    """``size`` items are staged before the first yield, then one more per
    item taken (the JAX stager's look-ahead)."""
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield np.full((1,), i)

    it = data.prefetch_to_device(source(), size=2, device="cpu")
    assert int(next(it)[0]) == 0 and pulled == [0, 1]
    assert int(next(it)[0]) == 1 and pulled == [0, 1, 2]


def test_prefetch_bad_size_and_default_device():
    with pytest.raises(ValueError, match=">= 1"):
        next(data.prefetch_to_device([], size=0, device="cpu"))
    with pytest.raises(ValueError, match=">= 1"):
        next(data.prefetch_windows([], 0, device="cpu"))


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(data.prefetch_to_device([np.zeros(2)]))


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8])
def test_windows_group_and_order_as_jax(hvd, k):
    """Window i holds batches [i*K, (i+1)*K) with a shorter tail, and
    K = 1 adds no window axis, as JAX's prefetch_windows."""
    items = [{"x": np.full((4,), i, np.float32), "y": np.arange(3) + i}
             for i in range(7)]
    want = list(jdata.prefetch_windows(items, k, size=2))
    got = list(data.prefetch_windows(items, k, size=2, device="cpu"))
    host = list(data.window_batches(items, k)) if k > 1 else items
    assert len(got) == len(want) == len(host)
    for g, w, h in zip(got, want, host):
        for key in ("x", "y"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
            np.testing.assert_array_equal(np.asarray(h[key]),
                                          np.asarray(w[key]))
