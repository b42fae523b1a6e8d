"""The port's ZeRO-1 optimizer (``distributed.zero``) against optax and
the port's plain ``DistributedOptimizer``.

A 2-rank gloo world (two processes, started once for the module) takes
two steps of Adam, AdamW and Adam over an fp16 reduce-scatter wire, each
under ``sharded_distributed_optimizer`` and under ``DistributedOptimizer``,
on three float32 parameters of 9 elements in all (padded to 10: the total
does not divide by the world size) and one float64 parameter of 5 (padded
to 6). Each rank's loss has its own data; every gradient element is a
product of a few factors, so torch's and JAX's float32 gradients agree to
a few ulp.

* The float32 parameters equal ``optax.adam``/``optax.adamw`` on the
  rank-averaged gradients, rtol 2e-5 / atol 1e-6 (the tolerances of
  tests/test_zero.py; optax takes Adam's bias correction in float32 and
  returns updates that are added, torch writes the parameters, about
  1e-7 apart on updates of the learning rate, 0.01), and every parameter
  equals the plain ``DistributedOptimizer``'s to the same tolerance.
  Over the fp16 wire, atol 5e-3: the gradients round to 11 bits, and
  Adam's update stays near the learning rate.
* Each rank's optimizer state holds ``pad / n`` elements per dtype group
  (``shard_info``), and ZeRO issues two collectives per dtype group a
  step.
* In a world of one (this process), ZeRO equals the unwrapped optimizer
  (rtol 1e-6), param groups with different hyperparameters raise, and
  ``broadcast_optimizer_state`` refuses a ZeRO optimizer's rank-local
  state.
"""

import os

import numpy as np
import pytest
import torch

import gloo_worlds


LR = 0.01
WD = 0.1
STEPS = 2
SHAPES = {"a": ((3,), np.float32), "b": ((4,), np.float32),
          "c": ((2,), np.float32), "d": ((5,), np.float64)}
F32 = ("a", "b", "c")
CASES = ("adam", "adamw", "adam_fp16")


def _init():
    rng = np.random.default_rng(21)
    return {n: rng.standard_normal(s).astype(d)
            for n, (s, d) in SHAPES.items()}


def _data(rank, step):
    rng = np.random.default_rng(200 + 10 * rank + step)
    return {n: rng.standard_normal(s).astype(d)
            for n, (s, d) in SHAPES.items()}


def _loss(p, x, xp, names=tuple(SHAPES)):
    """A rank's loss over the parameters ``names``, for torch and
    jax.numpy alike."""
    loss = 0.0
    for n in names:
        if n == "c":
            loss = loss + xp.sum(xp.tanh(p[n]) * x[n])
        else:
            loss = loss + xp.sum(x[n] * p[n] ** 2)
    return loss


def _torch_opt(case, params):
    if case == "adamw":
        return torch.optim.AdamW(params, lr=LR, weight_decay=WD)
    return torch.optim.Adam(params, lr=LR)


def _steps(case, mode, rank):
    """Two steps of one case; the parameters, the collectives issued and
    each state tensor's length."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.distributed.zero import (
        shard_info, sharded_distributed_optimizer)

    params = {n: torch.nn.Parameter(torch.tensor(v))
              for n, v in _init().items()}
    comp = hvd.Compression.fp16 if case == "adam_fp16" else None
    opt = _torch_opt(case, list(params.values()))
    if mode == "zero":
        opt = sharded_distributed_optimizer(opt, compression=comp)
    else:
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=list(params.items()),
            compression=comp or hvd.Compression.none)
    before = (sharded_distributed_optimizer.collectives,
              fused_reduce.collectives)
    for step in range(1, STEPS + 1):
        opt.zero_grad()
        x = {n: torch.tensor(v) for n, v in _data(rank, step).items()}
        _loss(params, x, torch).backward()
        opt.step()
    out = {"params": {n: p.detach().numpy() for n, p in params.items()},
           "collectives": (sharded_distributed_optimizer.collectives
                           - before[0], fused_reduce.collectives
                           - before[1])}
    if mode == "zero":
        out["shard_info"] = shard_info(opt)
        out["state_lens"] = sorted(
            (str(s["exp_avg"].dtype), s["exp_avg"].numel())
            for s in opt.state.values())
    return out


def _worker(rank, init, out):
    from datetime import timedelta

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=30))
    hvd.init(device="cpu")
    res = {(case, mode): _steps(case, mode, rank)
           for case in CASES for mode in ("zero", "plain")}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results; fails, after killing both, if either errs or
    outlives 60 s (the gloo timeout is 30 s)."""
    out = str(tmp_path_factory.mktemp("zero"))
    init = gloo_worlds.init_url(out)
    gloo_worlds.spawn("test_torch_zero", "_worker",
                      [(r, init, out) for r in range(2)], 60)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _optax(case):
    import jax
    import jax.numpy as jnp
    import optax

    params = {n: jnp.asarray(v) for n, v in _init().items() if n in F32}
    tx = (optax.adamw(LR, weight_decay=WD) if case == "adamw"
          else optax.adam(LR))
    state = tx.init(params)
    for step in range(1, STEPS + 1):
        grads = [jax.grad(_loss)(params, {n: jnp.asarray(v) for n, v in
                                          _data(rank, step).items()},
                                 jnp, F32) for rank in (0, 1)]
        mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
        updates, state = tx.update(mean, state, params)
        params = optax.apply_updates(params, updates)
    return {n: np.asarray(v) for n, v in params.items()}


@pytest.mark.parametrize("case", CASES)
def test_zero_matches_optax_and_the_plain_optimizer(two_ranks, case):
    want = _optax(case)
    start = _init()
    atol = 5e-3 if case == "adam_fp16" else 1e-6
    for res in two_ranks:
        zero, plain = res[(case, "zero")], res[(case, "plain")]
        for n in F32:
            assert np.abs(want[n] - start[n]).min() > 5e-3   # it moved
            np.testing.assert_allclose(zero["params"][n], want[n],
                                       rtol=2e-5, atol=atol, err_msg=n)
        for n in SHAPES:
            np.testing.assert_allclose(zero["params"][n],
                                       plain["params"][n], rtol=2e-5,
                                       atol=atol, err_msg=n)
    for n in SHAPES:
        np.testing.assert_array_equal(two_ranks[0][(case, "zero")]["params"]
                                      [n], two_ranks[1][(case, "zero")]
                                      ["params"][n])


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_slice_of_the_state(two_ranks, case):
    for res in two_ranks:
        zero = res[(case, "zero")]
        # 9 float32 elements pad to 10, 5 float64 ones to 6.
        assert zero["shard_info"] == {"float32": (10, 5),
                                      "float64": (6, 3)}
        assert zero["state_lens"] == [("torch.float32", 5),
                                      ("torch.float64", 3)]
        # Two collectives per dtype group a step; none of the buckets'.
        assert zero["collectives"] == (2 * 2 * STEPS, 0)
        assert res[(case, "plain")]["collectives"][0] == 0


@pytest.fixture
def world():
    from horovod_tpu_torch.common import basics

    basics.init(device="cpu")
    yield
    basics.shutdown()


@pytest.mark.parametrize("case", ["adam", "adamw"])
def test_world_of_one_equals_the_unwrapped_optimizer(world, case):
    from horovod_tpu_torch.distributed.zero import (
        shard_info, sharded_distributed_optimizer)

    out = {}
    for wrapped in (False, True):
        params = {n: torch.nn.Parameter(torch.tensor(v))
                  for n, v in _init().items()}
        opt = _torch_opt(case, list(params.values()))
        if wrapped:
            opt = sharded_distributed_optimizer(opt)
            assert shard_info(opt) == {"float32": (9, 9), "float64": (5, 5)}
        for step in range(1, 4):
            opt.zero_grad()
            x = {n: torch.tensor(v) for n, v in _data(0, step).items()}
            _loss(params, x, torch).backward()
            opt.step()
        out[wrapped] = params
    for n in SHAPES:
        np.testing.assert_allclose(out[True][n].detach().numpy(),
                                   out[False][n].detach().numpy(),
                                   rtol=1e-6, atol=0, err_msg=n)


def test_bad_groups_and_state_broadcast_raise(world):
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError

    a, b = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    with pytest.raises(ValueError, match="hyperparameters"):
        hvd.sharded_distributed_optimizer(torch.optim.Adam(
            [{"params": [a]}, {"params": [b], "lr": 0.5}], lr=0.1))
    same = hvd.sharded_distributed_optimizer(torch.optim.Adam(
        [{"params": [a]}, {"params": [b]}], lr=0.1))
    assert same.param_groups[0]["lr"] == 0.1
    with pytest.raises(InvalidArgumentError, match="rank"):
        hvd.broadcast_optimizer_state(same, root_rank=0)


def test_create_train_state_zero_ignores_overlap(world):
    from horovod_tpu_torch.distributed.zero import ZeroOptimizer
    from horovod_tpu_torch.models.train import create_train_state
    from horovod_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(vocab_size=32, num_layers=1, num_heads=2,
                          embed_dim=16, max_len=16, dtype=torch.float32,
                          device="cpu")
    opt = create_train_state(model, torch.optim.Adam(model.parameters()),
                             overlap="on", zero=True, device="cpu")
    assert isinstance(opt, ZeroOptimizer)
    with pytest.raises(ValueError, match="one backward pass"):
        create_train_state(model, torch.optim.Adam(model.parameters()),
                           backward_passes_per_step=2, zero=True,
                           device="cpu")
