"""The port's hierarchical bucket ladder and its int8/fp8 codecs in a
world of 8, against exact answers and the JAX package.

One 8-rank gloo world (eight processes, started once for the module by
the ``eight_ranks`` fixture) runs every case and returns each rank's
results; the JAX side runs in this process on its 8-device virtual
mesh, as ``tests/test_hierarchical.py`` does. Inner 4 gives 2 hosts (the
int8/fp8 all-gather exchange), inner 2 gives 4 (the two-stage
all-to-all exchange).

* Exact: on integer-valued tensors (every summation order exact) the
  ladder equals the flat exchange bit for bit at inner 4 and 2, overlap
  on and off, average on and off, and under fp16; a Min bucket takes the
  flat path; on quantization-grid data (every rank the same tensor of
  -1/0/1) int8 and fp8 Average equal the flat Average bit for bit (a
  second divide would be off by 8x), and error feedback leaves residuals
  at the ulp of the scale.
* Against the JAX package: int8 and fp8 outputs on Gaussian data (rtol
  1e-6, atol 1e-6 x the largest output: XLA fuses multiply-adds, the
  port rounds each product), and on the JAX tests' integer data within
  0.05 x scale of the flat result; ten error-feedback steps whose
  running mean converges (``last_err < 0.35 * first_err``) on both
  sides, the first step's outputs and every rank's residuals equal to
  the JAX ones but for rounding ties (the intra-host sums of
  non-integer data differ by an ulp between gloo's order and XLA's: at
  most 2% of the elements one quantization step apart), and the final
  residuals within a step; a small LM
  under ``DistributedOptimizer(Adam, hierarchical="on",
  compression=int8|fp8)`` for three steps, hooks on and off, against
  ``horovod_tpu.jax.DistributedOptimizer(optax.adam)`` fed every rank's
  own gradients (atol 1e-6, as ``test_torch_distributed.py`` holds Adam;
  residuals rtol 1e-5 / atol 1e-6); the bench record's ``hierarchical``
  and ``wire`` fields against the JAX ``bench.wire_stamp``.
* The loud failures of the JAX package: residuals of the wrong number or
  shape, residuals where the ladder resolves flat, an unknown mode; and
  residuals passing through untouched where no quantized leg runs.
* The rest of the surface: a linear model's integer gradients through
  ``DistributedOptimizer`` on the ladder equal the flat ones bit for bit
  with hooks and without; ``allreduce(hierarchical="on")``,
  ``hierarchical_allreduce_in_axis`` and ``hierarchical_allreduce`` over a
  ``LogicalMesh``'s ``DeviceMesh`` equal the flat sum; the two-phase
  ``allgather`` equals the flat one; ``state_dict`` carries the
  residuals and a window over a quantized ladder raises.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import gloo_worlds

WORLD = 8
_SHAPES = [(33,), (7, 5), (101,), (4, 4, 4), (257,)]
_THRESHOLD = 400        # a multi-bucket plan with an oversize singleton
INNERS = [4, 2]
CODECS = ["int8", "fp8"]
EF_STEPS = 10
LM_CFG = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
              max_len=32, dtype=torch.float32)
LM_THRESHOLD = 2000     # 16 buckets over the tiny LM's 27 parameters
LM_STEPS = 3
LM_LR = 1e-2
# (inner, codec) of the LM runs: both exchange shapes, both codecs.
LM_RUNS = [(4, "int8"), (2, "fp8")]
BENCH_FLAGS = ["--seq-len", "16", "--batch-size", "2", "--lm-layers", "2",
               "--lm-dim", "16", "--lm-heads", "2", "--vocab", "32",
               "--fp32", "--num-warmup-batches", "1",
               "--num-batches-per-iter", "1", "--num-iters", "1",
               "--hierarchical", "on"]
BENCH_THRESHOLD = 4096


def _bases(seed=0, lo=-8, hi=8):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randint(lo, hi, size=s), np.float32)
            for s in _SHAPES]


def _grid():
    rng = np.random.RandomState(5)
    return [np.asarray(rng.randint(-1, 2, size=s), np.float32)
            for s in _SHAPES]


def _normal(seed=7):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.standard_normal(s) * 3, np.float32)
            for s in _SHAPES]


def _n_buckets():
    from horovod_tpu_torch.distributed.fusion import plan_buckets

    return len(plan_buckets([torch.zeros(s) for s in _SHAPES], _THRESHOLD))


def _ef_bases():
    return [b * np.float32(0.37) for b in _bases(seed=9)]


# ------------------------------------------------------------ the world


def _linear_grads(rank):
    """Integer-valued tensors: the gradients of ``sum(p * c)``."""
    return [torch.tensor(b) * (rank + 1) for b in _bases(seed=3)]


def _linear_steps(rank, hierarchical, overlap):
    """Two SGD(lr 1) steps of parameters whose gradients are integers,
    under DistributedOptimizer: the parameters after each."""
    from horovod_tpu_torch import distributed as hvd

    params = [torch.nn.Parameter(torch.zeros(s)) for s in _SHAPES]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=1.0), overlap=overlap,
        hierarchical=hierarchical, fusion_threshold=_THRESHOLD)
    out = []
    for _ in range(2):
        opt.zero_grad()
        sum((p * c).sum() for p, c in zip(params, _linear_grads(rank))
            ).backward()
        opt.step()
        out.append([p.detach().clone().numpy() for p in params])
    return {"params": out, "hooked": opt._hvd_exchange is not None}


def _lm_run(rank, inner, codec, overlap):
    """Three Adam steps of the tiny LM on this rank's rows under the
    quantized ladder: each step's local gradients, parameters and
    residuals."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models.train import next_token_loss
    from horovod_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**LM_CFG, seed=0, device="cpu")
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(params, lr=LM_LR),
        named_parameters=model.named_parameters(),
        compression=getattr(hvd.Compression, codec), hierarchical="on",
        overlap=overlap, fusion_threshold=LM_THRESHOLD)
    init = [p.detach().clone().numpy() for p in params]
    res0 = [r.clone().numpy() for r in opt.residuals]
    rng = np.random.default_rng(11)
    steps = []
    for _ in range(LM_STEPS):
        toks = torch.tensor(rng.integers(0, 32, (WORLD, 16)))[rank:rank + 1]
        opt.zero_grad()
        loss = next_token_loss(model(toks), toks)
        loss.backward()
        grads = [p.grad.detach().clone().numpy() for p in params]
        opt.step()
        steps.append({
            "grads": grads, "loss": float(loss),
            "params": [p.detach().clone().numpy() for p in params],
            "residuals": [r.clone().numpy() for r in opt.residuals]})
    state = opt.state_dict()
    fresh = hvd.DistributedOptimizer(
        torch.optim.Adam(TransformerLM(**LM_CFG, seed=1,
                                       device="cpu").parameters(),
                         lr=LM_LR),
        compression=getattr(hvd.Compression, codec), hierarchical="on",
        fusion_threshold=LM_THRESHOLD)
    fresh.load_state_dict(state)
    return {"init": init, "res0": res0, "steps": steps,
            "inner": opt.hierarchical_inner,
            "hooked": opt._hvd_exchange is not None,
            "state_residuals": [r.numpy() for r in state["hvd_residuals"]],
            "loaded": [r.numpy() for r in fresh.residuals],
            "window": _window_refusal(model, opt)}


def _window_refusal(model, opt):
    from horovod_tpu_torch.distributed.window import windowed
    from horovod_tpu_torch.models.train import make_train_step

    try:
        windowed(make_train_step(model, opt), 2)(torch.zeros(
            (2, 1, 16), dtype=torch.long))
    except NotImplementedError as e:
        return str(e)
    return None


def _error(fn):
    try:
        fn()
    except Exception as e:                 # noqa: BLE001 - the message
        return (type(e).__name__, str(e))
    return None


def _worker(rank, init, out):
    """One rank of the 8-process gloo world: every case, results saved."""
    import torch.distributed as dist

    from horovod_tpu_torch import bench
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.parallel import mesh as tm
    from horovod_tpu_torch.parallel.logical import LogicalMesh

    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=WORLD)
    hvd.init(device="cpu")
    cfg = basics.config()
    res = {}

    def reduce(bases, same=False, **kw):
        ts = [torch.tensor(b) * (1 if same else rank + 1) for b in bases]
        before = fused_reduce.collectives
        kw.setdefault("fusion_threshold", _THRESHOLD)
        got = hvd.fused_reduce(ts, **kw)
        if isinstance(got, tuple):
            got = (got[0], [r.clone().numpy() for r in got[1]])
            return ([o.numpy() for o in got[0]], got[1],
                    fused_reduce.collectives - before)
        return [o.numpy() for o in got], fused_reduce.collectives - before

    for average in (False, True):
        res[("flat", average)] = reduce(_bases(), average=average,
                                        hierarchical="off")
    res["flat_fp16"] = reduce(_bases(seed=1), hierarchical="off",
                              compression=hvd.Compression.fp16)
    res["flat_min"] = reduce(_bases(seed=2, lo=0, hi=9), op=hvd.Min,
                             hierarchical="off")
    res["flat_random"] = {avg: reduce(_bases(seed=7), average=avg,
                                      hierarchical="off")
                          for avg in (False, True)}
    res["int8_no_ladder"] = reduce(_bases(seed=8), hierarchical="off",
                                   compression=hvd.Compression.int8)
    res["grid_flat"] = reduce(_grid(), same=True, hierarchical="off")
    for inner in INNERS:
        cfg.hierarchical_inner_size = inner
        for overlap in ("off", "on"):
            for average in (False, True):
                res[("hier", inner, overlap, average)] = reduce(
                    _bases(), average=average, overlap=overlap,
                    hierarchical="on")
        res[("fp16", inner)] = reduce(_bases(seed=1), hierarchical="on",
                                      compression=hvd.Compression.fp16)
        res[("min", inner)] = reduce(_bases(seed=2, lo=0, hi=9),
                                     op=hvd.Min, hierarchical="on")
        for codec in CODECS:
            comp = getattr(hvd.Compression, codec)
            res[("grid", inner, codec)] = reduce(
                _grid(), same=True, hierarchical="on", compression=comp)
            res[("random", inner, codec)] = {
                avg: reduce(_bases(seed=7), average=avg, hierarchical="on",
                            compression=comp) for avg in (False, True)}
            res[("normal", inner, codec)] = {
                avg: reduce(_normal(), average=avg, hierarchical="on",
                            compression=comp) for avg in (False, True)}
        specs = hvd.ef_residual_specs([torch.zeros(s) for s in _SHAPES],
                                      _THRESHOLD, WORLD, inner)
        residuals = [torch.zeros_like(s, device="cpu") for s in specs]
        outs, first = [], None
        for _ in range(EF_STEPS):
            o, r, _ = reduce(_ef_bases(), hierarchical="on",
                             compression=hvd.Compression.int8,
                             residuals=residuals)
            residuals = [torch.tensor(x) for x in r]
            outs.append(o)
            first = r if first is None else first
        res[("ef", inner)] = (outs, [r.numpy() for r in residuals], first)
        zero = [torch.zeros_like(s, device="cpu") for s in specs]
        res[("ef_grid", inner)] = reduce(
            _grid(), same=True, hierarchical="on",
            compression=hvd.Compression.int8, residuals=zero)
        ts = [torch.tensor(b) for b in _bases()]
        res[("errors", inner)] = {
            "count": _error(lambda: hvd.fused_reduce(
                ts, compression=hvd.Compression.int8, hierarchical="on",
                fusion_threshold=_THRESHOLD,
                residuals=(torch.zeros(3),))),
            "shape": _error(lambda: hvd.fused_reduce(
                ts, compression=hvd.Compression.int8, hierarchical="on",
                fusion_threshold=_THRESHOLD,
                residuals=[torch.zeros(s.shape[0] + 1) for s in specs])),
            "mode": _error(lambda: hvd.fused_reduce(
                ts, hierarchical="sometimes")),
        }
        marker = (torch.full((7,), 3.25),)
        res[("passthrough", inner)] = [
            hvd.fused_reduce(ts, fusion_threshold=_THRESHOLD,
                             hierarchical=h, compression=c,
                             residuals=marker)[1][0].numpy()
            for h, c in (("off", hvd.Compression.none),
                         ("on", hvd.Compression.none),
                         ("on", hvd.Compression.fp16))]
        for overlap in ("off", "on"):
            res[("linear", inner, overlap)] = _linear_steps(rank, "on",
                                                            overlap)
        x = torch.tensor(_bases(seed=4)[1]) * (rank + 1)
        res[("allreduce", inner)] = (
            hvd.allreduce(x, average=False, hierarchical="on").numpy(),
            hvd.synchronize(hvd.allreduce_async(
                x, hierarchical="on")).numpy(),
            tm.hierarchical_allreduce_in_axis(x, inner).numpy())
        cfg.hierarchical_allgather = True
        res[("allgather", inner)] = hvd.allgather(
            torch.arange(6.0).reshape(3, 2) + 10 * rank).numpy()
        cfg.hierarchical_allgather = False
    cfg.hierarchical_inner_size = 8
    res["flat_resolution"] = _error(lambda: hvd.fused_reduce(
        [torch.ones(4)], compression=hvd.Compression.int8,
        hierarchical="on", residuals=(torch.zeros(2),)))
    cfg.hierarchical_inner_size = 0
    for overlap in ("off", "on"):
        res[("linear_flat", overlap)] = _linear_steps(rank, "off", overlap)
    x = torch.tensor(_bases(seed=4)[1]) * (rank + 1)
    res["allreduce_flat"] = hvd.allreduce(x, average=False).numpy()
    res["allgather_flat"] = hvd.allgather(
        torch.arange(6.0).reshape(3, 2) + 10 * rank).numpy()
    lm = LogicalMesh({"dcn": 2, "ici": 4}, domains=[r // 4
                                                    for r in range(WORLD)])
    res["device_mesh"] = (
        lm.ranks.tolist(),
        tm.hierarchical_allreduce(x, lm, average=True).numpy(),
        dist.get_process_group_ranks(lm.mesh.get_group("ici")))
    for inner, codec in LM_RUNS:
        cfg.hierarchical_inner_size = inner
        for overlap in ("off", "on"):
            res[("lm", inner, codec, overlap)] = _lm_run(rank, inner, codec,
                                                         overlap)
    cfg.hierarchical_inner_size = 4
    cfg.fusion_threshold = BENCH_THRESHOLD
    rec = {}
    for codec in ("none", "int8"):
        r = bench.run(bench.build_parser().parse_args(
            BENCH_FLAGS + ["--compression", codec]), device="cpu")
        rec[codec] = {k: r[k] for k in ("hierarchical", "wire",
                                        "replicas_in_sync", "loss",
                                        "buckets")}
    res["bench"] = rec
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Runs :func:`_worker` in 8 processes; fails, after killing them
    all, if any exits with an error or outlives its time limit."""
    out = str(tmp_path_factory.mktemp("eight_ranks"))
    init = gloo_worlds.init_url(out)
    gloo_worlds.spawn("test_torch_hierarchical", "_worker",
                      [(r, init, out) for r in range(WORLD)], 240)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


# --------------------------------------------------------- the JAX side


@contextlib.contextmanager
def _inner_size(inner):
    from horovod_tpu.common import state

    cfg = state.global_state().config
    saved = cfg.hierarchical_inner_size
    cfg.hierarchical_inner_size = inner
    try:
        yield
    finally:
        cfg.hierarchical_inner_size = saved


def _jax_reduce(hvd, bases, *, inner, compression, average=True,
                same=False):
    from horovod_tpu.jax.fusion import fused_reduce

    def fn():
        ts = [b if same else b * (hvd.rank() + 1).astype(b.dtype)
              for b in bases]
        return tuple(fused_reduce(ts, average=average,
                                  compression=compression,
                                  fusion_threshold=_THRESHOLD,
                                  overlap="off", hierarchical="on"))

    with _inner_size(inner):
        return [np.asarray(o) for o in hvd.spmd_run(fn)]


def _summed(bases, n=WORLD):
    """The exact flat sum of ``b * (rank + 1)`` over the ranks."""
    return [b * (n * (n + 1) // 2) for b in bases]


# ------------------------------------------------------------ exactness


def test_every_rank_holds_the_same_results(eight_ranks):
    first = eight_ranks[0]
    for res in eight_ranks[1:]:
        for key in [k for k in first if isinstance(k, tuple)
                    and k[0] in ("hier", "random", "grid")]:
            a, b = first[key], res[key]
            if isinstance(a, dict):
                a, b = a[True], b[True]
            for x, y in zip(a[0], b[0]):
                np.testing.assert_array_equal(x, y, err_msg=str(key))


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("overlap", ["off", "on"])
@pytest.mark.parametrize("average", [False, True])
def test_hier_matches_flat_bitexact(eight_ranks, inner, overlap, average):
    want = _summed(_bases())
    if average:
        want = [w / WORLD for w in want]
    for res in eight_ranks:
        flat, _ = res[("flat", average)]
        got, collectives = res[("hier", inner, overlap, average)]
        for w, f, g in zip(want, flat, got):
            np.testing.assert_array_equal(f, w)
            np.testing.assert_array_equal(g, f)
        # Three collectives a bucket: reduce-scatter, all-reduce across
        # hosts, all-gather.
        assert collectives == 3 * _n_buckets()


@pytest.mark.parametrize("inner", INNERS)
def test_hier_cast_compression_and_min_bitexact(eight_ranks, inner):
    for res in eight_ranks:
        for flat, got in ((res["flat_fp16"], res[("fp16", inner)]),
                          (res["flat_min"], res[("min", inner)])):
            for f, g in zip(flat[0], got[0]):
                np.testing.assert_array_equal(g, f)
        # Min takes the flat path: one collective a bucket.
        assert res[("min", inner)][1] == res["flat_min"][1] == _n_buckets()
    np.testing.assert_array_equal(eight_ranks[0]["flat_min"][0][0],
                                  _bases(seed=2, lo=0, hi=9)[0])


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("codec", CODECS)
def test_quantized_average_no_double_scaling(eight_ranks, inner, codec):
    for res in eight_ranks:
        flat, _ = res["grid_flat"]
        got, collectives = res[("grid", inner, codec)]
        for b, f, g in zip(_grid(), flat, got):
            np.testing.assert_array_equal(f, b)
            np.testing.assert_array_equal(g, f)
        # A bucket: reduce-scatter, the quantized exchange (one all-gather
        # at 2 hosts; all-to-all + scale gather + all-gather at 4),
        # all-gather.
        assert collectives == _n_buckets() * (3 if inner == 4 else 5)


def test_quantizer_without_hier_is_lossless(eight_ranks):
    for res in eight_ranks:
        for w, g in zip(_summed(_bases(seed=8)), res["int8_no_ladder"][0]):
            np.testing.assert_array_equal(g, w / WORLD)


@pytest.mark.parametrize("inner", INNERS)
def test_ef_exact_codec_leaves_zero_residual(eight_ranks, inner):
    for res in eight_ranks:
        out, residuals, _ = res[("ef_grid", inner)]
        for b, o in zip(_grid(), out):
            np.testing.assert_array_equal(o, b)
        assert max(float(np.max(np.abs(r))) for r in residuals) < 1e-6


# --------------------------------------------------- against the JAX side


def _close_to_jax(got, want, magnitude):
    """The JAX side's XLA program contracts products into fused
    multiply-adds, the port rounds each product: the two agree to a few
    ulp of the bucket's magnitude (rtol 1e-6, atol 1e-6 x magnitude)."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * magnitude)


def _close_but_for_ties(got, want, magnitude, step):
    """The two sides' intra-host sums (and after feedback their
    residuals) differ by a few ulp, and a quotient that lands within
    them of a rounding tie
    rounds one way on one side and the other on the other: such an
    element is off by one quantization ``step``, and its residual takes
    the difference back the next step. At most 2% of the elements may
    be off that way; the rest agree as :func:`_close_to_jax`. ``got`` and
    ``want`` are lists of arrays, counted together."""
    got = np.concatenate([np.ravel(g) for g in got])
    want = np.concatenate([np.ravel(np.asarray(w)) for w in want])
    off = np.abs(got - want) > 1e-6 * magnitude + 1e-6 * np.abs(want)
    assert off.mean() <= 0.02, (off.sum(), off.size)
    assert float(np.abs(got - want).max(initial=0)) <= step * 1.001


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("codec", CODECS)
def test_quantized_random_data_equals_jax_and_tracks_flat(hvd, eight_ranks,
                                                          inner, codec):
    """Gaussian data against the JAX package; the JAX tests' integer
    data (where a quotient often lands on a rounding tie that a fused
    multiply-add moves by an ulp) within 0.05 x scale of flat."""
    from horovod_tpu.jax.compression import Compression

    for average in (False, True):
        want = _jax_reduce(hvd, _normal(), inner=inner,
                           compression=getattr(Compression, codec),
                           average=average)
        mag = max(float(np.abs(w).max()) for w in want)
        for res in eight_ranks:
            got = res[("normal", inner, codec)][average][0]
            for w, g in zip(want, got):
                _close_to_jax(g, w, mag)
            got = res[("random", inner, codec)][average][0]
            flat = res["flat_random"][average][0]
            for g, f in zip(got, flat):
                scale = max(1.0, float(np.max(np.abs(f))))
                assert float(np.max(np.abs(g - f))) < 0.05 * scale


@pytest.mark.parametrize("inner", INNERS)
def test_error_feedback_converges_and_residuals_equal_jax(hvd, eight_ranks,
                                                          inner):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.jax.compression import Compression
    from horovod_tpu.jax.fusion import ef_residual_specs, fused_reduce

    bases = _ef_bases()
    true = [sum(r + 1 for r in range(WORLD)) / WORLD * b for b in bases]
    leaves = [jax.ShapeDtypeStruct(b.shape, jnp.float32) for b in bases]
    res0 = tuple(jnp.zeros(s.shape, s.dtype)
                 for s in ef_residual_specs(leaves, _THRESHOLD, WORLD,
                                            inner))
    spec = tuple(P("hvd") for _ in res0)

    def step(r):
        ts = [jnp.asarray(b) * (hvd.rank() + 1).astype(jnp.float32)
              for b in bases]
        out, new = fused_reduce(ts, average=True,
                                compression=Compression.int8,
                                fusion_threshold=_THRESHOLD,
                                hierarchical="on", residuals=r)
        return tuple(out), new

    with _inner_size(inner):
        run = hvd.spmd_fn(step, in_specs=(spec,),
                          out_specs=((P(),) * len(bases), spec))
        jres, jouts = res0, []
        for _ in range(EF_STEPS):
            out, jres = run(jres)
            jouts.append([np.asarray(o) for o in out])
            jfirst = jres if len(jouts) == 1 else jfirst
    # The largest shard sum, and its int8 step (absmax / 127).
    mag = max(float(np.abs(t).max()) for t in true) * WORLD
    step = mag / 127
    for outs in (eight_ranks[0][("ef", inner)][0], jouts):
        acc = [np.zeros_like(b) for b in bases]
        errs = []
        for it, o in enumerate(outs):
            for a, x in zip(acc, o):
                a += x
            errs.append(max(float(np.max(np.abs(a / (it + 1) - t)))
                            for a, t in zip(acc, true)))
        assert errs[-1] < 0.35 * errs[0], errs
    # The first step from zero residuals: outputs and every rank's
    # residuals are the JAX ones but for rounding ties. Later steps feed
    # back what each side's ties left, so the two trajectories part by
    # up to a step where a tie went differently; each must converge on
    # its own (above), and the residuals stay within a step.
    _close_but_for_ties(eight_ranks[0][("ef", inner)][0][0], jouts[0],
                        mag, step / WORLD)
    for rank, res in enumerate(eight_ranks):
        outs, final, first = res[("ef", inner)]
        assert len(first) == len(final) == len(jfirst)
        slices = []
        for r, j in zip(first, jfirst):
            j = np.asarray(j)
            n = j.shape[0] // WORLD
            assert r.shape == (n,)
            slices.append(j[rank * n:(rank + 1) * n])
        _close_but_for_ties(first, slices, mag, step)
        assert max(float(np.abs(r).max()) for r in final) <= step


@pytest.mark.parametrize("run", LM_RUNS, ids=lambda r: f"{r[1]}_inner{r[0]}")
@pytest.mark.parametrize("overlap", ["off", "on"])
def test_lm_distributed_adam_equals_jax_optimizer(hvd, eight_ranks, run,
                                                  overlap):
    """Every rank's parameters and residuals after each step equal the
    JAX ``DistributedOptimizer(optax.adam)`` on the same per-rank
    gradients (atol 1e-6: torch takes Adam's bias correction in float64,
    optax in float32, about 1e-7 of an update of 1e-2)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.jax.compression import Compression
    from horovod_tpu.jax.optimizer import (DistributedOptimizer,
                                           ef_state_partition_specs)

    inner, codec = run
    runs = [res[("lm", inner, codec, overlap)] for res in eight_ranks]
    assert all(r["inner"] == inner for r in runs)
    assert runs[0]["hooked"] == (overlap == "on")
    opt = DistributedOptimizer(optax.adam(LM_LR),
                               compression=getattr(Compression, codec),
                               hierarchical="on",
                               fusion_threshold=LM_THRESHOLD)
    params = [jnp.asarray(p) for p in runs[0]["init"]]
    with _inner_size(inner):
        state = opt.init(params)
        spec = ef_state_partition_specs(state)

        def step(params, state, grads):
            updates, state = opt.update([g[0] for g in grads], state,
                                        params)
            return optax.apply_updates(params, updates), state

        fn = hvd.spmd_fn(step, in_specs=(P(), spec, P("hvd")),
                         out_specs=(P(), spec))
        jres = jax.tree_util.tree_leaves(state)
        for r in runs:
            assert [x.shape for x in r["res0"]] == [
                (x.shape[0] // WORLD,) for x in jres if x.ndim == 1
                and x.shape[0] % WORLD == 0][:len(r["res0"])]
        for s in range(LM_STEPS):
            grads = [jnp.stack([jnp.asarray(r["steps"][s]["grads"][i])
                                for r in runs])
                     for i in range(len(params))]
            params, state = fn(params, state, grads)
            residuals = state[0].residuals
            for rank, r in enumerate(runs):
                got = r["steps"][s]
                for g, w in zip(got["params"], params):
                    np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                               atol=1e-6)
                assert len(got["residuals"]) == len(residuals)
                for g, w in zip(got["residuals"], residuals):
                    w = np.asarray(w)
                    n = w.shape[0] // WORLD
                    np.testing.assert_allclose(
                        g, w[rank * n:(rank + 1) * n], rtol=1e-5,
                        atol=1e-6)
    for r in runs:
        assert any(float(np.abs(x).max()) > 0
                   for x in r["steps"][-1]["residuals"])
        assert all(float(np.abs(x).max()) == 0 for x in r["res0"])
        for a, b in zip(r["state_residuals"], r["steps"][-1]["residuals"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["loaded"], r["state_residuals"]):
            np.testing.assert_array_equal(a, b)
        assert "ROADMAP.md Queue 3" in r["window"]
    # Every replica holds the same parameters.
    for r in runs[1:]:
        for a, b in zip(r["steps"][-1]["params"],
                        runs[0]["steps"][-1]["params"]):
            np.testing.assert_array_equal(a, b)


def test_hooks_and_post_backward_issue_give_the_same_bits(eight_ranks):
    for res in eight_ranks:
        for inner, codec in LM_RUNS:
            off = res[("lm", inner, codec, "off")]["steps"][-1]
            on = res[("lm", inner, codec, "on")]["steps"][-1]
            for a, b in zip(off["params"] + off["residuals"],
                            on["params"] + on["residuals"]):
                np.testing.assert_array_equal(a, b)


def test_bench_record_stamps_the_jax_wire(hvd, eight_ranks):
    import types

    import bench as jbench
    from horovod_tpu.common import state

    from horovod_tpu_torch.models.transformer import TransformerLM

    shapes = [tuple(p.shape) for p in TransformerLM(
        vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
        max_len=2048, dtype=torch.float32, device="cpu").parameters()]
    cfg = state.global_state().config
    saved = cfg.fusion_threshold
    cfg.fusion_threshold = BENCH_THRESHOLD
    try:
        with _inner_size(4):
            for codec in ("none", "int8"):
                args = types.SimpleNamespace(hierarchical="on", zero=False,
                                             compression=codec)
                want = jbench.wire_stamp(
                    args, {"params": [np.zeros(s, np.float32)
                                      for s in shapes]},
                    lambda *a, **k: None)
                for res in eight_ranks:
                    rec = res["bench"][codec]
                    assert rec["hierarchical"] == want["hierarchical"]
                    assert rec["wire"] == want["wire"]
                    assert rec["replicas_in_sync"]
                    assert np.isfinite(rec["loss"])
                assert want["wire"]["dtype"] == (
                    "int8" if codec == "int8" else "float32")
    finally:
        cfg.fusion_threshold = saved


# ----------------------------------------------------- the loud failures


@pytest.mark.parametrize("inner", INNERS)
def test_residual_structure_shape_and_mode_fail_loudly(eight_ranks, inner):
    for res in eight_ranks:
        errors = res[("errors", inner)]
        assert errors["count"][0] == "InvalidArgumentError"
        assert "ef_residual_specs" in errors["count"][1]
        assert errors["shape"][0] == "InvalidArgumentError"
        assert "rank-local" in errors["shape"][1]
        assert errors["mode"][0] == "InvalidArgumentError"
        assert "hierarchical must be one of" in errors["mode"][1]


def test_residuals_with_flat_resolution_fail_loudly(eight_ranks):
    for res in eight_ranks:
        name, msg = res["flat_resolution"]
        assert name == "InvalidArgumentError" and "resolves to FLAT" in msg


@pytest.mark.parametrize("inner", INNERS)
def test_residuals_pass_through_when_disengaged(eight_ranks, inner):
    for res in eight_ranks:
        for r in res[("passthrough", inner)]:
            np.testing.assert_array_equal(r, np.full((7,), 3.25,
                                                     np.float32))


# ------------------------------------------------------- the rest


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("overlap", ["off", "on"])
def test_optimizer_on_the_ladder_equals_flat_bitexact(eight_ranks, inner,
                                                      overlap):
    for res in eight_ranks:
        flat = res[("linear_flat", overlap)]
        got = res[("linear", inner, overlap)]
        assert got["hooked"] == flat["hooked"] == (overlap == "on")
        for sf, sg in zip(flat["params"], got["params"]):
            for f, g in zip(sf, sg):
                np.testing.assert_array_equal(g, f)
        want = [-w / WORLD for w in _summed(_bases(seed=3))]
        for f, w in zip(flat["params"][0], want):
            np.testing.assert_array_equal(f, w)


@pytest.mark.parametrize("inner", INNERS)
def test_per_tensor_ladder_and_allgather_equal_flat(eight_ranks, inner):
    for res in eight_ranks:
        total, average, in_axis = res[("allreduce", inner)]
        np.testing.assert_array_equal(total, res["allreduce_flat"])
        np.testing.assert_array_equal(in_axis, res["allreduce_flat"])
        np.testing.assert_array_equal(average,
                                      res["allreduce_flat"] / WORLD)
        np.testing.assert_array_equal(res[("allgather", inner)],
                                      res["allgather_flat"])
    np.testing.assert_array_equal(
        eight_ranks[0]["allgather_flat"],
        np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * r
                        for r in range(WORLD)]))


def test_hierarchical_allreduce_over_a_device_mesh(eight_ranks):
    for rank, res in enumerate(eight_ranks):
        grid, got, ici = res["device_mesh"]
        assert grid == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert ici == [r for r in range(WORLD) if r // 4 == rank // 4]
        np.testing.assert_array_equal(got, res["allreduce_flat"] / WORLD)
