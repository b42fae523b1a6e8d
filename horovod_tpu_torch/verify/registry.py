"""The verifier's program registry: the port's real code paths, run in a
simulated world at small CPU sizes (the schedule's structure does not
depend on the sizes). The names are the JAX registry's
(``tools/hvdverify/registry.py``) where the port has the counterpart.
Groups:

* ``optimizer``: ``DistributedOptimizer`` on the MNIST model in its
  three emission modes (``fused``: the buckets from ``step()``;
  ``overlap``: from the gradient hooks; ``scatter``: reduce-scatter and
  all-gather), each HVV105-reconciled with ``plan_buckets``;
* ``dp``: the hierarchical exchange in both inter-host shapes (the
  2-host ladder under overlap, and the int8 wire at 4 hosts, whose
  exchange is two-stage), HVV105-reconciled leg by leg;
* ``parallel``: the ``hvd.*`` collective surface under ``spmd_run``,
  and the five sharding modules (tp, pipeline, ulysses, ring attention,
  MoE) with their backward passes;
* ``composed``: the LogicalMesh stacks dp x tp, dp x sp (Ulysses) and
  tp x pp, each with HVV201 (its partition specs), HVV202 (its axis
  vocabulary) and HVV203 (op-identical to its per-module references);
* ``elastic``: ``run_elastic``'s windowed loop, two windows of four
  steps over a fused gradient exchange;
* ``serve``: the tensor-parallel engine (``dp=1,tp=4``): a controller
  and three followers through mixed prefill and decode steps
  (``serve.step_tp``), and a decode-pool replica admitting a prefilled
  request's pages and decoding it (``serve.step_decode_pool_tp``). The
  controller's and the followers' broadcasts must match (HVV103).

Every program runs at ``WORLD`` simulated ranks, except those whose mesh
is a 4-way one (the JAX registry's sub-meshes of its 8 devices) and the
serving engine, whose world is its mesh. The single-device serving
programs of the JAX registry (``serve.step``, ``serve.step_paged``, the
speculative and the prefill-pool steps) issue no collective in the port,
so they are not registered. HVV104 (donation) has no counterpart.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel.logical import DATA_AXIS
from horovod_tpu_torch.verify.core import Program
from horovod_tpu_torch.verify.rules import (EquivalenceSpec, ReconcileSpec,
                                            ShardingSpec)

#: Ranks of the simulated world (the JAX registry's 8 devices).
WORLD = 8
#: The fusion threshold of the optimizer and dp programs: a multi-bucket
#: plan on the MNIST model (the JAX registry's).
OPT_THRESHOLD = 64 * 1024


def _hvd():
    import horovod_tpu_torch.distributed as hvd

    return hvd


def _mnist():
    from horovod_tpu_torch.models.mnist import MNISTNet

    return MNISTNet(device="cpu")


def mnist_param_leaves() -> List[torch.Tensor]:
    """The MNIST model's parameters as ``meta`` tensors, in the order the
    optimizer plans them."""
    return [torch.empty(p.shape, dtype=p.dtype, device="meta")
            for p in _mnist().parameters()]


def _mnist_step(opt_kwargs: dict, config: Optional[dict] = None,
                compression=None):
    """``build`` of one MNIST training step through
    ``DistributedOptimizer`` (``opt_kwargs``), with the config knobs
    ``config`` set on this rank after ``hvd.init``."""

    def build():
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.distributed.compression import Compression
        from horovod_tpu_torch.parallel import mesh as _mesh

        hvd = _hvd()
        for k, v in (config or {}).items():
            setattr(basics.config(), k, v)
        inner = (config or {}).get("hierarchical_inner_size")
        if inner:
            _mesh.ladder_groups(hvd.size(), inner)   # made, not recorded
        model = _mnist()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            fusion_threshold=OPT_THRESHOLD,
            compression=compression or Compression.none, **opt_kwargs)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, 28, 28, 1, generator=gen)
        y = torch.randint(0, 10, (2,), generator=gen)

        def step():
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()

        return step

    return build


def _optimizer_mode(mode: str) -> Program:
    kwargs = {"fused": dict(overlap="off"), "overlap": dict(overlap="on"),
              "scatter": dict(overlap="on")}[mode]
    config = {"overlap_scatter_threshold": 0} if mode == "scatter" else {}
    return Program(
        f"optimizer.{mode}", "optimizer", _mnist_step(kwargs, config),
        WORLD, reconcile=lambda: ReconcileSpec(
            mnist_param_leaves(), OPT_THRESHOLD, WORLD))


def _dp_hier(name: str, inner: int, int8: bool) -> Program:
    from horovod_tpu_torch.distributed.compression import Compression

    return Program(
        name, "dp",
        _mnist_step(dict(overlap="on", hierarchical="on"),
                    {"hierarchical_inner_size": inner},
                    Compression.int8 if int8 else None),
        WORLD, reconcile=lambda: ReconcileSpec(
            mnist_param_leaves(), OPT_THRESHOLD, WORLD, hier_inner=inner,
            dcn_dtype="int8" if int8 else None))


# ------------------------------------------------------------- parallel


def _bound(config: str):
    from horovod_tpu_torch.parallel.logical import LogicalMesh

    return LogicalMesh.from_config(config)


def _coord(lm, axis: str) -> int:
    """This rank's index along ``axis`` of ``lm``'s rank grid."""
    where = np.argwhere(np.asarray(lm.ranks) == dist.get_rank())[0]
    return int(where[lm.axis_names.index(axis)])


def _local(x: torch.Tensor, spec, lm) -> torch.Tensor:
    """This rank's shard of ``x`` along ``spec`` (an axis name or None a
    dimension) on ``lm``'s grid."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = lm.axes[axis]
        size = x.shape[dim] // n
        x = x.narrow(dim, _coord(lm, axis) * size, size)
    return x.contiguous()


def _rand(*shape, seed: int = 0, grad: bool = False) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=gen)
    return t.requires_grad_(grad)


def _parallel_spmd():
    """The ``hvd.*`` collective surface under ``spmd_run``: allreduce,
    grouped_allreduce, allgather, alltoall, reducescatter, broadcast."""

    def build():
        from horovod_tpu_torch.parallel.spmd import P

        hvd = _hvd()
        n = hvd.size()

        def program(x, pair):
            a = hvd.allreduce(x, average=True)
            g = hvd.grouped_allreduce([x, 2.0 * x], average=False)
            cat = hvd.allgather(x)
            t = hvd.alltoall(x.repeat(n, 1))
            rs = hvd.reducescatter(x.repeat(n, 1), average=False)
            b = hvd.broadcast(pair, root_rank=0)
            return a + g[0] + g[1] + rs + t.mean() + b, cat.sum()

        x, pair = _rand(4, 8), _rand(4, 8, seed=1)
        return lambda: hvd.spmd_run(program, x, pair,
                                    in_specs=(P(), P()),
                                    out_specs=(P(), P()))

    return build


def _in_mesh(config: str, body):
    """``build`` running ``body(lm)``'s program inside ``bind(lm)``."""

    def build():
        from horovod_tpu_torch.parallel.logical import bind

        lm = _bound(config)
        fn = body(lm)

        def run():
            with bind(lm):
                fn()

        return run

    return build


def _tp_mlp_grads(lm, x, wu, bu, wd, bd, tp_ax: str):
    from horovod_tpu_torch.parallel.tp import tp_mlp

    ws = [_local(w, s, lm).requires_grad_() for w, s in
          ((wu, (None, tp_ax)), (bu, (tp_ax,)), (wd, (tp_ax, None)),
           (bd, ()))]

    def run():
        tp_mlp(x, *ws, axis=tp_ax).sum().backward()
        return ws[0].grad, ws[2].grad

    return run


_TP = dict(B=2, L=8, E=16, F=32)


def _parallel_tp(lm):
    B, L, E, F = (_TP[k] for k in "BLEF")
    return _tp_mlp_grads(lm, _rand(B, L, E), _rand(E, F, seed=1),
                         _rand(F, seed=2), _rand(F, E, seed=3),
                         _rand(E, seed=4), "tp")


def _parallel_pipeline(lm, D=8, M=6, Bm=2):
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply

    ws = _local(_rand(4, D, D, seed=1), ("pp",), lm).requires_grad_()
    x = _rand(M, Bm, D)
    return lambda: pipeline_apply(lambda w, a: torch.tanh(a @ w), ws, x,
                                  axis="pp").sum().backward()


def _sp_inputs(lm, B, L, H, D):
    return [_local(_rand(B, L, H, D, seed=s), (None, "sp"),
                   lm).requires_grad_() for s in range(3)]


def _parallel_ulysses(lm):
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = _sp_inputs(lm, 2, 32, 4, 8)
    return lambda: ulysses_attention(q, k, v, axis="sp",
                                     causal=True).sum().backward()


def _parallel_ring(lm):
    from horovod_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = _sp_inputs(lm, 2, 32, 2, 4)
    return lambda: ring_attention(q, k, v, axis="sp", causal=True,
                                  skip_dead_blocks=True).sum().backward()


def _parallel_moe(lm, T=64, D=8, experts=4):
    from horovod_tpu_torch.parallel.moe import moe_layer

    x = _local(_rand(T, D), ("ep",), lm).requires_grad_()
    gate = _rand(D, experts, seed=1).requires_grad_()
    ew = {"w": _local(_rand(experts, D, D, seed=2), ("ep",),
                      lm).requires_grad_()}
    return lambda: moe_layer(x, gate, lambda p, t: t @ p["w"], ew,
                             axis="ep",
                             capacity_factor=1.0).sum().backward()


# ------------------------------------------------------------- composed


def _dp_ref(shapes, config_axis: str = DATA_AXIS):
    """A reference that averages tensors of ``shapes`` over a data axis
    of 2 (the composed programs' dp leg, the JAX ``dp_ref``)."""

    def ref():
        def body(lm):
            from horovod_tpu_torch.parallel._collectives import psum

            ts = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
            # hvdlint: disable=HVD006 (the composed stacks' dp leg: a psum a tensor)
            return lambda: [psum(t, config_axis) / 2 for t in ts]

        return _in_mesh(f"{config_axis}=2", body), 2

    return ref


def _composed_dp_tp() -> Program:
    """dp=2 x tp=4: the Megatron MLP's gradients, then their average
    over the data axis."""
    B, L, E, F = 4, 8, 16, 32
    config = "dp=2,tp=4"

    def body(lm):
        from horovod_tpu_torch.parallel._collectives import psum

        dp_ax, tp_ax = lm.role_axis("data"), lm.role_axis("tensor")
        x = _local(_rand(B, L, E), lm.spec("batch"), lm)
        grads = _tp_mlp_grads(lm, x, _rand(E, F, seed=1), _rand(F, seed=2),
                              _rand(F, E, seed=3), _rand(E, seed=4), tp_ax)

        def run():
            gwu, gwd = grads()
            return psum(gwu, dp_ax) / 2, psum(gwd, dp_ax) / 2

        return run

    def shardings():
        lm = _bound(config)
        return ShardingSpec(lm, (
            ("x", ("batch",), lm.spec("batch")),
            ("w_up", ("embed", "mlp"), (None, lm.role_axis("tensor"))),
            ("b_up", ("mlp",), (lm.role_axis("tensor"),)),
            ("w_down", ("mlp", "embed"), (lm.role_axis("tensor"), None)),
            ("b_down", ("embed",), ())))

    def tp_ref():
        return _in_mesh("tp=4", lambda lm: _tp_mlp_grads(
            lm, _rand(B // 2, L, E), _rand(E, F, seed=1), _rand(F, seed=2),
            _rand(F, E, seed=3), _rand(E, seed=4), "tp")), 4

    return Program(
        "composed.dp_tp", "composed", _in_mesh(config, body), WORLD,
        shardings=shardings, logical_mesh=lambda: _bound(config),
        equivalence=lambda: [
            EquivalenceSpec(tp_ref, ("tp",), name="tp"),
            EquivalenceSpec(_dp_ref([(E, F // 4), (F // 4, E)]), ("dp",),
                            {"dp": DATA_AXIS}, name="dp")])


def _composed_dp_ulysses() -> Program:
    """dp=2 x sp=4: Ulysses attention with the batch over dp and the
    sequence over sp, then the loss averaged over dp."""
    B, L, H, D = 4, 32, 4, 8
    config = "dp=2,sp=4"

    def body(lm):
        from horovod_tpu_torch.parallel._collectives import psum
        from horovod_tpu_torch.parallel.ulysses import ulysses_attention

        dp_ax, sp_ax = lm.role_axis("data"), lm.role_axis("seq")
        q, k, v = (_local(_rand(B, L, H, D, seed=s),
                          lm.spec("batch", "seq"), lm) for s in range(3))
        return lambda: psum(ulysses_attention(
            q, k, v, axis=sp_ax, causal=True).sum(), dp_ax) / 2

    def shardings():
        lm = _bound(config)
        return ShardingSpec(lm, tuple(
            (name, ("batch", "seq"), lm.spec("batch", "seq"))
            for name in "qkv") + (("loss", (), ()),))

    def sp_ref():
        from horovod_tpu_torch.parallel.ulysses import ulysses_attention

        def body_ref(lm):
            q, k, v = (_local(_rand(B // 2, L, H, D, seed=s),
                              (None, "sp"), lm) for s in range(3))
            return lambda: ulysses_attention(q, k, v, axis="sp",
                                             causal=True)

        return _in_mesh("sp=4", body_ref), 4

    return Program(
        "composed.dp_ulysses", "composed", _in_mesh(config, body), WORLD,
        shardings=shardings, logical_mesh=lambda: _bound(config),
        equivalence=lambda: [
            EquivalenceSpec(sp_ref, ("sp",), name="sp"),
            EquivalenceSpec(_dp_ref([()]), ("dp",), {"dp": DATA_AXIS},
                            name="dp")])


def _composed_tp_pp() -> Program:
    """tp=2 x pp=4: a pipeline whose every stage is a Megatron MLP: the
    tensor axis's all-reduce inside each tick, the stage rotation
    around it."""
    STAGES, M, Bm, E, F = 4, 6, 2, 8, 16
    config = "tp=2,pp=4"

    def stage(tp_ax):
        from horovod_tpu_torch.parallel.tp import (column_parallel,
                                                   row_parallel)

        def fn(w, a):
            h = torch.nn.functional.gelu(column_parallel(a, w["wu"],
                                                         axis=tp_ax))
            return row_parallel(h, w["wd"], axis=tp_ax)

        return fn

    def body(lm):
        from horovod_tpu_torch.parallel.pipeline import pipeline_apply

        tp_ax, pp_ax = lm.role_axis("tensor"), lm.role_axis("stage")
        ws = {"wu": _local(_rand(STAGES, E, F, seed=1),
                           lm.spec("stage", "embed", "mlp"), lm),
              "wd": _local(_rand(STAGES, F, E, seed=2),
                           lm.spec("stage", "mlp", "embed"), lm)}
        x = _rand(M, Bm, E)
        return lambda: pipeline_apply(stage(tp_ax), ws, x, axis=pp_ax)

    def shardings():
        lm = _bound(config)
        tp_ax, pp_ax = lm.role_axis("tensor"), lm.role_axis("stage")
        return ShardingSpec(lm, (
            ("wu", ("stage", "embed", "mlp"), (pp_ax, None, tp_ax)),
            ("wd", ("stage", "mlp", "embed"), (pp_ax, tp_ax, None)),
            ("x", (), ())))

    def pp_ref():
        return _in_mesh("pp=4", lambda lm: _pipeline_forward(
            lm, STAGES, M, Bm, E)), 4

    def tp_ref():
        def body_ref(lm):
            w = {"wu": _local(_rand(E, F, seed=1), (None, "tp"), lm),
                 "wd": _local(_rand(F, E, seed=2), ("tp", None), lm)}
            a = _rand(Bm, E)
            fn = stage("tp")

            def run():
                acc = a
                for _ in range(M + STAGES - 1):
                    acc = fn(w, acc)
                return acc

            return run

        return _in_mesh("tp=2", body_ref), 2

    return Program(
        "composed.tp_pp", "composed", _in_mesh(config, body), WORLD,
        shardings=shardings, logical_mesh=lambda: _bound(config),
        equivalence=lambda: [EquivalenceSpec(pp_ref, ("pp",), name="pp"),
                             EquivalenceSpec(tp_ref, ("tp",), name="tp")])


def _pipeline_forward(lm, stages, M, Bm, E):
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply

    ws = _local(_rand(stages, E, E, seed=1), ("pp",), lm)
    x = _rand(M, Bm, E)
    return lambda: pipeline_apply(lambda w, a: torch.tanh(a @ w), ws, x,
                                  axis="pp")


# -------------------------------------------------------------- elastic


def _elastic_windowed_loop():
    """``run_elastic`` over two windows of four steps of a linear model
    whose gradients go through one fused exchange a step."""

    def build():
        from horovod_tpu_torch.elastic.loop import run_elastic

        hvd = _hvd()
        rank = hvd.rank()
        state = {"w": _rand(16, 4), "b": torch.zeros(4)}

        def step_fn(s, batch):
            w = s["w"].detach().requires_grad_()
            b = s["b"].detach().requires_grad_()
            loss = ((batch["x"] @ w + b - batch["y"]) ** 2).mean()
            gw, gb = torch.autograd.grad(loss, (w, b))
            gw, gb = hvd.grouped_allreduce([gw, gb], average=True)
            return ({"w": s["w"] - 0.1 * gw, "b": s["b"] - 0.1 * gb},
                    {"loss": loss.detach()})

        def batch_for(step):
            return {"x": _rand(8, 16, seed=1000 * rank + step),
                    "y": _rand(8, 4, seed=1000 * rank + step + 500)}

        return lambda: run_elastic(step_fn, state, batch_for, 8,
                                   steps_per_dispatch=4, world_size=WORLD,
                                   rank=rank, final_snapshot=False)

    return build


# ---------------------------------------------------------------- serve


_SERVE_TP = 4
_SERVE_CFG = dict(page_size=8, num_pages=40, decode_slots=2,
                  prefill_chunk=4, attention="paged")


def _serve_params():
    from horovod_tpu_torch.models import parallel_lm as plm

    return plm.init_lm_params(0, 64, 64, 2, 4, 4, 32, device="cpu")


def _prompt(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, n)


def _serve_step_tp():
    """A controller and its followers through a mixed prefill and decode
    run on a ``dp=1,tp=4`` engine."""

    def build():
        from horovod_tpu_torch.parallel.logical import bind
        from horovod_tpu_torch.serve import ServeConfig, ServeEngine

        eng = ServeEngine(_serve_params(), ServeConfig(
            mesh=f"dp=1,tp={_SERVE_TP}", **_SERVE_CFG), device="cpu",
            capture=False)

        def run():
            with bind(eng.logical_mesh):
                if eng.is_controller:
                    for i, (lp, n) in enumerate(((5, 6), (9, 4), (3, 5))):
                        eng.submit(_prompt(i, lp), n)
                        eng.step()
                    eng.run()
                    eng.close()
                else:
                    eng.follow()

        return run

    return build


def _serve_step_decode_pool_tp():
    """A decode-pool replica on ``dp=1,tp=4``: a request prefilled by a
    single-card engine arrives as a page blob, is admitted (the pages
    broadcast to every rank's heads) and decoded to the end."""

    def build():
        from horovod_tpu_torch.parallel.logical import bind
        from horovod_tpu_torch.serve import ServeConfig, ServeEngine
        from horovod_tpu_torch.serve.scheduler import make_request

        params = _serve_params()
        prefill = ServeEngine(params, ServeConfig(**_SERVE_CFG),
                              device="cpu", capture=False)
        src = prefill.submit(_prompt(7, 13), 6)
        src.prefill_only = True
        while not prefill.handoff:
            prefill.step()
        blob = prefill.export_handoff(src.rid)
        eng = ServeEngine(params, ServeConfig(
            mesh=f"dp=1,tp={_SERVE_TP}", **_SERVE_CFG), device="cpu",
            capture=False)

        def run():
            with bind(eng.logical_mesh):
                if eng.is_controller:
                    req = make_request(eng.config, eng.clock, src.prompt,
                                       src.max_new_tokens)
                    req.generated = [src.output[0]]
                    req.output = list(req.generated)
                    eng.admit_prefilled(req, blob)
                    eng.run()
                    eng.close()
                else:
                    eng.follow()

        return run

    return build


def _make_registry() -> List[Program]:
    progs = [_optimizer_mode(m) for m in ("fused", "overlap", "scatter")]
    progs += [_dp_hier("dp.hier_overlap", 4, False),
              _dp_hier("dp.hier_int8", 2, True)]
    progs.append(Program("parallel.spmd", "parallel", _parallel_spmd(),
                         WORLD))
    for name, config, body in (
            ("tp", "tp=4", _parallel_tp),
            ("pipeline", "pp=4", _parallel_pipeline),
            ("ulysses", "sp=4", _parallel_ulysses),
            ("ring_attention", "sp=4", _parallel_ring),
            ("moe", "ep=4", _parallel_moe)):
        progs.append(Program(f"parallel.{name}", "parallel",
                             _in_mesh(config, body), 4))
    progs += [_composed_dp_tp(), _composed_dp_ulysses(), _composed_tp_pp()]
    progs.append(Program("elastic.windowed_loop", "elastic",
                         _elastic_windowed_loop(), WORLD))
    progs.append(Program("serve.step_tp", "serve", _serve_step_tp(),
                         _SERVE_TP))
    progs.append(Program("serve.step_decode_pool_tp", "serve",
                         _serve_step_decode_pool_tp(), _SERVE_TP))
    return progs


REGISTRY: List[Program] = _make_registry()

#: Every group of the registry, in the JAX registry's order.
FAST_GROUPS = ("optimizer", "dp", "parallel", "composed", "elastic",
               "serve")


def programs(groups=None, names=None) -> List[Program]:
    """The registry entries of ``groups`` and ``names`` (every entry when
    both are None); an unknown name raises ``KeyError``."""
    known = {p.name for p in REGISTRY}
    unknown = [n for n in (names or ()) if n not in known]
    unknown += [g for g in (groups or ()) if g not in FAST_GROUPS]
    if unknown:
        raise KeyError(f"unknown program(s) or group(s): {unknown}")
    if not groups and not names:
        return list(REGISTRY)
    return [p for p in REGISTRY
            if p.group in (groups or ()) or p.name in (names or ())]
