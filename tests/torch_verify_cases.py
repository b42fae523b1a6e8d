"""Inline cases of the port's schedule verifier, run in a process of
their own (each simulated rank makes and destroys a ``fake`` process
group, which must not meet a test worker's own groups):

    python tests/torch_verify_cases.py  ->  one JSON object, the last
                                            line of stdout

Each case is a small program in a world of 2 or 4 simulated ranks, one
that breaks a rule and one that keeps it; the object maps the case's
name to its verified findings. It also carries ``optimizer.fused``'s
summary and the CLI's exit code over a registry holding a failing
program.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from horovod_tpu_torch.verify import (EquivalenceSpec, Program,  # noqa: E402
                                      ReconcileSpec, ShardingSpec, verify)
from horovod_tpu_torch.verify import registry  # noqa: E402


def _bind(config, fn):
    """``build`` running ``fn(lm)`` inside ``bind(lm)`` of a LogicalMesh
    of ``config``."""

    def build():
        from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

        lm = LogicalMesh.from_config(config)
        run = fn(lm)

        def bound():
            with bind(lm):
                run()

        return bound

    return build


def _skip_on(rank):
    def build():
        x = torch.ones(4)
        return lambda: None if dist.get_rank() == rank else \
            dist.all_reduce(x)

    return build


def _unnamed_group(named):
    def build():
        g = dist.new_group([0, 1])      # every rank makes it
        x = torch.ones(4)

        def run():
            if dist.get_rank() in (0, 1):
                dist.all_reduce(x, group=None if named else g)

        return run

    return build


def _shape_on(rank, size):
    def build():
        n = size if dist.get_rank() == rank else 4
        x = torch.ones(n)
        return lambda: dist.all_reduce(x)

    return build


def _splits(paired):
    def build():
        out_splits = [2, 2] if paired else [1, 3]
        return lambda: dist.all_to_all_single(
            torch.empty(4), torch.ones(4), out_splits, [2, 2])

    return build


def _per_tensor_exchange():
    def build():
        model = registry._mnist()
        grads = [torch.ones_like(p) for p in model.parameters()]
        return lambda: [dist.all_reduce(g) for g in grads]

    return build


def _flat_fused():
    def build():
        from horovod_tpu_torch.distributed.fusion import fused_reduce

        grads = [torch.ones_like(p) for p in registry._mnist().parameters()]

        def run():
            return fused_reduce(grads,
                                fusion_threshold=registry.OPT_THRESHOLD)

        run()   # the first call also gathers the hosts' names
        return run

    return build


def _job_group_in_mesh(lm):
    x = torch.ones(4)
    return lambda: dist.all_reduce(x)


def _dp_psum(n):
    def body(lm):
        from horovod_tpu_torch.parallel._collectives import psum

        x = torch.ones(n)
        return lambda: psum(x, "dp")

    return body


def _shardings(right):
    def make():
        from horovod_tpu_torch.parallel.logical import LogicalMesh

        lm = LogicalMesh.from_config("dp=2,tp=2")
        declared = (None, "tp") if right else ("tp", None)
        return ShardingSpec(lm, (("w_up", ("embed", "mlp"), declared),))

    return make


def _equivalence(n):
    return lambda: [EquivalenceSpec(
        lambda: (_bind("dp=2", _dp_psum(n)), 2), ("dp",), name="dp")]


def _mnist_spec(**kw):
    return lambda: ReconcileSpec(registry.mnist_param_leaves(),
                                 registry.OPT_THRESHOLD, 4, **kw)


CASES = {
    "hvv101_fires": Program("hvv101_fires", "case", _skip_on(1), 4),
    "hvv101_silent": Program("hvv101_silent", "case", _skip_on(-1), 4),
    "hvv102_fires": Program("hvv102_fires", "case", _unnamed_group(False),
                            4),
    "hvv102_silent": Program("hvv102_silent", "case", _unnamed_group(True),
                             2),
    "hvv103_fires": Program("hvv103_fires", "case", _shape_on(1, 8), 4),
    "hvv103_silent": Program("hvv103_silent", "case", _shape_on(1, 4), 4),
    "hvv103_splits_fire": Program("hvv103_splits_fire", "case",
                                  _splits(False), 2),
    "hvv103_splits_silent": Program("hvv103_splits_silent", "case",
                                    _splits(True), 2),
    "hvv105_fires": Program("hvv105_fires", "case", _per_tensor_exchange(),
                            4, reconcile=_mnist_spec()),
    "hvv105_ladder_fires": Program("hvv105_ladder_fires", "case",
                                   _flat_fused(), 4,
                                   reconcile=_mnist_spec(hier_inner=2)),
    "hvv105_silent": Program("hvv105_silent", "case", _flat_fused(), 4,
                             reconcile=_mnist_spec()),
    "hvv201_fires": Program("hvv201_fires", "case",
                            _bind("dp=2,tp=2", _dp_psum(4)), 4,
                            shardings=_shardings(False)),
    "hvv201_silent": Program("hvv201_silent", "case",
                             _bind("dp=2,tp=2", _dp_psum(4)), 4,
                             shardings=_shardings(True)),
    "hvv202_fires": Program(
        "hvv202_fires", "case", _bind("dp=2,tp=2", _job_group_in_mesh), 4,
        logical_mesh=lambda: _mesh("dp=2,tp=2")),
    "hvv202_silent": Program(
        "hvv202_silent", "case", _bind("dp=2,tp=2", _dp_psum(4)), 4,
        logical_mesh=lambda: _mesh("dp=2,tp=2")),
    "hvv203_fires": Program("hvv203_fires", "case",
                            _bind("dp=2,tp=2", _dp_psum(4)), 4,
                            equivalence=_equivalence(8)),
    "hvv203_silent": Program("hvv203_silent", "case",
                             _bind("dp=2,tp=2", _dp_psum(4)), 4,
                             equivalence=_equivalence(4)),
    "suppressed": Program("suppressed", "case", _skip_on(1), 4,
                          suppress={"HVV101": "a case that skips on "
                                              "purpose"}),
}


def _mesh(config):
    from horovod_tpu_torch.parallel.logical import LogicalMesh

    return LogicalMesh.from_config(config)


def main():
    import warnings

    warnings.filterwarnings("ignore", category=FutureWarning)
    out = {}
    for name, prog in CASES.items():
        res = verify(prog)
        out[name] = {"active": [f.rule for f in res.active],
                     "suppressed": [f.rule for f in res.suppressed],
                     "messages": [f.format() for f in res.findings],
                     "summary": res.summary}
    fused = verify(registry.programs(names=["optimizer.fused"])[0])
    out["optimizer.fused"] = {"summary": fused.summary,
                              "active": [f.rule for f in fused.active],
                              "kinds": [op.kind for op in fused.schedule],
                              "axes": [op.axis for op in fused.schedule]}
    from horovod_tpu_torch.verify import __main__ as cli

    failing = CASES["hvv101_fires"]
    registry.REGISTRY.append(failing)
    out["cli_failing_rc"] = cli.main(["--program", failing.name])
    registry.REGISTRY.append(CASES["suppressed"])
    out["cli_suppressed_rc"] = cli.main(["--program", "suppressed",
                                         "--show-suppressed"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
