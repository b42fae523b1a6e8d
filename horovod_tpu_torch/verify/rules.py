"""The port's HVV rules: checks over the recorded schedules of the ranks
of a simulated world.

The rules of the JAX package's verifier (``tools/hvdverify``) that mean
something for eager torch, with their semantics:

* **HVV101**: an op issued on some ranks of its group and not on the
  others (the peers wait forever);
* **HVV102**: a collective on a group that neither the job's group nor
  the bound mesh names (:func:`~horovod_tpu_torch.verify.schedule.
  group_names`);
* **HVV103**: ranks that issue the same position of a group's schedule
  with a different kind, dtype, shape, root or group (the coordinator's
  runtime mismatch checks, decided over the recording);
* **HVV105**: the fused gradient exchange's bytes reconcile exactly with
  ``distributed/fusion.py::plan_buckets`` (flat all-reduce, the scatter
  form's reduce-scatter and all-gather, or the hierarchical ladder leg by
  leg, ``hier_bucket_layout``, quantized inter-host legs included);
* **HVV201**: declared partition specs reconcile with
  ``parallel/logical.py``'s axis-rules table;
* **HVV202**: every collective's axis is in the bound LogicalMesh's
  vocabulary;
* **HVV203**: a composed stack's schedule is op-identical to its
  per-module references.

HVV104 (a donated buffer read after the donating call) has no
counterpart: torch has no buffer donation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from horovod_tpu_torch.parallel.logical import (DATA_AXIS, DCN_AXIS,
                                                ICI_AXIS)
from horovod_tpu_torch.verify.schedule import CollectiveOp

RULES: Dict[str, str] = {
    "HVV101": "collective issued on some ranks of its group and not on "
              "the others -> the peers wait forever (deadlock)",
    "HVV102": "collective on a process group that neither the job's "
              "group nor the bound mesh names",
    "HVV103": "ranks issue the same position of a group's schedule with "
              "a different kind, dtype, shape, root or group",
    "HVV105": "recorded wire bytes do not reconcile with the declared "
              "fusion bucket plan (distributed/fusion.py::plan_buckets; "
              "flat all-reduce, scatter rs+ag, or the hierarchical "
              "rs->exchange->ag ladder incl. quantized inter-host legs)",
    "HVV201": "declared partition specs do not reconcile with the "
              "LogicalMesh axis-rules table",
    "HVV202": "collective runs over a mesh axis the bound LogicalMesh "
              "does not define",
    "HVV203": "composed-stack schedule is not op-identical to the "
              "per-module reference (kind, axis, shapes, dtypes, in "
              "issue order)",
}

#: The frames that issue the fused gradient exchange (HVV105's tag).
_EXCHANGE_FRAME = "horovod_tpu_torch/distributed/fusion.py:"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding of a verified program."""

    program: str
    rule: str
    message: str
    source: str = ""
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tag = (f" (suppressed: {self.suppress_reason})"
               if self.suppressed else "")
        src = f" @ {self.source}" if self.source else ""
        return f"{self.program}: {self.rule} {self.message}{src}{tag}"


# ------------------------------------------------------- HVV101 / HVV103


def check_ranks(program: str, schedules: Sequence[Sequence[CollectiveOp]]
                ) -> List[Finding]:
    """HVV101 and HVV103 over each group: the member ranks' sequences of
    ops on the group, position by position, up to the first divergence
    (after it the positions no longer pair)."""
    per: Dict[tuple, Dict[int, List[CollectiveOp]]] = {}
    for sched in schedules:
        for op in sched:
            per.setdefault(op.ranks, {}).setdefault(op.rank, []).append(op)
    findings: List[Finding] = []
    simulated = len(schedules)
    for ranks, by_rank in per.items():
        members = [r for r in ranks if r < simulated]
        longest = max(len(v) for v in by_rank.values())
        for i in range(longest):
            have = {r: by_rank[r][i] for r in members
                    if i < len(by_rank.get(r, []))}
            missing = [r for r in members if r not in have]
            first = next(iter(have.values()))
            if missing:
                findings.append(Finding(
                    program, "HVV101",
                    f"{first.describe()} is issued by rank(s) "
                    f"{sorted(have)} and not by rank(s) {missing} of its "
                    "group: the issuing ranks wait for peers that never "
                    "come", first.source))
                break
            sigs = {r: op.signature() for r, op in have.items()}
            if len(set(sigs.values())) > 1:
                r0, r1 = next((a, b) for a in sigs for b in sigs
                              if sigs[a] != sigs[b])
                findings.append(Finding(
                    program, "HVV103",
                    f"position {i} of the group's schedule differs "
                    f"across ranks: rank {r0} issues "
                    f"{have[r0].describe()}, rank {r1} issues "
                    f"{have[r1].describe()}", have[r1].source))
                break
            unpaired = _unpaired_splits(ranks, have)
            if unpaired:
                findings.append(Finding(
                    program, "HVV103",
                    f"position {i} of the group's schedule: "
                    f"{first.describe()} has split sizes that do not "
                    f"pair: {unpaired}", first.source))
                break
    return findings


def _unpaired_splits(ranks, have) -> str:
    """For an all-to-all with split sizes: rank ``a`` must send peer
    ``b`` what ``b`` expects from ``a``. Returns the first pair that does
    not, described, or ``""``."""
    for a, op_a in have.items():
        if op_a.kind != "alltoall" or len(op_a.params) != 2:
            return ""
        out_a, in_a = op_a.params
        for b, op_b in have.items():
            if len(op_b.params) != 2:
                continue
            out_b = op_b.params[0]
            ia, ib = ranks.index(a), ranks.index(b)
            if in_a[ib] != out_b[ia]:
                return (f"rank {a} sends rank {b} {in_a[ib]} element(s), "
                        f"rank {b} expects {out_b[ia]}")
    return ""


# ---------------------------------------------------------------- HVV102


def check_groups(program: str, schedule: Sequence[CollectiveOp]
                 ) -> List[Finding]:
    """HVV102: every op's group is named (``op.axis`` is set)."""
    return [Finding(
        program, "HVV102",
        f"{op.describe()} runs over process group ranks {list(op.ranks)},"
        " which neither the job's group nor the bound mesh names: a "
        "group made outside the mesh (dist.new_group) that the axis "
        "rules cannot see", op.source)
        for op in schedule if op.axis is None]


# ---------------------------------------------------------------- HVV105


@dataclasses.dataclass
class ReconcileSpec:
    """What a program claims its fused gradient exchange moves:
    ``leaves`` (tensors, or anything with ``shape`` and a torch
    ``dtype``) planned at ``threshold`` over an axis of ``axis_size``
    ranks; ``hier_inner`` declares the hierarchical ladder and
    ``dcn_dtype`` (``"int8"``, ``"float8_e4m3fn"``) its quantized
    inter-host wire."""

    leaves: Sequence
    threshold: int
    axis_size: int
    axis: str = DATA_AXIS
    hier_inner: int = 0
    dcn_dtype: Optional[str] = None


def _pad_up(n: int, quantum: int) -> int:
    return (n + quantum - 1) // quantum * quantum


def check_reconciliation(program: str, schedule: Sequence[CollectiveOp],
                         spec: ReconcileSpec) -> List[Finding]:
    """HVV105: the recorded exchange carries exactly the plan's bytes.

    The exchange's ops are those issued from ``distributed/fusion.py``
    over the data plane (the spec's axis, and the ladder's ``ici`` and
    ``dcn`` axes when it is declared). Per bucket of ``plan_buckets``:
    an all-reduce of the bucket's bytes; or the scatter form's
    reduce-scatter of the bucket padded to ``axis_size`` elements and
    its all-gather of the shard; or, declared, the ladder per
    ``hier_bucket_layout``: reduce-scatter of the padded bucket on
    ``ici``, the inter-host leg on ``dcn`` (an all-reduce of the shard;
    quantized: one all-gather of the shard's wire bytes plus its 4-byte
    scale, or at more than two hosts the all-to-all, the scale
    all-gather and the sub-shard's all-gather with its scale), then the
    all-gather of the shard on ``ici`` (float32 after a quantized leg).
    A ladder bucket that ran as one flat all-reduce, a missing leg,
    leftover exchange traffic, and a gradient-sized collective on the
    data plane outside the exchange are findings."""
    from horovod_tpu_torch.distributed.fusion import (hier_bucket_layout,
                                                      plan_buckets)

    plan = plan_buckets(list(spec.leaves), spec.threshold)
    plane = {spec.axis} | ({ICI_AXIS, DCN_AXIS} if spec.hier_inner
                           else set())
    exchange_kinds = ("allreduce", "reduce_scatter", "allgather",
                      "alltoall")
    on_plane = [op for op in schedule
                if op.kind in exchange_kinds and op.axis in plane]
    tagged = [op for op in on_plane
              if any(f.startswith(_EXCHANGE_FRAME) for f in op.stack)]
    findings: List[Finding] = []
    grad_sizes = {b.nbytes for b in plan}
    for leaf in spec.leaves:
        n = 1
        for d in leaf.shape:
            n *= int(d)
        grad_sizes.add(n * leaf.dtype.itemsize)
    pooled = {id(op) for op in tagged}
    for op in on_plane:
        if id(op) not in pooled and op.payload_bytes in grad_sizes:
            findings.append(Finding(
                program, "HVV105",
                f"{op.describe()} moves a gradient-sized payload on the "
                "data plane OUTSIDE the fused exchange: a per-tensor "
                "collective bypassing the bucket plan", op.source))
    pool = list(tagged)

    def take(kind: str, nbytes: int, axis: str):
        for i, op in enumerate(pool):
            if op.kind == kind and op.payload_bytes == nbytes \
                    and op.axis == axis:
                return pool.pop(i)
        return None

    def ladder_legs(bucket, itemsize) -> Optional[List[str]]:
        """The missing legs of ``bucket``'s ladder, or None when its
        reduce-scatter is absent."""
        quantized = (spec.dcn_dtype is not None
                     and getattr(torch, bucket.dtype).is_floating_point)
        lay = hier_bucket_layout(bucket.nbytes // itemsize, spec.axis_size,
                                 spec.hier_inner, quantized)
        if take("reduce_scatter", lay["padded_elems"] * itemsize,
                ICI_AXIS) is None:
            return None
        shard = lay["shard_elems"]
        missing: List[str] = []
        legs = []
        if quantized:
            wire = getattr(torch, spec.dcn_dtype).itemsize
            if lay["two_stage"]:
                legs += [("alltoall", shard * wire, DCN_AXIS,
                          "quantized inter-host all-to-all"),
                         ("allgather", 4, DCN_AXIS, "scale all-gather"),
                         ("allgather", lay["sub_elems"] * wire + 4,
                          DCN_AXIS, "quantized sub-shard all-gather")]
            else:
                legs.append(("allgather", shard * wire + 4, DCN_AXIS,
                             "quantized inter-host all-gather"))
            ag = shard * 4
        else:
            legs.append(("allreduce", shard * itemsize, DCN_AXIS,
                         "inter-host all-reduce of the shard"))
            ag = shard * itemsize
        legs.append(("allgather", ag, ICI_AXIS,
                     "intra-host all-gather of the shard"))
        for kind, nbytes, axis, what in legs:
            if take(kind, nbytes, axis) is None:
                missing.append(f"{nbytes} B {what}")
        return missing

    for bucket in plan:
        itemsize = getattr(torch, bucket.dtype).itemsize
        name = (f"bucket {bucket.dtype}.b{bucket.index} "
                f"({bucket.nbytes} B)")
        if spec.hier_inner:
            missing = ladder_legs(bucket, itemsize)
            if missing is not None:
                findings.extend(Finding(
                    program, "HVV105",
                    f"{name} reduce-scatters on the hierarchical ladder "
                    f"(inner {spec.hier_inner}) but its {leg} is missing "
                    "or mis-sized") for leg in missing)
                continue
            if take("allreduce", bucket.nbytes, spec.axis) is not None:
                findings.append(Finding(
                    program, "HVV105",
                    f"{name} ran as ONE FLAT all-reduce while the plan "
                    f"declares the inner-{spec.hier_inner} ladder: the "
                    "ladder did not engage"))
                continue
        elif take("allreduce", bucket.nbytes, spec.axis) is not None:
            continue
        padded = _pad_up(bucket.nbytes, spec.axis_size * itemsize)
        if take("reduce_scatter", padded, spec.axis) is not None:
            if take("allgather", padded // spec.axis_size,
                    spec.axis) is None:
                findings.append(Finding(
                    program, "HVV105",
                    f"{name} reduce-scatters but its "
                    f"{padded // spec.axis_size} B all-gather of the "
                    "shard is missing"))
            continue
        findings.append(Finding(
            program, "HVV105",
            f"{name} of the declared plan ({len(bucket.members)} "
            f"tensor(s) at threshold {spec.threshold}) has NO matching "
            "collective in the recording: the program does not run the "
            "bucket plan it claims"))
    findings.extend(Finding(
        program, "HVV105",
        f"{op.describe()} matches NO bucket of the declared plan "
        f"({len(plan)} bucket(s) at threshold {spec.threshold}): "
        "unplanned exchange traffic", op.source) for op in pool)
    return findings


# ---------------------------------------------------------------- HVV201


@dataclasses.dataclass
class ShardingSpec:
    """What a program declares about its shardings: ``mesh`` the bound
    :class:`~horovod_tpu_torch.parallel.logical.LogicalMesh`, ``entries``
    one ``(label, logical_dims, declared_spec)`` triple per sharded
    input, output or parameter group."""

    mesh: object
    entries: Sequence


def _norm_spec(spec) -> tuple:
    t = tuple(spec) if spec is not None else ()
    while t and t[-1] is None:
        t = t[:-1]
    return t


def check_shardings(program: str, spec: ShardingSpec) -> List[Finding]:
    """HVV201: every declared spec equals what the rules table resolves
    for its logical dims."""
    findings: List[Finding] = []
    for label, dims, declared in spec.entries:
        try:
            expected = spec.mesh.spec(*dims)
        except Exception as e:
            findings.append(Finding(
                program, "HVV201",
                f"sharding entry '{label}' claims logical dims "
                f"{tuple(dims)!r} the rules table cannot resolve: {e}"))
            continue
        if _norm_spec(declared) != _norm_spec(expected):
            findings.append(Finding(
                program, "HVV201",
                f"sharding entry '{label}': declared spec "
                f"{tuple(declared)!r} but the axis-rules table resolves "
                f"logical dims {tuple(dims)!r} to {tuple(expected)!r} on "
                f"mesh '{spec.mesh.config}'"))
    return findings


# ---------------------------------------------------------------- HVV202


def check_axis_vocabulary(program: str, schedule: Sequence[CollectiveOp],
                          logical_mesh) -> List[Finding]:
    """HVV202: every op's axis is one the bound LogicalMesh defines."""
    defined = set(logical_mesh.axis_names)
    return [Finding(
        program, "HVV202",
        f"{op.describe()} runs over axis {op.axis!r}, which the bound "
        f"LogicalMesh ('{logical_mesh.config}') does not define: the "
        "group bypassed the rules table", op.source)
        for op in schedule if op.axis is not None
        and op.axis not in defined]


# ---------------------------------------------------------------- HVV203


@dataclasses.dataclass
class EquivalenceSpec:
    """One per-module reference a composed program must reproduce.
    ``reference`` returns ``(build, world)`` for
    :func:`~horovod_tpu_torch.verify.schedule.simulate`: the
    single-strategy program at the composed program's local shapes.
    ``axes`` are the composed program's axes the reference owns (its ops
    are those over them); ``axis_map`` renames composed axes to the
    reference's."""

    reference: Callable
    axes: Sequence[str]
    axis_map: Dict[str, str] = dataclasses.field(default_factory=dict)
    name: str = "reference"


def _op_key(op: CollectiveOp, rename: Dict[str, str]) -> tuple:
    return (op.kind, rename.get(op.axis, op.axis), op.shapes, op.dtypes,
            op.params)


def check_equivalence(program: str, schedule: Sequence[CollectiveOp],
                      specs: Sequence[EquivalenceSpec],
                      simulate: Callable) -> List[Finding]:
    """HVV203: per reference, the composed ops over its axes equal the
    reference's own ops, op for op in issue order (rank 0 of each)."""
    findings: List[Finding] = []
    for spec in specs:
        build, world = spec.reference()
        ref = simulate(build, world)[0]
        owned = set(spec.axes)
        mapped = {spec.axis_map.get(a, a) for a in spec.axes}
        composed = [op for op in schedule if op.axis in owned]
        ref_ops = [op for op in ref if op.axis in mapped]
        got = [_op_key(op, spec.axis_map) for op in composed]
        want = [_op_key(op, {}) for op in ref_ops]
        if got == want:
            continue
        if len(got) != len(want):
            findings.append(Finding(
                program, "HVV203",
                f"composed schedule has {len(got)} collective(s) over "
                f"axes {sorted(owned)} but reference '{spec.name}' "
                f"issues {len(want)}: composition changed what the "
                "strategy puts on the wire"))
            continue
        i = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        findings.append(Finding(
            program, "HVV203",
            f"composed schedule diverges from reference '{spec.name}' at "
            f"op #{i}: composed {composed[i].describe()} vs reference "
            f"{ref_ops[i].describe()}", composed[i].source))
    return findings
