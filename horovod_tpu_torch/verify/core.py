"""The verifier's engine: simulate a program, run the rules.

:func:`verify` runs one registry :class:`Program` in a simulated world
(:func:`~horovod_tpu_torch.verify.schedule.simulate`), checks the ranks'
schedules against each other (HVV101, HVV103), every op's group
(HVV102), and whatever the program declares: its bucket plan (HVV105),
its partition specs (HVV201), its mesh's vocabulary (HVV202) and its
per-module references (HVV203). ``python -m horovod_tpu_torch.verify
--sweep`` runs the whole registry and exits non-zero on any finding
that is not suppressed.

Suppression: a program's ``suppress={"HVVxxx": "reason"}`` marks its
findings of that rule suppressed: reported, never failing, and every
suppression carries its reason (the ``# hvdlint: disable=`` discipline).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch.distributed as dist

from horovod_tpu_torch.verify.rules import (EquivalenceSpec, Finding,
                                            ReconcileSpec, ShardingSpec,
                                            check_axis_vocabulary,
                                            check_equivalence,
                                            check_groups, check_ranks,
                                            check_reconciliation,
                                            check_shardings)
from horovod_tpu_torch.verify.schedule import (CollectiveOp, fake_store,
                                               record, simulate, summarize)


@dataclasses.dataclass
class Program:
    """One registry entry. ``build()`` runs on every simulated rank: it
    sets the program up and returns the zero-argument callable that is
    recorded. ``world`` is the simulated world's size. The optional
    zero-argument callables return what the program declares:
    ``reconcile`` a :class:`ReconcileSpec` (HVV105), ``shardings`` a
    :class:`ShardingSpec` (HVV201), ``logical_mesh`` the LogicalMesh
    whose vocabulary every op's axis must come from (HVV202; it is built
    inside a simulated world), ``equivalence`` a list of
    :class:`EquivalenceSpec` (HVV203)."""

    name: str
    group: str
    build: Callable[[], Callable[[], Any]]
    world: int
    reconcile: Optional[Callable[[], ReconcileSpec]] = None
    shardings: Optional[Callable[[], ShardingSpec]] = None
    logical_mesh: Optional[Callable] = None
    equivalence: Optional[Callable[[], List[EquivalenceSpec]]] = None
    suppress: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class VerifiedProgram:
    name: str
    schedules: List[List[CollectiveOp]]
    findings: List[Finding]

    @property
    def schedule(self) -> List[CollectiveOp]:
        """Rank 0's schedule."""
        return self.schedules[0] if self.schedules else []

    @property
    def summary(self) -> Dict[str, Any]:
        """:func:`summarize` of rank 0's schedule."""
        return summarize(self.schedule)

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]


def _apply_suppressions(findings: List[Finding],
                        suppress: Dict[str, str]) -> List[Finding]:
    out = []
    for f in findings:
        reason = suppress.get(f.rule)
        if reason:
            f = dataclasses.replace(f, suppressed=True,
                                    suppress_reason=reason)
        out.append(f)
    return out


def _in_world(fn: Callable, world: int):
    """``fn()`` computed on rank 0 of a simulated world of ``world``
    ranks (a LogicalMesh lays out the world's ranks)."""
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=world)
    try:
        return fn()
    finally:
        dist.destroy_process_group()


def verify(program: Program) -> VerifiedProgram:
    """Simulate ``program`` and run the rules (the module docstring)."""
    name = program.name
    schedules = simulate(program.build, program.world)
    findings = check_ranks(name, schedules)
    for sched in schedules:
        findings.extend(check_groups(name, sched))
    rank0 = schedules[0]
    if program.reconcile is not None:
        findings.extend(check_reconciliation(name, rank0,
                                             program.reconcile()))
    if program.shardings is not None:
        findings.extend(check_shardings(name, _in_world(
            program.shardings, program.world)))
    if program.logical_mesh is not None:
        lm = _in_world(program.logical_mesh, program.world)
        for sched in schedules:
            findings.extend(check_axis_vocabulary(name, sched, lm))
    if program.equivalence is not None:
        findings.extend(check_equivalence(name, rank0,
                                          program.equivalence(), simulate))
    # Ranks that issue the same faulty op report it once.
    findings = list(dict.fromkeys(findings))
    return VerifiedProgram(name, schedules,
                           _apply_suppressions(findings, program.suppress))


def audit_collectives(fn: Callable, *args, log: Optional[Callable] = None
                      ) -> Tuple[Any, Optional[List[CollectiveOp]]]:
    """``(fn(*args), schedule)``: ``fn`` run once under the recorder, in
    the process group as it stands, and the collectives it issued
    (:func:`summarize` of them is what the port's bench stamps as
    ``"collectives"``). When the recorder fails, this raises; with a
    ``log``, it logs the reason instead and the schedule is ``None``."""
    with record() as rec:
        out = fn(*args)
    if rec.error is None:
        return out, rec.schedule
    msg = f"the collective recorder failed: {rec.error}"
    if log is None:
        raise RuntimeError(msg)
    log(msg)
    return out, None
