"""Static analysis of the port: the collective-schedule verifier, the
counterpart of the JAX package's ``tools/hvdverify``.

The JAX verifier traces each program to a jaxpr and walks it; the port
runs eagerly, so this one runs each program once per rank of a
simulated world (torch's ``fake`` process-group backend, whose
collectives move nothing) and records what every rank issues through
``torch.distributed`` (:mod:`~horovod_tpu_torch.verify.schedule`). The
rules (:mod:`~horovod_tpu_torch.verify.rules`) then compare the ranks'
schedules and reconcile them with what the program declares: HVV101,
HVV102, HVV103, HVV105, HVV201, HVV202 and HVV203. HVV104 (donation)
has no counterpart: torch has no buffer donation.

Usage::

    python -m horovod_tpu_torch.verify --sweep     # the gate (registry)
    python -m horovod_tpu_torch.verify --list
    python -m horovod_tpu_torch.verify --program optimizer.overlap --schedule

Library surface: :func:`verify` (one :class:`Program`),
:func:`audit_collectives` (what one call issues; its :func:`summarize`
is the port's bench stamp), :func:`simulate`, :class:`Recorder` and the
``REGISTRY`` of the port's programs. The verifier runs on the
CPU, with no device.
"""

from horovod_tpu_torch.verify.core import (Program, VerifiedProgram,
                                           audit_collectives, verify)
from horovod_tpu_torch.verify.registry import (FAST_GROUPS, REGISTRY,
                                               WORLD, programs)
from horovod_tpu_torch.verify.rules import (RULES, EquivalenceSpec,
                                            Finding, ReconcileSpec,
                                            ShardingSpec)
from horovod_tpu_torch.verify.schedule import (CollectiveOp, Recorder,
                                               record, simulate,
                                               summarize)

__all__ = [
    "CollectiveOp",
    "EquivalenceSpec",
    "FAST_GROUPS",
    "Finding",
    "Program",
    "REGISTRY",
    "RULES",
    "ReconcileSpec",
    "Recorder",
    "ShardingSpec",
    "VerifiedProgram",
    "WORLD",
    "audit_collectives",
    "programs",
    "record",
    "simulate",
    "summarize",
    "verify",
]
