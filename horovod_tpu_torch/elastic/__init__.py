"""Fault tolerance for the port (`horovod_tpu_torch.elastic`).

What the serving fleet needs is ported:

* :mod:`~horovod_tpu_torch.elastic.faults` — the serving fault-plan
  dialect (``kill:``/``stall:``/``slow:``/``partition:``/``transfer:``/
  ``corrupt:``);
* :mod:`~horovod_tpu_torch.elastic.signals` — :class:`Heartbeat` and the
  per-instance heartbeat directory;
* :mod:`~horovod_tpu_torch.elastic.supervisor` — :class:`HealthWatchdog`.

Still to come, with ROADMAP.md Queue 1 item 5.3 (elastic training): the
training fault dialect (``FaultAction``, ``FaultInjector``, resize),
``PreemptionHandler``, the snapshotter and its resume manifests,
``supervise`` and ``run_elastic``.
"""

from horovod_tpu_torch.elastic.faults import (SERVE_KINDS, FaultPlanError,
                                              ServeFaultAction,
                                              parse_serve_fault_plan)
from horovod_tpu_torch.elastic.signals import (Heartbeat,
                                               namespaced_heartbeat_dir)
from horovod_tpu_torch.elastic.supervisor import HealthWatchdog

__all__ = [
    "FaultPlanError",
    "HealthWatchdog",
    "Heartbeat",
    "SERVE_KINDS",
    "ServeFaultAction",
    "namespaced_heartbeat_dir",
    "parse_serve_fault_plan",
]
