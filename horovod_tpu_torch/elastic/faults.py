"""Deterministic fault injection: the serving half.

The port of the serving dialect of ``horovod_tpu.elastic.faults``: a
plan such as ``kill:replica=1,at=2.5s; stall:replica=0,at=4s;
slow:replica=2,at=1s,factor=3`` addresses fleet replicas (or, on the tcp
transport, hosts) on the wall clock, so every recovery path of
:class:`~horovod_tpu_torch.serve.fleet.ServeFleet` runs on the CPU in
CI. ``at`` accepts plain seconds, an ``s`` suffix, or a ``%`` of the
workload horizon. The grammar, the validation and every message are the
reference's.

The training dialect (``FaultAction``, ``FaultInjector``, the resize
lane) comes with ROADMAP.md Queue 1 item 5.3 (elastic training).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


class FaultPlanError(ValueError):
    """A malformed fault plan — raised at parse (or arm) time so a
    typo'd plan fails fast instead of silently injecting nothing."""


# --------------------------------------------------------------------------
# The SERVING dialect: replica faults on the wall clock.
#
# A serving fleet (horovod_tpu_torch/serve/fleet.py) has no shared step
# counter to key faults off — replicas step independently and requests
# arrive on the wall clock — so serving clauses address `replica=` and
# fire `at=` a point in time measured from the fleet's first step:
#
#     kill:replica=1,at=2.5s       abrupt replica death (crash shape:
#                                  its engine state is lost wholesale;
#                                  in-flight requests are drained from
#                                  the ROUTER's bookkeeping)
#     stall:replica=0,at=4s        the replica stops stepping (and
#                                  heartbeating) for `secs` (default:
#                                  forever) — the health-watchdog lane
#     slow:replica=2,at=1s,factor=3   every step takes factor x as long
#                                  (degraded-host shape: the router's
#                                  least-loaded policy must steer
#                                  around it, not hang on it)
#
# `at` accepts `2.5`, `2.5s`, or `40%` — the percent form resolves
# against a caller-supplied horizon (serve_bench uses the last
# workload arrival) so one CI plan scales with any bench size.
#
# The multi-host fleet (FleetConfig(transport="tcp", hosts=...)) adds
# HOST addressing — a whole machine as the failure domain:
#
#     kill:host=0,at=2.5s          SIGKILL every worker on host 0 (the
#                                  host-OOM / machine-loss shape): all
#                                  its replicas drain + redispatch as
#                                  ONE classified `host_down` incident
#     partition:host=0,at=50%,secs=2   the host's network goes dark for
#                                  `secs` (default: forever) via the
#                                  deterministic injector at the
#                                  transport seam (serve/netfault.py);
#                                  connections from before the window
#                                  come back half-open and reset
#
# kill accepts either replica= or host=; partition is host-only (a NIC
# belongs to a machine); stall/slow stay replica-only (a wedged or slow
# engine is a process property).
#
# The wire-native weight distribution (serve/params_wire.py) adds two
# verbs addressing the params-PUSH lane — the one RPC lane the fleet
# retries (chunk writes are idempotent + digest-verified), so its
# failure modes need their own injectable shapes:
#
#     transfer:replica=0,at=50%      the NEXT params push to the
#                                  replica is torn mid-stream (the
#                                  connection dies after half the
#                                  chunks) — the fleet must classify
#                                  it, back off, reconnect, and RESUME
#                                  from the worker's verified offset
#     corrupt:replica=0,at=50%       the NEXT push delivers one chunk
#                                  whose bytes do not match its own
#                                  crc32 — the worker rejects it with
#                                  a typed ChecksumError and the fleet
#                                  re-sends that chunk (never commits
#                                  a corrupted artifact)
#
# Both are replica-addressed, fire at most once (armed at `at=`,
# consumed by the next push), and need a wire transport (process/tcp)
# — an inproc fleet has no push lane, rejected fail-fast at arm time.

SERVE_KINDS = ("kill", "stall", "slow", "partition", "transfer",
               "corrupt")


@dataclasses.dataclass
class ServeFaultAction:
    kind: str
    replica: Optional[int] = None     # replica-addressed actions
    at: Optional[float] = None        # seconds from fleet start
    at_frac: Optional[float] = None   # fraction of the horizon (at=..%)
    secs: Optional[float] = None      # stall/partition duration; None = forever
    factor: Optional[float] = None    # slow multiplier (kind="slow")
    host: Optional[int] = None        # host-addressed actions (tcp fleet)

    def __str__(self) -> str:
        if self.at_frac is not None:
            at = f"{self.at_frac * 100:g}%"
        elif self.at is not None:
            at = f"{self.at:g}s"
        else:
            at = "?"   # invalid (validate() rejects it) — still printable
        addr = (f"host={self.host}" if self.host is not None
                else f"replica={self.replica}")
        extra = ""
        if self.kind in ("stall", "partition") and self.secs is not None:
            extra = f",secs={self.secs:g}"
        if self.kind == "slow" and self.factor is not None:
            extra = f",factor={self.factor:g}"
        return f"{self.kind}:{addr},at={at}{extra}"

    def validate(self) -> None:
        """Per-action invariants, for actions built in code rather than
        parsed (``ServeFleet.arm_fault_plan`` accepts both): the same
        fail-fast contract the parser enforces, so a malformed action
        raises :class:`FaultPlanError` at ARM time — never a
        ``TypeError`` out of the fleet loop at fire time."""
        if self.kind not in SERVE_KINDS:
            raise FaultPlanError(
                f"fault action {self}: kind must be in {SERVE_KINDS}")
        if self.kind == "partition":
            if self.host is None or self.replica is not None:
                raise FaultPlanError(
                    f"fault action {self}: partition is host-addressed "
                    "(a NIC belongs to a machine) — use host=, not "
                    "replica=")
        elif self.kind == "kill":
            if (self.replica is None) == (self.host is None):
                raise FaultPlanError(
                    f"fault action {self}: kill needs exactly one of "
                    "replica= or host=")
        else:   # stall / slow / transfer / corrupt
            if self.replica is None or self.host is not None:
                raise FaultPlanError(
                    f"fault action {self}: {self.kind} is "
                    "replica-addressed (a wedged/slow engine is a "
                    "process property; a push targets one replica's "
                    "wire) — use replica=, not host=")
        if self.replica is not None and self.replica < 0:
            raise FaultPlanError(
                f"fault action {self}: replica must be >= 0")
        if self.host is not None and self.host < 0:
            raise FaultPlanError(
                f"fault action {self}: host must be >= 0")
        if (self.at is None) == (self.at_frac is None):
            raise FaultPlanError(
                f"fault action {self}: exactly one of at= (seconds) or "
                "at_frac (horizon fraction) must be set")
        if self.at is not None and not (
                self.at >= 0 and math.isfinite(self.at)):
            raise FaultPlanError(
                f"fault action {self}: at must be finite and >= 0")
        if self.at_frac is not None and not 0.0 <= self.at_frac <= 1.0:
            raise FaultPlanError(
                f"fault action {self}: at_frac must be within 0..1")
        if self.kind == "slow":
            if self.factor is None or not (
                    self.factor >= 1.0 and math.isfinite(self.factor)):
                raise FaultPlanError(
                    f"fault action {self}: slow requires a finite "
                    "factor >= 1")
        elif self.factor is not None:
            raise FaultPlanError(
                f"fault action {self}: factor only applies to slow")
        if self.secs is not None:
            if self.kind not in ("stall", "partition"):
                raise FaultPlanError(
                    f"fault action {self}: secs only applies to stall "
                    "and partition")
            if not self.secs > 0 or math.isnan(self.secs):
                raise FaultPlanError(
                    f"fault action {self}: secs must be > 0")

    def resolve_at(self, horizon: Optional[float]) -> float:
        """Absolute fire offset (seconds from fleet start). Percent
        forms need a ``horizon``; a plan using them without one is a
        planning error, raised loudly rather than silently never
        firing."""
        if self.at is not None:
            return self.at
        if horizon is None:
            raise FaultPlanError(
                f"fault action {self} uses a percent at= but no "
                "workload horizon was provided to resolve it against")
        return self.at_frac * horizon


def _parse_at(clause: str, value: str) -> tuple:
    """``at=`` value -> (seconds, fraction) with exactly one set."""
    v = value.strip().lower()
    is_pct = v.endswith("%")
    if is_pct or v.endswith("s"):
        v = v[:-1]
    try:
        num = float(v)
    except ValueError:
        # NOT FaultPlanError's own range errors below — only a
        # non-numeric literal lands here.
        raise FaultPlanError(
            f"fault plan clause {clause!r}: at={value!r} is not a time "
            "(use seconds, '2.5s', or a '40%' horizon fraction)") from None
    if not math.isfinite(num):
        # nan/inf would never fire — and, sorted to the head, would
        # block every later valid action; the contract is fail-fast.
        raise FaultPlanError(
            f"fault plan clause {clause!r}: at={value!r} must be a "
            "finite time")
    if is_pct:
        frac = num / 100.0
        if not 0.0 <= frac <= 1.0:
            raise FaultPlanError(
                f"fault plan clause {clause!r}: at={value!r} must be "
                "within 0%..100% of the horizon")
        return None, frac
    if num < 0:
        raise FaultPlanError(
            f"fault plan clause {clause!r}: at={value!r} must be "
            ">= 0 seconds")
    return num, None


def parse_serve_fault_plan(plan: str) -> List[ServeFaultAction]:
    """Parse the serving fault dialect into actions (sorted by fire
    order is the caller's job — percent and absolute forms can only be
    ordered once the horizon is known). Empty plans parse to ``[]``;
    malformed ones raise :class:`FaultPlanError` naming the clause."""
    actions: List[ServeFaultAction] = []
    for clause in (plan or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, sep, rest = clause.partition(":")
        kind = kind.strip().lower()
        if not sep or kind not in SERVE_KINDS:
            raise FaultPlanError(
                f"fault plan clause {clause!r}: expected "
                f"'<kind>:replica=R,at=T[,...]' (or host=H for "
                f"kill/partition) with kind in {SERVE_KINDS}")
        kv = {}
        for pair in rest.split(","):
            key, psep, value = pair.partition("=")
            key = key.strip().lower()
            if not psep or key not in ("replica", "host", "at", "secs",
                                       "factor"):
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: bad key/value "
                    f"{pair.strip()!r} (keys: replica, host, at, secs, "
                    "factor)")
            kv[key] = value.strip()
        if ("replica" not in kv and "host" not in kv) or "at" not in kv:
            raise FaultPlanError(
                f"fault plan clause {clause!r}: replica= and at= are "
                "required (host= replaces replica= on kill/partition "
                "actions)")
        replica = host = None
        if "replica" in kv:
            try:
                replica = int(kv["replica"])
            except ValueError:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: "
                    f"replica={kv['replica']!r} is not an integer"
                ) from None
            if replica < 0:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: replica must be >= 0")
        if "host" in kv:
            try:
                host = int(kv["host"])
            except ValueError:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: host={kv['host']!r} "
                    "is not an integer") from None
            if host < 0:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: host must be >= 0")
        at, at_frac = _parse_at(clause, kv["at"])
        secs = factor = None
        if "secs" in kv:
            if kind not in ("stall", "partition"):
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: secs= only applies "
                    "to stall and partition actions")
            try:
                secs = float(kv["secs"])
            except ValueError:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: secs={kv['secs']!r} "
                    "is not a number") from None
            if not secs > 0 or math.isnan(secs):
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: secs must be > 0")
        if kind == "slow":
            if "factor" not in kv:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: slow requires "
                    "factor= (the step-time multiplier)")
            try:
                factor = float(kv["factor"])
            except ValueError:
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: "
                    f"factor={kv['factor']!r} is not a number") from None
            if not (factor >= 1.0 and math.isfinite(factor)):
                raise FaultPlanError(
                    f"fault plan clause {clause!r}: factor must be a "
                    "finite number >= 1 (a slow replica takes LONGER "
                    "per step)")
        elif "factor" in kv:
            raise FaultPlanError(
                f"fault plan clause {clause!r}: factor= only applies to "
                "slow actions")
        action = ServeFaultAction(
            kind=kind, replica=replica, at=at, at_frac=at_frac,
            secs=secs, factor=factor, host=host)
        # The addressing-shape invariants (kill: exactly one of
        # replica/host; partition: host only; stall/slow: replica
        # only) live in validate() so hand-built and parsed actions
        # share one fail-fast contract.
        action.validate()
        actions.append(action)
    return actions
