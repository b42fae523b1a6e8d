"""Fault-tolerant multi-replica serving: N engines behind one router.

The port of ``horovod_tpu.serve.fleet``. A :class:`ServeFleet` runs N
:class:`~horovod_tpu_torch.serve.engine.ServeEngine` replicas behind a
least-loaded, prefix-aware router (:mod:`~horovod_tpu_torch.serve.
router`), and every failure mode is first-class:

* **replica death** (``kill:`` faults, real crashes) is drained and
  **redispatched**: the router — which streamed every emitted token to
  the client and therefore knows each request's generated-so-far
  prefix — re-submits unfinished requests to survivors with the prefix
  folded into the prompt (:func:`~horovod_tpu_torch.serve.scheduler.
  rebase_for_recompute`). Tokens already emitted are NEVER re-emitted
  (at-most-once), and greedy output stays bit-identical to an
  uninterrupted run;
* **silent stalls** become classified incidents: every live replica's
  heartbeat file is stamped at the END of each fleet tick (see
  :meth:`ServeFleet.step` for why per-step stamping would mis-kill
  healthy peers), and a :class:`~horovod_tpu_torch.elastic.supervisor.
  HealthWatchdog` kills any replica stale past the timeout — classified
  ``stalled`` via :class:`~horovod_tpu_torch.run.driver.WorkerExit`;
* **relaunch** consumes a fleet-wide restart budget with exponential
  backoff; a replica past the budget is ``failed`` and the fleet
  degrades;
* a degraded fleet **sheds load**: the router's admission queue is
  bounded (``FleetConfig.max_queue``), overflow is rejected terminally
  as ``overloaded`` with a ``retry_after`` hint, and requests that can
  NEVER fit the replica geometry reject as ``infeasible``. Rejected
  requests never touch a replica, so they never allocate KV pages.

Replicas come in three placements (``FleetConfig.transport``):

* ``inproc`` (default): engines in the router's process, stepped one
  after another in its thread, with a process-shaped lifecycle (real
  heartbeat files, the real watchdog, the exit taxonomy with synthetic
  ``-SIGKILL`` codes). They share ONE copy of the weights on the fleet's
  device; on the card each engine captures its own lane graphs;
* ``process``: each replica is its own ``python -m
  horovod_tpu_torch.serve.worker`` OS process (spawned and reaped
  through :mod:`horovod_tpu_torch.run`) behind the deadline-checked
  framed RPC transport (:mod:`~horovod_tpu_torch.serve.transport`) —
  real crash isolation. On a one-card host every worker shares the
  card, each with its own CUDA context. ``kill:`` faults become genuine
  ``os.kill(pid, SIGKILL)``; a ``stall:`` fault wedges the worker's
  engine thread so only the stale heartbeat catches it; and ANY
  transport failure is converted into the replica-death path, never
  retried at the RPC layer (a blind resend could double-apply a submit
  and break at-most-once);
* ``tcp``: the same frame protocol over TCP with a shared-secret
  connect handshake, placed across HOSTS (``FleetConfig.hosts``,
  round-robin; remote hosts over ssh with the launcher's pty-HUP kill
  discipline). A lost host — ``kill:host=`` fault, NIC ``partition:``
  — drains and redispatches ALL its replicas in one classified
  ``host_down`` incident, and stall liveness rides the transport (a
  heartbeat sequence in every step/ping/collect reply, aged by the
  router's clock). Every connection to a host routes through one shared
  :class:`~horovod_tpu_torch.serve.netfault.NetFaults` state, so
  partitions are injectable on loopback TCP.

``device`` (``None`` = the card) is where in-process engines run and
what every spawned worker gets as ``--device``; before the first spawn
on the card the fleet builds the kernels, so no worker compiles under
its spawn timeout. Placement across several cards stays the caller's,
through ``worker_env``/``worker_cmd`` (``CUDA_VISIBLE_DEVICES`` per
worker, for example), except for tensor-parallel replicas.

**Tensor-parallel replicas** (``ServeConfig.mesh="dp=1,tp=N"``) run on
the worker transports: each replica is one worker, the controller of
its engine, which starts ``N - 1`` followers of its own in its process
group (:mod:`~horovod_tpu_torch.serve.tp_replica`), so a replica's kill
or relaunch takes its whole world. The fleet gives replica ``i`` the
cards ``(i*N + r) % cards`` for its ranks ``r`` (``--cards``): distinct
cards make an NCCL world that captures its lane, a shared card a gloo
world that runs it eagerly. ``chips_per_replica`` defaults to ``N``,
the group's timeout to the larger of ``spawn_timeout`` and
``rpc_deadline``, and a rolling update pushes to the controller, which
fans the weights out. The ``inproc`` transport refuses them
(:func:`~horovod_tpu_torch.serve.config.refuse_tp_fleet`).

**Weights travel the wire, versioned**
(:mod:`~horovod_tpu_torch.serve.params_wire`): every worker incarnation
receives its ServeConfig and a content-addressed params artifact over
the RPC transport itself (chunked, per-chunk CRC'd, digest-verified,
atomically committed), so no placement assumes a shared filesystem.
The push lane is the ONE place a transport failure retries (chunk
writes are idempotent): torn or corrupted transfers resume from the
worker's verified offset under the budgeted backoff.
:meth:`ServeFleet.update_params` rolls a NEW weights version through
the fleet with zero downtime — drain one replica → push → verify →
readmit — while the router pins each request's entire decode to one
version, so a mid-stream mix of two models' tokens is impossible by
construction.

**Disaggregated prefill/decode pools** (``FleetConfig.pools``): the
first ``P`` replicas prefill, the rest decode. Every dispatch goes to the
prefill pool stamped ``prefill_only``, and after every replica has
stepped, :class:`~horovod_tpu_torch.serve.disagg.DisaggCoordinator`
ships each parked request's K/V pages to a decode replica
(:mod:`~horovod_tpu_torch.serve.kv_wire`; in process through the same
chunk codec, over the wire through the worker's ``kv_*`` RPCs). A
worker proxy learns its parked rids from each step reply's ``handoff``
key. Roles are positional and survive relaunches.
"""

from __future__ import annotations

import dataclasses
import os
import signal as _signal
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.elastic.faults import (FaultPlanError,
                                              ServeFaultAction,
                                              parse_serve_fault_plan)
from horovod_tpu_torch.elastic.signals import (Heartbeat,
                                               namespaced_heartbeat_dir)
from horovod_tpu_torch.elastic.supervisor import HealthWatchdog
from horovod_tpu_torch.models.parallel_lm import params_to
from horovod_tpu_torch.run.driver import WorkerExit
from horovod_tpu_torch.serve import params_wire
from horovod_tpu_torch.serve.config import (FleetConfig, ServeConfig,
                                            refuse_tp_fleet)
from horovod_tpu_torch.serve.engine import ServeEngine
from horovod_tpu_torch.serve.router import (pick_replica, replica_load,
                                            retry_after_hint)
from horovod_tpu_torch.serve.scheduler import (Request, RequestState,
                                               rebase_for_recompute,
                                               restart_from_scratch)
from horovod_tpu_torch.serve.transport import (ChecksumError,
                                               ConnectionLost, RpcClient,
                                               TransportError,
                                               remote_error_kind)


def _log(msg: str) -> None:
    print(f"[hvd fleet] {msg}", file=sys.stderr, flush=True)


class Replica:
    """One engine + its process-shaped lifecycle.

    ``state``: ``healthy`` (serving; may currently be stalled or
    slowed by a fault) -> ``dead`` (killed; relaunch pending behind the
    backoff) -> ``healthy`` again, or ``failed`` (terminal: the restart
    budget is spent). ``assigned`` is the ROUTER's bookkeeping —
    dispatched-but-unfinished requests — and is what drain/redispatch
    reads, never the engine's internals (a crashed engine's state is
    gone).
    """

    #: Which FleetConfig.transport shape this replica is.
    transport = "inproc"
    #: In-process replicas are heartbeat-stamped by the FLEET at the
    #: end of each tick; process workers stamp their own file per
    #: served tick (the fleet must never stamp for them — a wedged
    #: worker would look alive forever).
    stamps_own_heartbeat = False
    #: How stall liveness is observed: ``file`` (heartbeat files + the
    #: HealthWatchdog — in-process and same-host process
    #: replicas) or ``transport`` (a heartbeat SEQUENCE riding the
    #: step/ping/collect replies, aged by the ROUTER's clock — TCP
    #: replicas, whose heartbeat file may live on another machine the
    #: router cannot stat).
    liveness = "file"
    #: Host failure-domain index (tcp placement only).
    host: Optional[int] = None
    #: Disaggregated pool ("prefill"/"decode"; None = colocated).
    #: Positional off FleetConfig.pools and IMMUTABLE for the fleet's
    #: lifetime — a relaunched replica keeps its role.
    role: Optional[str] = None

    def __init__(self, rid: int, engine, heartbeat: Optional[Heartbeat]):
        self.id = rid
        self.engine = engine
        self.heartbeat = heartbeat
        self.state = "healthy"
        self.assigned: List[Request] = []
        self.exit: Optional[WorkerExit] = None
        self.restarts = 0               # relaunches consumed so far
        self.relaunch_at: Optional[float] = None
        self.stall_until: Optional[float] = None   # None = not stalled
        self.slow_factor = 1.0
        self.steps = 0
        #: Transport-liveness channel (tcp): last observed heartbeat
        #: sequence value + the ROUTER-clock stamp of when it changed.
        self.hb_seq: Optional[int] = None
        self.hb_at: Optional[float] = None
        #: Params version this replica serves (None = wire-init still
        #: pending: a worker with no weights yet takes no traffic) +
        #: the digest the fleet verified it against.
        self.version: Optional[int] = None
        self.params_sha: Optional[str] = None
        #: False while the rolling update drains this replica — the
        #: router routes around it; its in-flight requests finish.
        self.accepting = True
        #: Armed push-lane fault (the transfer:/corrupt: verbs),
        #: consumed one-shot by the next params push.
        self.push_fault: Optional[str] = None
        #: Fleet-clock stamp of this incarnation's spawn, and the
        #: seconds from it to the first engine step that made progress
        #: (None until then): cold start, wire init and the first
        #: capture included.
        self.spawned_at: Optional[float] = None
        self.first_step_s: Optional[float] = None

    @property
    def healthy(self) -> bool:
        return self.state == "healthy"

    def ensure_dead(self, code_hint: int) -> int:
        """Make the replica's failure domain actually dead and return
        the best-evidence exit code. In-process replicas have no OS
        process — the synthetic hint IS the evidence; process replicas
        SIGKILL + reap and return the real code."""
        return code_hint

    def shutdown(self, deadline: float) -> None:
        """Graceful teardown hook for :meth:`ServeFleet.close` (base:
        nothing to tear down — the engine dies with the router)."""

    def adopt(self, fresh: "Replica") -> None:
        """Take over a freshly-spawned incarnation's live half (the
        relaunch path mutates the existing Replica object in place so
        router bookkeeping and per-id metrics keep their identity)."""
        self.engine = fresh.engine
        self.heartbeat = fresh.heartbeat
        self.version = fresh.version
        self.params_sha = fresh.params_sha
        self.accepting = True
        self.spawned_at = fresh.spawned_at
        self.first_step_s = None


class ProcessReplica(Replica):
    """One replica as its own OS process behind the RPC transport.

    ``engine`` is an :class:`_EngineProxy` exposing the exact attribute
    surface the router and fleet read on a live in-process engine
    (free slots, occupancy, queue length, submit, step, the terminal
    lists) — every fleet code path runs unchanged; only the transport
    underneath differs. ``proc`` is the worker's ``Popen`` (its own
    process group via :func:`horovod_tpu_torch.run.spawn_worker`)."""

    transport = "process"
    stamps_own_heartbeat = True

    def __init__(self, rid: int, engine: "_EngineProxy",
                 heartbeat: Heartbeat, proc, client: RpcClient,
                 sock_path: str):
        super().__init__(rid, engine, heartbeat)
        self.proc = proc
        self.client = client
        self.sock_path = sock_path

    def _cleanup_ipc(self) -> None:
        if self.client is not None:
            self.client.close()
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass

    def ensure_dead(self, code_hint: int) -> int:
        """Genuine ``SIGKILL`` of the worker's process group + reap (no
        zombies), returning the REAL exit code when reapable: a worker
        that already died of its own fault (the ``kill:`` injection, an
        OOM) reports that code; one we killed reports ``-SIGKILL``."""
        from horovod_tpu_torch.run import kill_worker

        code = kill_worker(self.proc)
        self._cleanup_ipc()
        return code if code is not None else code_hint

    def shutdown(self, deadline: float) -> None:
        """close()'s graceful path: ``shutdown`` RPC under a short
        deadline, then SIGTERM → SIGKILL escalation, then reap — a
        stalled (wedged engine thread) worker still answers the RPC on
        its control thread, and one whose RPC thread is gone too falls
        through to the signals. Either way the process is REAPED."""
        from horovod_tpu_torch.run import terminate_worker

        if self.proc.poll() is None and self.client is not None:
            acked = True
            try:
                self.client.call("shutdown", timeout=deadline)
            except TransportError:
                acked = False   # already burned the deadline: escalate
            if acked:
                try:
                    self.proc.wait(deadline)
                except Exception:   # TimeoutExpired: escalate below
                    pass
        terminate_worker(self.proc)
        self._cleanup_ipc()

    def adopt(self, fresh: "Replica") -> None:
        super().adopt(fresh)
        self.proc = fresh.proc
        self.client = fresh.client
        self.sock_path = fresh.sock_path


class TcpReplica(ProcessReplica):
    """One replica worker behind the TCP frame transport, possibly on
    another HOST (ssh placement). Same RPC surface and failure →
    drain/redispatch rules as :class:`ProcessReplica`; what changes:

    * ``host`` indexes the fleet's host table — the replica's failure
      DOMAIN: a transport failure here makes the fleet probe the
      host's other replicas, and a whole-host loss is one classified
      ``host_down`` incident;
    * liveness rides the transport (the worker's heartbeat-sequence
      counter in every ``step``/``ping``/``collect`` reply, aged by
      the router's clock) because a remote heartbeat FILE is not
      visible to the router's watchdog;
    * for ssh-placed workers ``proc`` is the local ssh CLIENT — its
      process group is the kill handle (SIGKILL → pty HUP kills the
      remote tree), but its exit code is only the worker's when the
      remote exited normally: signal deaths and dead sessions report
      255/-signum, which say nothing about the worker, so
      :meth:`ensure_dead` falls back to the caller's evidence hint.
    """

    transport = "tcp"
    liveness = "transport"
    stamps_own_heartbeat = True   # the fleet never stamps files for it

    def __init__(self, rid: int, engine: "_EngineProxy",
                 proc, client: RpcClient, endpoint: str,
                 host: int, host_name: str, via_ssh: bool):
        super().__init__(rid, engine, None, proc, client, endpoint)
        self.host = host
        self.host_name = host_name
        self.via_ssh = via_ssh

    def _cleanup_ipc(self) -> None:
        if self.client is not None:
            self.client.close()
        # No socket file to unlink: the endpoint is a network address.

    def ensure_dead(self, code_hint: int) -> int:
        from horovod_tpu_torch.run import kill_worker

        code = kill_worker(self.proc)
        self._cleanup_ipc()
        if code is None:
            return code_hint
        if self.via_ssh and (code < 0 or code == 255):
            # The ssh CLIENT's own death (our SIGKILL of it, or ssh's
            # 255 for a signal-killed/unreachable remote) is not the
            # worker's exit code — classify from the caller's evidence.
            return code_hint
        return code


class _SizedQueueView:
    """``len()``-only stand-in for a remote engine's queue (the router
    checks ``len(eng.scheduler.queue)`` for the engine-side bound)."""

    def __init__(self):
        self.n = 0

    def __len__(self) -> int:
        return self.n


class _ProxyCache:
    def __init__(self, fits_fn: Callable[[int, int], bool]):
        self._fits = fits_fn
        self._occ = 0.0

    def occupancy(self) -> float:
        return self._occ

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        return self._fits(prompt_len, max_new_tokens)


class _ProxyScheduler:
    def __init__(self, proxy: "_EngineProxy"):
        self._proxy = proxy
        self.queue = _SizedQueueView()
        self.rejected: List[Request] = []

    def submit(self, req: Request) -> bool:
        return self._proxy.submit(req)


class _EngineProxy:
    """Router-side mirror of one worker's engine.

    State the router reads between polls (free slots, occupancy, queue
    length) is the last ``step`` RPC's snapshot; dispatch-limit
    correctness never depends on it (the in-flight cap is checked
    against ``Replica.assigned``, which is router-owned). Token
    streams are mirrored via ``collect``: the router asks for
    everything past what it has already applied per request
    (``since``), so the mirror — which is what drain/redispatch and
    the at-most-once guarantee read — is exactly the set of tokens the
    router has observed. Latency stamps use the ROUTER's clock at
    collect time: what a streaming client at the router actually
    perceives (worker-side clock stamps never cross the wire, so no
    skew to reconcile).

    Any :class:`TransportError` out of these methods means the replica
    must die; the fleet converts it (``_transport_death``) — the proxy
    itself never retries or masks.
    """

    def __init__(self, client: RpcClient, config: ServeConfig,
                 fits_fn: Callable[[int, int], bool], clock):
        self.client = client
        self.config = config
        self.clock = clock
        self.cache = _ProxyCache(fits_fn)
        self.scheduler = _ProxyScheduler(self)
        self.finished: List[Request] = []
        self.timed_out: List[Request] = []
        self.evicted: List[Request] = []
        self._free = config.decode_slots
        self._in_flight = 0
        self._last_ticks = 0
        #: Worker heartbeat-sequence value last seen in a reply (the
        #: transport liveness channel: the worker bumps it once per
        #: engine-loop iteration, idle ones included, so a frozen
        #: value + work outstanding = a wedged engine thread).
        self.last_hb: Optional[int] = None
        #: rid -> worker-output tokens already applied to the mirror.
        self._streamed: Dict[int, int] = {}
        self._by_rid: Dict[int, Request] = {}
        #: Last step RPC's prefix-cache snapshot (None: caching off,
        #: or a worker — e.g. the protocol stub — that never stamps
        #: it; every consumer tolerates the absence).
        self.last_prefix: Optional[Dict] = None
        #: rid -> (hit_tokens, hit_pages) last seen from THIS worker
        #: incarnation. Worker counters restart at 0 per incarnation
        #: while the router mirror is cumulative across redispatches
        #: (the drain baseline depends on it) — so stamps apply as
        #: deltas, never overwrites.
        self._prefix_seen: Dict[int, tuple] = {}
        #: Router rids parked in the worker's handoff bay (last step
        #: RPC's snapshot; always empty outside disaggregated pools).
        self.handoff_rids: List[int] = []

    def _free_slots(self) -> int:
        return self._free

    def submit(self, req: Request) -> bool:
        now = self.clock()
        r = self.client.call("submit", {
            "rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "eos_token": req.eos_token,
            "seed": int(req.seed),
            "age": max(0.0, now - req.arrival),
            "ttl": req.ttl,
            "prefill_only": bool(req.prefill_only),
        })
        if r.get("accepted"):
            self._streamed[req.rid] = 0
            self._by_rid[req.rid] = req
            self._prefix_seen[req.rid] = (0, 0)
            req.state = RequestState.QUEUED
            if req.t_admit is None:
                req.t_admit = now
            # Keep the snapshot honest WITHIN a tick: an accepted
            # submit sits in the worker's queue until picked, so a
            # second dispatch this tick must see the occupancy (an
            # engine-side max_queue would otherwise terminally reject
            # a request the router's contract says should WAIT at the
            # fleet head). The next step RPC overwrites with truth.
            self.scheduler.queue.n += 1
            return True
        req.state = RequestState.REJECTED
        req.reject_reason = r.get("reject_reason")
        req.retry_after = r.get("retry_after")
        self.scheduler.rejected.append(req)
        return False

    def step(self) -> bool:
        s = self.client.call("step")
        self._free = int(s["free_slots"])
        self.cache._occ = float(s["occupancy"])
        self.scheduler.queue.n = int(s["queue_len"])
        self._in_flight = int(s["in_flight"])
        if s.get("hb") is not None:
            self.last_hb = int(s["hb"])
        if s.get("prefix") is not None:
            self.last_prefix = s["prefix"]
        self.handoff_rids = [int(x) for x in s.get("handoff") or ()]
        stepped = int(s["ticks"]) > self._last_ticks
        self._last_ticks = int(s["ticks"])
        if not self._by_rid:
            # No router-owned request is outstanding, so no event or
            # progress can exist (rids are born in submit and live in
            # _by_rid until their terminal applies): skip the collect
            # round trip — idle fleets pay one RPC per tick, not two,
            # and rpc_ms isn't flooded with empty collects.
            return stepped
        c = self.client.call("collect", {
            "since": {str(r): n for r, n in self._streamed.items()}})
        if c.get("hb") is not None:
            self.last_hb = int(c["hb"])
        now = self.clock()
        for pr in c.get("progress", ()):
            req = self._by_rid.get(int(pr["rid"]))
            if req is None:
                continue
            self._apply_tokens(req, pr.get("tokens") or [], now)
            req.prefill_pos = int(pr.get("prefill_pos", req.prefill_pos))
            self._apply_prefix(req, pr)
        for ev in c.get("events", ()):
            rid = int(ev["rid"])
            req = self._by_rid.pop(rid, None)
            if req is None:
                continue
            done = self._streamed.pop(rid, 0)
            self._apply_tokens(req, ev.get("output", [])[done:], now)
            req.prefill_pos = int(ev.get("prefill_pos", 0))
            req.evictions = int(ev.get("evictions", req.evictions))
            self._apply_prefix(req, ev)
            self._prefix_seen.pop(rid, None)
            req.state = ev["state"]
            if req.state == RequestState.REJECTED:
                req.reject_reason = ev.get("reject_reason")
                req.retry_after = ev.get("retry_after")
                self.scheduler.rejected.append(req)
            elif req.state == RequestState.TIMEOUT:
                req.t_finish = now
                self.timed_out.append(req)
            elif req.state == RequestState.EVICTED:
                self.evicted.append(req)
            else:
                req.t_finish = now
                self.finished.append(req)
        return stepped

    def _apply_prefix(self, req: Request, payload: Dict) -> None:
        """Fold one progress/terminal payload's prefix stamps into the
        mirror as DELTAS against what this incarnation already
        reported (see ``_prefix_seen``). Payloads without the keys —
        stub workers, pre-prefix workers — apply nothing."""
        if "prefix_hit_tokens" not in payload:
            return
        seen_t, seen_p = self._prefix_seen.get(req.rid, (0, 0))
        wt = int(payload["prefix_hit_tokens"])
        wp = int(payload.get("prefix_hit_pages", seen_p))
        req.prefix_hit_tokens += max(0, wt - seen_t)
        req.prefix_hit_pages += max(0, wp - seen_p)
        self._prefix_seen[req.rid] = (wt, wp)

    def _apply_tokens(self, req: Request, tokens, now: float) -> None:
        if not tokens:
            return
        req.output.extend(int(t) for t in tokens)
        req.generated.extend(int(t) for t in tokens)
        if req.t_first_token is None:
            req.t_first_token = now
        req.token_times.extend([now] * len(tokens))
        if req.rid in self._streamed:
            self._streamed[req.rid] += len(tokens)

    def reset_metrics(self) -> None:
        self.client.call("reset_metrics")
        self._last_ticks = 0
        self.finished = []
        self.timed_out = []
        self.evicted = []
        self.scheduler.rejected = []


class ServeFleet:
    """N continuous-batching replicas behind a fault-tolerant router.

    ``params``/``config`` build each replica's engine (one geometry
    fleet-wide); ``fleet`` sizes the fleet and its recovery policy.
    ``clock`` and ``sleep`` are injectable for deterministic tests —
    the heartbeat/watchdog lane alone reads real file mtimes, so stall
    detection tests run on the wall clock. ``device`` (None = the card)
    is where in-process engines run and what spawned workers get as
    ``--device``; ``worker_env``/``worker_cmd`` adjust or replace the
    worker's environment and command line.

    The lifecycle mirrors :class:`ServeEngine`: :meth:`submit` admits
    (or sheds), :meth:`step` runs one fleet tick (faults -> watchdog ->
    relaunches -> dispatch -> one engine step per live replica),
    :meth:`run` drains to idle, :meth:`stats` aggregates SLO + recovery
    metrics.
    """

    def __init__(self, params: Dict, config: ServeConfig,
                 fleet: Optional[FleetConfig] = None, *,
                 chips_per_replica: Optional[int] = None,
                 clock=time.perf_counter, sleep=time.sleep,
                 worker_env: Optional[Dict[str, str]] = None,
                 worker_cmd: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.fleet = fleet if fleet is not None else FleetConfig()
        refuse_tp_fleet(config, self.fleet.transport)
        self.params = self._place(params)
        #: Chips a replica spans: its tensor-parallel degree by default.
        self.chips_per_replica = (config.tp_degree
                                  if chips_per_replica is None
                                  else chips_per_replica)
        #: Each replica's cards, rank by rank (tensor-parallel replicas
        #: on the card; filled at spawn).
        self.replica_cards: Dict[int, List[int]] = {}
        self.chips = self.chips_per_replica * self.fleet.replicas
        self.clock = clock
        self._sleep = sleep

        # Static admission geometry (survives every replica dying):
        # exactly PagedKVCache.fits, computed off params + config —
        # capacity derived from the kvcache module's own constant so
        # router and engines can never disagree on the reserved count.
        from horovod_tpu_torch.serve.kvcache import allocatable_pages

        self._lmax = int(params["pos"].shape[0])
        self._page_capacity = allocatable_pages(config.num_pages)

        # Router state.
        self.queue: List[Request] = []
        self.rejected: List[Request] = []
        self.finished: List[Request] = []
        self.timed_out: List[Request] = []
        self.evicted: List[Request] = []    # engine-terminal evictions
        # admit->finish secs feeding retry_after_hint — a BOUNDED
        # recency window, not the full history: the hint is recomputed
        # on every overloaded rejection (hot exactly when shedding is),
        # and recent service times describe a degraded fleet better
        # than its lifetime average anyway.
        import collections

        self._service_samples = collections.deque(maxlen=256)

        # Recovery metrics.
        self.incidents: List[Dict] = []
        self.incidents_by_class: Dict[str, int] = {}
        self.redispatched_total = 0
        self.tokens_recomputed_total = 0
        #: Drain-time recompute tokens the surviving replica's prefix
        #: cache actually SKIPPED (banked per completed redispatch
        #: cycle; the live remainder is computed in stats()).
        self.redispatch_prefix_saved = 0
        self.shed_total = 0
        self.restarts_used = 0

        self.occupancy_samples: List[float] = []
        self.steps = 0
        self._t_start = clock()
        #: One entry per replica incarnation that has stepped:
        #: ``{"replica", "incarnation", "transport",
        #: "spawn_to_first_step_s"}`` (kept across reset_metrics).
        self.first_steps: List[Dict] = []

        # Fault plan (armed via arm_fault_plan; fires on the clock).
        self._pending_faults: List[tuple] = []   # (fire_at_s, action)
        self._fault_t0: Optional[float] = None

        # Supervision: heartbeat dir namespaced per fleet INSTANCE so
        # colocated fleets/supervisors never watch each other's files.
        self.heartbeat_dir = namespaced_heartbeat_dir(
            self.fleet.heartbeat_dir)
        self.watchdog: Optional[HealthWatchdog] = None
        if self.fleet.watchdog_timeout > 0:
            self.watchdog = HealthWatchdog(
                self.heartbeat_dir, self.fleet.watchdog_timeout,
                interval=min(0.5, self.fleet.watchdog_timeout / 2))

        # Versioned weights: ONE content-addressed artifact per
        # version (serve/params_wire.py — deterministic blob, sha256,
        # chunked-transfer manifest), built for every transport so
        # digests and version bookkeeping are uniform. Wire transports
        # (process/tcp) push it to every worker incarnation at spawn —
        # params never touch a filesystem any other process reads —
        # and update_params() rolls the fleet to a new version one
        # replica at a time.
        self.params_version = 1
        self._artifact = self._build_artifact(params, 1)
        self._config_payload = dataclasses.asdict(config)
        self.push_stats: Dict = {"pushes": 0, "bytes": 0, "chunks": 0,
                                 "retries": 0, "ms": 0.0}
        self.transfer_incidents: Dict[str, int] = {}
        self.version_recomputed = 0
        self._update: Optional[Dict] = None

        # Process-transport plumbing: one workdir per fleet INSTANCE
        # (Unix socket paths ONLY — config and params reach every
        # worker over the wire), per-call RPC wall samples (overhead
        # evidence, shared across incarnations), and the transport-
        # failure incident counters. ``worker_cmd(rid, sock_path,
        # default) -> (argv, env)`` is the spawn injection point
        # (custom containers, the protocol-stub test worker); it
        # receives the default ``(argv, env)`` to tweak or replace.
        # ``worker_env`` overlays the inherited environment of the
        # default command.
        self._workdir: Optional[str] = None
        self._rpc_samples: List[float] = []
        self.transport_incidents: Dict[str, int] = {}
        self._incarnations: Dict[int, int] = {}
        self._worker_env = dict(worker_env or {})
        self._worker_cmd = worker_cmd
        # TCP placement: the parsed host table — each entry one
        # FAILURE DOMAIN: {"name", "port" (base or None=probe-free,
        # local only), "local", "faults" (the shared NetFaults every
        # connection to the host routes through — one NIC, one fate)}.
        self._hosts: List[Dict] = []
        self._secret: Optional[str] = None
        if self.fleet.transport == "process":
            import tempfile

            self._workdir = tempfile.mkdtemp(prefix="hvd-fleet-")
        if self.fleet.transport != "inproc" and \
                self.device.type == "cuda":
            # Every worker loads the kernels; build them here, once,
            # before the first spawn — a compile inside a worker would
            # run under its spawn timeout and the watchdog.
            from horovod_tpu_torch import _build

            _build.build()
        if self.fleet.transport == "tcp":
            from horovod_tpu_torch.run.network import make_secret_key
            from horovod_tpu_torch.serve.config import (LOCAL_HOSTS,
                                                        parse_host_entry)
            from horovod_tpu_torch.serve.netfault import NetFaults

            # One ephemeral shared secret per fleet instance: every
            # TCP connection must pass the handshake before an RPC is
            # served. It reaches workers through the environment
            # (ssh placement ships it over stdin, never argv).
            self._secret = make_secret_key().hex()
            for entry in (self.fleet.hosts or ("127.0.0.1",)):
                name, port = parse_host_entry(entry)
                self._hosts.append({
                    "name": name, "port": port,
                    "local": name in LOCAL_HOSTS,
                    "faults": NetFaults(),
                })

        self._closed = False
        self.replicas: List[Replica] = []
        try:
            for i in range(self.fleet.replicas):
                rep = self._spawn(i)
                rep.role = self.fleet.pool_of(i)
                self.replicas.append(rep)
        except BaseException:
            # A failed spawn mid-constructor must not orphan the
            # replicas (real OS processes!) already running — close()
            # is unreachable when __init__ raises.
            for rep in self.replicas:
                rep.ensure_dead(0)
            import shutil

            shutil.rmtree(self.heartbeat_dir, ignore_errors=True)
            if self._workdir:
                shutil.rmtree(self._workdir, ignore_errors=True)
            raise

        # Disaggregated prefill/decode: the KV-handoff coordinator
        # (serve/disagg.py) runs once per tick after every replica
        # stepped. None = colocated, zero new code paths.
        self.disagg = None
        if self.fleet.pools is not None:
            from horovod_tpu_torch.serve.disagg import DisaggCoordinator

            self.disagg = DisaggCoordinator(self)

    def close(self) -> None:
        """Tear the fleet down and release its host-side footprint.
        Idempotent; a closed fleet can no longer step.

        For REAL children (``transport="process"``) this is the no-
        zombies contract: every worker gets a graceful ``shutdown``
        RPC under ``FleetConfig.shutdown_deadline``, then the SIGTERM →
        SIGKILL escalation, and is REAPED — including replicas whose
        engine thread is wedged by a ``stall:`` fault (their RPC
        thread still answers, and a worker dead on both planes falls
        through to the signals; regression-pinned in tests). Then the
        per-instance heartbeat directory and process-transport workdir
        (sockets, params/config files) are removed — uniquely named by
        construction, so a long-lived service or bench loop
        constructing fleets repeatedly never accumulates orphans.
        Context-manager form closes on exit."""
        if self._closed:
            return
        self._closed = True
        for rep in self.replicas:
            rep.shutdown(self.fleet.shutdown_deadline)
        import shutil

        shutil.rmtree(self.heartbeat_dir, ignore_errors=True)
        if self._workdir:
            shutil.rmtree(self._workdir, ignore_errors=True)

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------- lifecycle

    def _place(self, params: Dict) -> Dict:
        """The params the replicas decode with. In-process replicas
        share ONE copy on the fleet's device (no copy per replica: the
        engines' own ``params_to`` finds every leaf already there);
        wire transports keep the caller's tree, which only feeds the
        artifact and the admission geometry."""
        if self.fleet.transport != "inproc":
            return params
        return params_to(params, self.device)

    def _build_artifact(self, params: Dict, version: int) -> Dict:
        """One content-addressed, versioned transfer artifact (blob +
        manifest + sha256) — the single source every push, digest
        verify, and version stamp reads."""
        blob = params_wire.params_to_blob(params)
        manifest = params_wire.make_manifest(
            blob, version=version,
            chunk_bytes=self.fleet.push_chunk_bytes)
        return {"blob": blob, "manifest": manifest,
                "sha256": manifest["sha256"], "version": version}

    def _spawn(self, rid: int) -> Replica:
        inc = self._incarnations.get(rid, 0) + 1
        self._incarnations[rid] = inc
        rep = self._spawn_incarnation(rid, inc)
        rep.spawned_at = self.clock()
        return rep

    def _spawn_incarnation(self, rid: int, inc: int) -> Replica:
        if self.fleet.transport == "tcp":
            # No heartbeat FILE: a remote worker's file is on another
            # machine — liveness rides the transport instead.
            return self._spawn_tcp(rid, inc)
        hb = Heartbeat(self.heartbeat_dir, rank=rid)
        # A (re)spawned replica is unwatched until its first completed
        # step: no stale file from a previous incarnation may insta-kill
        # it while it imports, builds and captures.
        try:
            os.unlink(hb.path)
        except OSError:
            pass
        if self.fleet.transport == "process":
            return self._spawn_process(rid, inc, hb)
        engine = ServeEngine(self.params, self.config,
                             chips=self.chips_per_replica,
                             clock=self.clock, device=self.device)
        rep = Replica(rid, engine, hb)
        # In-process engines share the fleet's params object directly —
        # no wire, so the version stamp lands at spawn.
        rep.version = self.params_version
        rep.params_sha = self._artifact["sha256"]
        return rep

    def _default_worker_cmd(self, rid: int, sock_path: str):
        # No --params/--config: config and weights arrive over the
        # wire (put_config + the chunked push RPCs) — a worker
        # incarnation reads NOTHING the fleet wrote to a filesystem.
        cmd = [sys.executable, "-m", "horovod_tpu_torch.serve.worker",
               "--socket", sock_path,
               "--rank", str(rid),
               "--heartbeat-dir", self.heartbeat_dir,
               "--device", str(self.device)] + self._tp_args(rid)
        return cmd, self._spawn_env()

    def _tp_args(self, rid: int) -> List[str]:
        """A tensor-parallel replica's worker flags: its ranks' cards
        (on the card) and its group's timeout, no longer than the
        fleet's own budgets for a spawn and an RPC."""
        tp = self.config.tp_degree
        if tp == 1:
            return []
        timeout = max(self.fleet.spawn_timeout, self.fleet.rpc_deadline)
        args = ["--group-timeout", str(timeout)]
        if self.device.type == "cuda":
            import torch

            from horovod_tpu_torch.serve.tp_replica import replica_cards

            cards = replica_cards(rid, tp, torch.cuda.device_count())
            self.replica_cards[rid] = cards
            args += ["--cards", ",".join(map(str, cards))]
        return args

    def _spawn_env(self) -> Dict[str, str]:
        """The inherited environment, ``worker_env`` over it, and this
        package's directory first on ``PYTHONPATH``: ``python -m`` finds
        the worker whatever directory the router runs in."""
        env = dict(os.environ)
        env.update(self._worker_env)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        return env

    def _spawn_process(self, rid: int, inc: int,
                       hb: Heartbeat) -> ProcessReplica:
        from horovod_tpu_torch.run import spawn_worker

        # Per-incarnation socket path: a relaunch must never race the
        # dead incarnation's stale socket file.
        sock_path = os.path.join(self._workdir, f"r{rid}-{inc}.sock")
        default = self._default_worker_cmd(rid, sock_path)
        cmd, env = (self._worker_cmd(rid, sock_path, default)
                    if self._worker_cmd is not None else default)
        proc = spawn_worker(cmd, env)
        client = RpcClient(
            sock_path, default_timeout=self.fleet.rpc_deadline,
            connect_timeout=self.fleet.spawn_timeout,
            proc_alive=lambda: proc.poll() is None,
            call_ms=self._rpc_samples)
        proxy = _EngineProxy(client, self.config, self._fits,
                             self.clock)
        _log(f"replica {rid}: spawned worker pid {proc.pid} "
             f"(incarnation {inc}) on {sock_path}")
        return ProcessReplica(rid, proxy, hb, proc, client, sock_path)

    @staticmethod
    def _free_local_port() -> int:
        import socket as _socket

        with _socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def _spawn_tcp(self, rid: int, inc: int) -> TcpReplica:
        """One TCP worker on its assigned host. Replicas spread
        round-robin over the host table (``rid % hosts``); a host with
        a base port gives its ``k``-th worker ``base + k`` (stable
        across relaunches — the worker binds with ``SO_REUSEADDR``),
        while local auto-port hosts get a fresh probed free port per
        incarnation. Remote hosts spawn over ssh (the launcher's
        pty-HUP kill discipline). The worker starts with NOTHING from
        any filesystem: ServeConfig and the versioned params artifact
        arrive over the wire (``_init_due`` → ``_push_artifact``), so
        multi-host placement assumes no shared working filesystem at
        all."""
        from horovod_tpu_torch.run import spawn_worker, spawn_worker_ssh

        h = rid % len(self._hosts)
        slot = rid // len(self._hosts)   # k-th worker on this host
        host = self._hosts[h]
        if host["port"] is not None:
            port = host["port"] + slot
        else:
            port = self._free_local_port()
        bind_host = "127.0.0.1" if host["local"] else "0.0.0.0"
        endpoint = f"{bind_host}:{port}"
        cmd = [sys.executable, "-m", "horovod_tpu_torch.serve.worker",
               "--bind", endpoint,
               "--rank", str(rid),
               "--device", str(self.device)] + self._tp_args(rid)
        env = self._spawn_env()
        env["HOROVOD_SECRET"] = self._secret
        if self._worker_cmd is not None:
            cmd, env = self._worker_cmd(rid, endpoint, (cmd, env))
        if host["local"]:
            proc = spawn_worker(cmd, env)
        else:
            proc = spawn_worker_ssh(host["name"], cmd, env)
        connect_host = "127.0.0.1" if host["local"] else host["name"]
        client = RpcClient(
            (connect_host, port),
            default_timeout=self.fleet.rpc_deadline,
            connect_timeout=self.fleet.spawn_timeout,
            proc_alive=lambda: proc.poll() is None,
            call_ms=self._rpc_samples,
            secret=self._secret,
            sock_wrap=host["faults"].wrap)
        proxy = _EngineProxy(client, self.config, self._fits,
                             self.clock)
        _log(f"replica {rid}: spawned tcp worker pid {proc.pid} "
             f"(incarnation {inc}) on host {h} ({host['name']}) "
             f"port {port}" + (" via ssh" if not host["local"] else ""))
        rep = TcpReplica(rid, proxy, proc, client,
                         f"{connect_host}:{port}", h, host["name"],
                         via_ssh=not host["local"])
        # The liveness channel starts "fresh now": a spawned worker is
        # unwatched until its heartbeat sequence first moves, aged
        # from spawn time — the same no-insta-kill grace the file
        # watchdog gets by unlinking the stale heartbeat.
        rep.hb_at = self.clock()
        return rep

    # --------------------------------------- wire weight distribution

    def _proc_dead(self, rep: Replica) -> bool:
        proc = getattr(rep, "proc", None)
        return proc is not None and proc.poll() is not None

    def _push_artifact(self, rep: Replica,
                       include_config: bool = False) -> None:
        """Stream the CURRENT params artifact to one wire replica in
        bounded chunks: manifest first (``push_begin`` returns the
        worker's verified resume offset), then per-chunk-CRC'd chunks,
        then ``push_commit`` — the worker digest-verifies the whole
        artifact and atomically renames it into place, and the fleet
        verifies the returned sha256 against its own.

        THE one exception to the no-RPC-retry rule: chunk writes are
        idempotent (same bytes at the same offset, contiguity
        enforced, digest at commit), so a torn or corrupted transfer
        is a typed failure that RETRIES — resume-from-offset under the
        fleet's budgeted exponential backoff (``push_retries``) —
        never a silently wrong model and never an instant replica
        death. Past the budget (or with the worker process observably
        dead) the error propagates and the caller routes the ordinary
        replica-death path.

        Honest limitation: the transfer (and its retry backoff) runs
        SYNCHRONOUSLY inside the fleet tick — for CI-scale artifacts
        this is milliseconds, but a multi-GB push stalls the other
        replicas' stepping for its duration. Chunking the transfer
        ACROSS ticks (the relaunch path's schedule-and-return pattern)
        is the named follow-up when artifact sizes demand it."""
        art = self._artifact
        man = art["manifest"]
        client = rep.engine.client
        fault, rep.push_fault = rep.push_fault, None
        attempts = 0
        t0 = self.clock()
        chunks_sent = 0
        cb, n = man["chunk_bytes"], man["num_chunks"]
        while True:
            try:
                if include_config:
                    client.call("put_config",
                                {"config": dict(self._config_payload)})
                have = int(client.call(
                    "push_begin", {"manifest": man})["have_bytes"])
                if have:
                    _log(f"replica {rep.id}: resuming params push at "
                         f"byte {have}/{man['total_bytes']} (the "
                         "worker's verified prefix survives the torn "
                         "transfer)")
                for i in range(have // cb, n):
                    chunk = params_wire.make_chunk(art["blob"], man, i)
                    if fault is not None and i >= min(max(1, n // 2),
                                                      n - 1):
                        # Consume the one-shot BEFORE applying it: the
                        # tear raises, and a retry must resume clean,
                        # not re-tear forever into the death path.
                        armed, fault = fault, None
                        chunk = self._push_fault_chunk(
                            rep, armed, chunk, i, n, client)
                    client.call("push_chunk", chunk)
                    chunks_sent += 1
                res = client.call("push_commit",
                                  {"version": man["version"]})
                if res.get("sha256") != man["sha256"]:
                    raise ChecksumError(
                        f"push_commit digest {res.get('sha256')!r} != "
                        f"artifact {man['sha256']} — the worker "
                        "assembled a different artifact")
                break
            except TransportError as e:
                kind = remote_error_kind(e)
                self.transfer_incidents[kind] = \
                    self.transfer_incidents.get(kind, 0) + 1
                attempts += 1
                if attempts > self.fleet.push_retries \
                        or self._proc_dead(rep):
                    _log(f"replica {rep.id}: params push failed "
                         f"({kind}: {e}) with no budget left — "
                         "routing into the replica-death path")
                    raise
                # Counted AFTER the budget gate: "retries" are resumes
                # that actually ran, not the terminal failed attempt
                # (transfer_incidents records every observation).
                self.push_stats["retries"] += 1
                backoff = min(self.fleet.backoff_cap,
                              self.fleet.backoff_base
                              * (2 ** (attempts - 1)))
                _log(f"replica {rep.id}: params push attempt "
                     f"{attempts} failed ({kind}: {e}) — classified "
                     f"transfer retry, resuming from the worker's "
                     f"verified offset in {backoff:g}s")
                self._sleep(backoff)
        rep.version = man["version"]
        rep.params_sha = man["sha256"]
        self.push_stats["pushes"] += 1
        self.push_stats["bytes"] += man["total_bytes"]
        self.push_stats["chunks"] += chunks_sent
        self.push_stats["ms"] += round((self.clock() - t0) * 1e3, 3)

    def _push_fault_chunk(self, rep: Replica, fault: str, chunk: Dict,
                          i: int, n: int, client) -> Dict:
        """Apply an already-consumed transfer:/corrupt: fault to the
        push's mid-stream chunk. ``corrupt`` returns a chunk whose
        payload no longer matches its own crc32 — the worker MUST
        reject it typed; ``transfer`` tears the connection mid-push —
        the retry must resume from the worker's verified offset."""
        import base64 as _b64

        if fault == "corrupt":
            raw = bytearray(_b64.b64decode(chunk["data"]))
            raw[0] ^= 0x01
            _log(f"fault injection: corrupt: flipping a bit in chunk "
                 f"{i}/{n} of the push to replica {rep.id}")
            return dict(chunk,
                        data=_b64.b64encode(bytes(raw)).decode("ascii"))
        _log(f"fault injection: transfer: tearing the push to replica "
             f"{rep.id} after {i}/{n} chunks")
        client.close()
        raise ConnectionLost(
            f"transfer fault injection: connection torn mid-push "
            f"after {i}/{n} chunks")

    def _init_due(self, now: float) -> None:
        """Wire-init any healthy replica that has no weights yet (a
        fresh spawn or relaunch): ship ServeConfig + the current
        artifact over its RPC wire. A failed init (worker dead on
        startup, push budget exhausted) is the ordinary classified
        replica-death path — it consumes restart budget exactly like
        the old first-step failure did."""
        if self.fleet.transport == "inproc":
            return
        for rep in self.replicas:
            if not rep.healthy or rep.version is not None:
                continue
            try:
                self._push_artifact(rep, include_config=True)
            except TransportError as e:
                self._transport_death(rep, e, now)
                continue
            _log(f"replica {rep.id}: wire-init complete — params "
                 f"v{rep.version} (sha256 {rep.params_sha[:12]}) "
                 "digest-verified over the transport")

    # --------------------------------------------- rolling updates

    @property
    def update_active(self) -> bool:
        return self._update is not None

    def update_params(self, params: Dict) -> int:
        """Arm a ZERO-DOWNTIME rolling weight update; returns the new
        version. The roll itself advances inside :meth:`step`, one
        replica at a time: stop routing to it → let its in-flight
        requests finish (drain) → push the new artifact over the wire
        (or swap in place, inproc) → verify the digest → readmit.
        Requests already streaming stay PINNED to the version they
        started on (the router only redispatches them onto
        same-version replicas; see ``Request.version``), so a weight
        mix mid-stream is impossible by construction. Replicas that
        are dead when the roll reaches them pick the new version up at
        relaunch — every relaunch wire-inits from the CURRENT
        artifact."""
        if self._closed:
            raise RuntimeError("update_params on a closed ServeFleet")
        if self._update is not None:
            raise RuntimeError(
                "a rolling update is already in progress — one version "
                "boundary at a time (wait for update_active to clear)")
        version = self.params_version + 1
        art = self._build_artifact(params, version)
        # Geometry gate BEFORE any state mutates: the blob header is
        # the complete structural fingerprint (the full pytree spec —
        # every key and nesting — plus per-leaf shapes/dtypes), so a
        # wrong-shaped OR restructured update raises HERE — never
        # after the artifact swap, where it would crash-loop every
        # relaunch (wire) or escape the fleet loop mid-roll (inproc).
        # A geometry change is a new fleet, not a weight roll.
        if params_wire.blob_spec(art["blob"]) != \
                params_wire.blob_spec(self._artifact["blob"]):
            raise ValueError(
                "update_params geometry mismatch: the new params' tree "
                "structure or leaf shapes/dtypes differ from the "
                "serving artifact's — a rolling update swaps WEIGHTS "
                "under the captured lanes; a geometry change needs "
                "a fresh fleet")
        self.params = self._place(params)
        self.params_version = version
        self._artifact = art
        self._update = {"version": version, "params": self.params,
                        "current": None, "t0": self.clock()}
        _log(f"rolling update to params v{version} (sha256 "
             f"{art['sha256'][:12]}) armed — one replica at a time, "
             "version-pinned streams keep decoding")
        return version

    def _advance_update(self, now: float) -> None:
        """One tick of the rolling update's state machine (see
        :meth:`update_params`): pick the next non-updated healthy
        replica, stop routing to it, wait for its in-flight requests
        to finish, push + digest-verify + readmit, repeat. A replica
        already drained updates in the SAME tick it is picked; one
        that is still serving drains across ticks while its peers
        carry the traffic."""
        u = self._update
        if u is None:
            return
        while True:
            rep = u["current"]
            if rep is None:
                for cand in self.replicas:
                    if cand.healthy and cand.version is not None \
                            and cand.version != u["version"]:
                        cand.accepting = False
                        u["current"] = cand
                        _log(f"rolling update: draining replica "
                             f"{cand.id} (v{cand.version} → "
                             f"v{u['version']}; {len(cand.assigned)} "
                             "in flight finish first)")
                        break
                else:
                    # No healthy replica left behind the target: the
                    # roll is complete (dead/uninitialized replicas
                    # wire-init from the new artifact at relaunch).
                    if all(r.version == u["version"] or not r.healthy
                           or r.version is None
                           for r in self.replicas):
                        _log(f"rolling update to params "
                             f"v{u['version']} complete in "
                             f"{self.clock() - u['t0']:.3f}s")
                        self._update = None
                    return
                continue
            if rep.state != "healthy":
                # Died mid-drain/push: its relaunch wire-inits from
                # the new artifact; move on.
                rep.accepting = True
                u["current"] = None
                continue
            if rep.assigned:
                return   # still draining: in-flight requests finish
            try:
                if rep.transport == "inproc":
                    rep.engine.update_params(u["params"])
                    rep.version = u["version"]
                    rep.params_sha = self._artifact["sha256"]
                    self.push_stats["pushes"] += 1
                else:
                    self._push_artifact(rep)
            except TransportError as e:
                self._transport_death(rep, e, now)
                rep.accepting = True
                u["current"] = None
                return
            rep.accepting = True
            u["current"] = None
            _log(f"replica {rep.id}: updated to params "
                 f"v{rep.version} (digest verified) — readmitted")

    @property
    def in_flight(self) -> int:
        return sum(len(r.assigned) for r in self.replicas) + \
            len(self.queue)

    @property
    def idle(self) -> bool:
        return self.in_flight == 0

    @property
    def alive(self) -> bool:
        """At least one replica is serving or can still come back."""
        return any(r.state != "failed" for r in self.replicas)

    # ------------------------------------------------------ fault plan

    def arm_fault_plan(self, plan: Union[str, Sequence[ServeFaultAction]],
                       horizon: Optional[float] = None) -> None:
        """Arm a serving fault plan (string grammar or parsed actions).
        Fire offsets are measured from the fault epoch — the fleet's
        first step, re-anchored only by :meth:`reset_metrics` (the
        bench's measurement start) — NEVER by arming itself: a second
        mid-run arm must not silently shift the fire times of actions
        already armed. An offset already in the past fires at the next
        step. ``horizon`` resolves percent ``at=`` forms (e.g. the
        bench passes its last workload arrival); replica ids are
        validated against the fleet size fail-fast."""
        actions = (parse_serve_fault_plan(plan)
                   if isinstance(plan, str) else list(plan))
        for a in actions:
            # Hand-built actions get the parser's fail-fast contract
            # too — a malformed one must raise HERE, not TypeError
            # out of the fleet loop at fire time.
            a.validate()
            if a.replica is not None and \
                    not 0 <= a.replica < len(self.replicas):
                raise FaultPlanError(
                    f"fault action {a}: replica {a.replica} is outside "
                    f"this fleet (replicas 0..{len(self.replicas) - 1})")
            if a.kind in ("transfer", "corrupt") \
                    and self.fleet.transport == "inproc":
                raise FaultPlanError(
                    f"fault action {a}: {a.kind} faults address the "
                    "params-push wire — the inproc transport has none "
                    "(use transport='process' or 'tcp')")
            if a.host is not None:
                if self.fleet.transport != "tcp":
                    raise FaultPlanError(
                        f"fault action {a}: host-addressed faults need "
                        f"the tcp transport (this fleet is "
                        f"{self.fleet.transport!r} — hosts are not a "
                        "failure domain there)")
                if not 0 <= a.host < len(self._hosts):
                    raise FaultPlanError(
                        f"fault action {a}: host {a.host} is outside "
                        f"this fleet (hosts 0..{len(self._hosts) - 1})")
        self._pending_faults.extend(
            (a.resolve_at(horizon), a) for a in actions)
        self._pending_faults.sort(key=lambda p: p[0])

    def _inject_faults(self, now: float) -> None:
        if not self._pending_faults:
            return
        t = now - self._fault_t0
        while self._pending_faults and self._pending_faults[0][0] <= t:
            _, action = self._pending_faults.pop(0)
            if action.host is not None:
                _log(f"fault injection: {action} firing")
                if action.kind == "kill":
                    # The machine-loss shape: every worker on the host
                    # SIGKILLed (through the ssh pty for remote ones),
                    # one host_down incident, one mass redispatch.
                    self._host_down(action.host, now, cause="kill")
                elif action.kind == "partition":
                    # The NIC-loss shape: every connection to the host
                    # goes dark via the shared NetFaults state at the
                    # transport seam; detection happens organically —
                    # a deadline expiry or the half-open reset when
                    # the window ends — and the probe sweep coalesces
                    # the loss into host_down.
                    self._hosts[action.host]["faults"].partition(
                        action.secs)
                continue
            rep = self.replicas[action.replica]
            _log(f"fault injection: {action} firing (replica state "
                 f"{rep.state})")
            if action.kind == "kill":
                if rep.healthy:
                    # ensure_dead (inside _kill_replica) makes this a
                    # GENUINE os.kill(pgid, SIGKILL) on a process
                    # replica — the observed exit code is the real -9.
                    self._kill_replica(rep, code=-int(_signal.SIGKILL),
                                       stalled=False, now=now)
            elif action.kind == "stall":
                if rep.healthy:
                    self._arm_replica_fault(
                        rep, now, "stall", {"secs": action.secs},
                        lambda: setattr(
                            rep, "stall_until",
                            now + action.secs
                            if action.secs is not None
                            else float("inf")))
            elif action.kind == "slow":
                # Like kill/stall: a fault addressed to a dead replica
                # is a no-op — it must not brand the NEXT incarnation
                # (kill resets slow_factor to 1.0 for the same reason).
                if rep.healthy:
                    self._arm_replica_fault(
                        rep, now, "slow", {"factor": action.factor},
                        lambda: setattr(rep, "slow_factor",
                                        float(action.factor)))
            elif action.kind in ("transfer", "corrupt"):
                # Armed on the REPLICA, consumed one-shot by its next
                # params push (a spawn/relaunch wire-init or the
                # rolling update's roll reaching it).
                if rep.healthy:
                    rep.push_fault = action.kind

    def _arm_replica_fault(self, rep: Replica, now: float, kind: str,
                           payload: Dict, inproc_apply) -> None:
        """Route one stall/slow fault to where the replica actually
        lives: in-process replicas flip the fleet-side flags; a process
        worker is told over RPC and wedges/slows ITSELF (a stalled
        process is then genuinely silent — only its stale heartbeat
        gives it away). A transport failure while arming is, as
        always, replica death."""
        if rep.transport != "process":
            inproc_apply()
            return
        try:
            rep.engine.client.call("fault", dict(payload, kind=kind))
        except TransportError as e:
            self._transport_death(rep, e, now)

    # ------------------------------------------------------ submission

    def _fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """PagedKVCache.fits without a live engine — the SAME
        :func:`~horovod_tpu_torch.serve.kvcache.fits_geometry` predicate, so
        admission control keeps answering (and rejecting honestly)
        while every replica is mid-relaunch and can never drift from
        what the engines would admit."""
        from horovod_tpu_torch.serve.kvcache import fits_geometry

        return fits_geometry(prompt_len, max_new_tokens,
                             max_len=self._lmax,
                             page_size=self.config.page_size,
                             capacity=self._page_capacity)

    def _healthy_slots(self) -> int:
        return sum(r.engine.config.decode_slots for r in self.replicas
                   if r.healthy and r.engine is not None)

    def _reject(self, req: Request, reason: str,
                retry_after: Optional[float] = None) -> Request:
        req.state = RequestState.REJECTED
        req.reject_reason = reason
        req.retry_after = retry_after
        self.rejected.append(req)
        if reason == "overloaded":
            self.shed_total += 1
        return req

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               eos_token: Optional[int] = None, seed: int = 0,
               arrival: Optional[float] = None,
               ttl: Optional[float] = None) -> Request:
        """Admit one request at the router (same surface as
        :meth:`ServeEngine.submit`). Check ``state`` — ``rejected``
        carries ``reject_reason`` (``infeasible``: can never run on
        this geometry; ``overloaded``: the bounded queue is full or the
        fleet is permanently down — retry after ``retry_after`` when
        it is not None)."""
        from horovod_tpu_torch.serve.scheduler import make_request

        req = make_request(self.config, self.clock, prompt,
                           max_new_tokens, temperature=temperature,
                           top_k=top_k, eos_token=eos_token, seed=seed,
                           arrival=arrival, ttl=ttl)
        if not self._fits(req.prompt_len, req.max_new_tokens):
            return self._reject(req, "infeasible")
        if not self.alive:
            # Permanently degraded to zero replicas: shed with no hint
            # (there is no "later" this fleet can promise).
            return self._reject(req, "overloaded")
        if self.fleet.max_queue and \
                len(self.queue) >= self.fleet.max_queue:
            hint = retry_after_hint(
                len(self.queue), max(1, self._healthy_slots()),
                self._service_samples, self.fleet.retry_after_min)
            return self._reject(req, "overloaded", round(hint, 4))
        req.state = RequestState.QUEUED
        self.queue.append(req)
        return req

    # ---------------------------------------------------- supervision

    def _probe_alive(self, rep: Replica, budget: float = 1.0):
        """Short-deadline reachability probe of one replica (the
        host-domain sweep after a peer's transport death). Returns
        None when alive, else the typed failure's class name."""
        try:
            rep.engine.client.call(
                "ping", timeout=min(budget, self.fleet.rpc_deadline))
            return None
        except TransportError as e:
            return type(e).__name__

    def _transport_death(self, rep: Replica, err: Exception,
                         now: float) -> None:
        """The tentpole's one rule: ANY transport failure — refused
        connect, torn frame, checksum mismatch, deadline expiry,
        remote raise — is the replica-death path, never an RPC retry
        (a blind resend could double-apply a submit and break
        at-most-once). ``ensure_dead`` inside the kill path turns the
        maybe-still-running worker into a definitely-dead one and
        recovers its real exit code for classification.

        On the TCP transport the replica's HOST is the suspect: the
        fleet immediately probes the host's other live replicas with a
        short ping, and when the whole host is unreachable (>= 2
        replicas failing together) the loss is ONE classified
        ``host_down`` incident — every replica of the host drains and
        redispatches in the same sweep, instead of N separate
        incidents trickling in one deadline at a time."""
        kind = type(err).__name__
        self.transport_incidents[kind] = \
            self.transport_incidents.get(kind, 0) + 1
        _log(f"replica {rep.id}: transport failure {kind}: {err} — "
             "routing into the replica-death path (no retry)")
        if rep.host is not None:
            peers = [r for r in self.replicas
                     if r is not rep and r.healthy
                     and r.host == rep.host]
            dead_peers = [(p, self._probe_alive(p)) for p in peers]
            dead_peers = [(p, k) for p, k in dead_peers if k is not None]
            if peers and len(dead_peers) == len(peers):
                # The whole host is dark — one incident, one drain.
                self._host_down(rep.host, now, cause="transport",
                                transport_error=kind)
                return
            # A partial sweep: the trigger dies, and so does any peer
            # the probe found dead — each its own classified incident.
            self._kill_replica(rep, code=1, stalled=False, now=now,
                               transport_error=kind)
            for p, pkind in dead_peers:
                self.transport_incidents[pkind] = \
                    self.transport_incidents.get(pkind, 0) + 1
                self._kill_replica(p, code=1, stalled=False, now=now,
                                   transport_error=pkind)
            return
        self._kill_replica(rep, code=1, stalled=False, now=now,
                           transport_error=kind)

    def _host_down(self, h: int, now: float, *, cause: str,
                   transport_error: Optional[str] = None,
                   detect_age: Optional[float] = None) -> None:
        """A whole host is one failure domain: kill, drain and
        redispatch EVERY healthy replica placed on it as a single
        classified ``host_down`` incident (``kill:host=`` faults land
        here directly; transport-detected losses arrive via
        :meth:`_transport_death`'s probe sweep). Each replica still
        relaunches individually under the fleet-wide restart budget —
        a host that comes back simply receives its workers again."""
        host = self._hosts[h]
        reps = [r for r in self.replicas
                if r.healthy and r.host == h]
        if not reps:
            return
        self.incidents_by_class["host_down"] = \
            self.incidents_by_class.get("host_down", 0) + 1
        details = []
        total_moved = total_rec = 0
        max_backoff = 0.0
        code_hint = -int(_signal.SIGKILL) if cause == "kill" else 1
        for rep in reps:
            code, moved, recomputed, backoff = self._kill_replica(
                rep, code=code_hint, stalled=False, now=now,
                transport_error=transport_error, record=False)
            details.append({"replica": rep.id, "code": code})
            total_moved += moved
            total_rec += recomputed
            max_backoff = max(max_backoff, backoff)
        self.incidents.append({
            "replica": None,
            "host": h,
            "host_name": host["name"],
            "category": "host_down",
            "cause": cause,
            "code": details[0]["code"],
            "replicas": details,
            "transport_error": transport_error,
            "t_s": round(now - self._t_start, 4),
            "detect_s": round(detect_age, 4) if detect_age is not None
            else 0.0,
            "redispatched": total_moved,
            "tokens_recomputed": total_rec,
            "backoff_s": round(max_backoff, 4),
        })
        _log(f"host {h} ({host['name']}) down ({cause}"
             + (f": {transport_error}" if transport_error else "")
             + f") — {len(reps)} replica(s) lost in one incident, "
             f"{total_moved} request(s) drained to survivors "
             f"({total_rec} KV tokens to recompute)")

    def _kill_replica(self, rep: Replica, *, code: int, stalled: bool,
                      now: float, detect_age: Optional[float] = None,
                      transport_error: Optional[str] = None,
                      record: bool = True) -> tuple:
        """Classify + drain + schedule relaunch: the fleet edition of
        the supervisor's per-incident policy. ``record=False`` (the
        host-incident path) suppresses the per-replica incident entry
        and class count — the caller owns the single aggregate record
        — and returns ``(code, moved, recomputed, backoff)`` either
        way."""
        # Make the failure domain REALLY dead first (process replicas:
        # SIGKILL the worker's process group + reap — no zombies, and
        # the reaped code beats the synthetic hint as evidence).
        code = rep.ensure_dead(code)
        rep.exit = WorkerExit(rank=rep.id, code=code, stalled=stalled)
        category = rep.exit.category
        moved, recomputed = self._drain(rep, now)
        # The engine object (pages, allocator, captured lanes) is
        # dropped wholesale — the crash shape. Its heartbeat file goes
        # too so the relaunch starts unwatched.
        rep.engine = None
        rep.state = "dead"
        rep.stall_until = None
        rep.slow_factor = 1.0
        rep.hb_seq = None
        rep.hb_at = None
        rep.accepting = True     # the relaunch serves; pins re-gate it
        rep.push_fault = None    # a one-shot fault never brands the
        #                          next incarnation
        if rep.heartbeat is not None:
            try:
                os.unlink(rep.heartbeat.path)
            except OSError:
                pass
        backoff = min(self.fleet.backoff_cap,
                      self.fleet.backoff_base * (2 ** rep.restarts))
        rep.relaunch_at = now + backoff
        if record:
            self.incidents_by_class[category] = \
                self.incidents_by_class.get(category, 0) + 1
            self.incidents.append({
                "replica": rep.id,
                "category": category,
                "code": code,
                "transport_error": transport_error,
                "t_s": round(now - self._t_start, 4),
                # Watchdog kills carry the observed heartbeat age (real
                # detection latency). In-process crashes are observed
                # synchronously — 0.0 is honest here where a
                # multi-process fleet would pay one supervision-poll
                # interval.
                "detect_s": round(detect_age, 4)
                if detect_age is not None else 0.0,
                "redispatched": moved,
                "tokens_recomputed": recomputed,
                "backoff_s": round(backoff, 4),
            })
        _log(f"{rep.exit.describe(role='replica')} — drained {moved} "
             f"request(s) to survivors ({recomputed} KV tokens to "
             f"recompute); relaunch in {backoff:g}s")
        return code, moved, recomputed, backoff

    def _drain(self, rep: Replica, now: float) -> tuple:
        """Recover every dispatched-but-unfinished request of a dead
        replica from ROUTER bookkeeping: rebase generated-so-far into
        the prompt and requeue at the HEAD (they already consumed
        service), preserving their relative order. Returns
        ``(redispatched, kv_tokens_to_recompute)``."""
        moved: List[Request] = []
        recomputed = 0
        terminal = {
            RequestState.FINISHED: self.finished,
            RequestState.TIMEOUT: self.timed_out,
            RequestState.REJECTED: self.rejected,
            RequestState.EVICTED: self.evicted,
        }
        for req in rep.assigned:
            dest = terminal.get(req.state)
            if dest is not None:
                # Terminal but not yet collected — the replica died in
                # the very step that finished/expired it, before the
                # end-of-tick _collect ran (e.g. its engine raised
                # mid-step). The router's streamed-token truth stands:
                # route it to the fleet list, never drop it.
                if not any(r is req for r in dest):
                    dest.append(req)
                continue
            # The dead engine's pages died with it; only the request's
            # host-side bookkeeping survives.
            req.pages = []
            req.page_table = None
            recomputed += req.prefill_pos + len(req.generated)
            # Redispatch-meets-prefix bookkeeping: `recomputed` is the
            # honest PESSIMISTIC count at detection time; hits the
            # survivor's prefix cache lands past this snapshot are
            # tokens never actually recomputed, and stats() nets them
            # out. A re-drain first banks the previous cycle's gains.
            if req.prefix_hits_at_drain is not None:
                self.redispatch_prefix_saved += max(
                    0, req.prefix_hit_tokens - req.prefix_hits_at_drain)
            req.prefix_hits_at_drain = req.prefix_hit_tokens
            if rebase_for_recompute(req):
                req.state = RequestState.QUEUED
                req.requeued = True
                req.redispatches += 1
                moved.append(req)
            else:
                # Killed after its last token was emitted but before
                # the bookkeeping finished it: nothing left to
                # generate — finish, never re-emit (at-most-once).
                req.state = RequestState.FINISHED
                req.t_finish = now
                if req.t_admit is not None:
                    # same service-time sample _collect would stamp —
                    # incident-affected requests must not vanish from
                    # the retry-after estimate.
                    self._service_samples.append(now - req.t_admit)
                self.finished.append(req)
        rep.assigned = []
        self.queue[0:0] = moved
        self.redispatched_total += len(moved)
        self.tokens_recomputed_total += recomputed
        return len(moved), recomputed

    def _check_watchdog(self, now: float) -> None:
        # Transport-liveness lane (tcp replicas): the router cannot
        # stat a remote heartbeat FILE, so liveness is the worker's
        # heartbeat SEQUENCE riding every step/ping/collect reply,
        # aged by the ROUTER's clock. A wedged engine thread keeps its
        # RPC control thread answering — with a frozen sequence — so
        # the stale age here is exactly what the stale file mtime is
        # for local replicas: the silent-stall signal, classified
        # ``stalled``.
        if self.fleet.watchdog_timeout > 0:
            for rep in self.replicas:
                if not rep.healthy or rep.liveness != "transport":
                    continue
                age = now - (rep.hb_at if rep.hb_at is not None
                             else self._t_start)
                if age > self.fleet.watchdog_timeout:
                    _log(f"health watchdog: replica {rep.id} transport "
                         f"heartbeat stale for {age:.2f}s (timeout "
                         f"{self.fleet.watchdog_timeout:g}s) — killing "
                         "the stalled replica")
                    self._kill_replica(rep, code=-int(_signal.SIGKILL),
                                       stalled=True, now=now,
                                       detect_age=age)
        if self.watchdog is None:
            return
        live = [r.id for r in self.replicas
                if r.healthy and r.liveness == "file"]
        for rid, age in self.watchdog.check(live).items():
            rep = self.replicas[rid]
            self.watchdog.kills[rid] = age
            _log(f"health watchdog: replica {rid} heartbeat stale for "
                 f"{age:.2f}s (timeout {self.watchdog.timeout:g}s) — "
                 "killing the stalled replica")
            self._kill_replica(rep, code=-int(_signal.SIGKILL),
                               stalled=True, now=now, detect_age=age)

    def _relaunch_due(self, now: float) -> None:
        for rep in self.replicas:
            if rep.state != "dead" or now < rep.relaunch_at:
                continue
            if self.restarts_used >= self.fleet.max_restarts:
                rep.state = "failed"
                _log(f"replica {rep.id}: restart budget exhausted "
                     f"({self.restarts_used}/{self.fleet.max_restarts} "
                     "used) — marking failed; the fleet degrades")
                continue
            self.restarts_used += 1
            rep.restarts += 1
            fresh = self._spawn(rep.id)
            rep.adopt(fresh)
            rep.state = "healthy"
            rep.exit = None
            if rep.liveness == "transport":
                # Fresh incarnation, fresh liveness grace (the spawn
                # stamped fresh.hb_at; the adopted replica keeps its
                # identity but must not inherit a stale age).
                rep.hb_seq = None
                rep.hb_at = fresh.hb_at
            if self.watchdog is not None:
                # The PREVIOUS incarnation's kill record must not mute
                # watching the fresh one.
                self.watchdog.kills.pop(rep.id, None)
            _log(f"replica {rep.id} relaunched (attempt {rep.restarts}; "
                 f"{self.fleet.max_restarts - self.restarts_used} "
                 "restart(s) left fleet-wide)")
        if not self.alive and self.queue:
            # Zero replicas left, forever: shed the backlog instead of
            # holding clients in a queue that can never drain.
            _log(f"all replicas failed — shedding {len(self.queue)} "
                 "queued request(s)")
            for req in self.queue:
                self._reject(req, "overloaded")
            self.queue = []

    # ------------------------------------------------------- dispatch

    def _expire_queued(self, now: float) -> None:
        """Router-level TTL sweep: a request can blow its deadline
        waiting in the FLEET queue (each engine sweeps its own)."""
        expired = [r for r in self.queue if r.expired(now)]
        if not expired:
            return
        self.queue = [r for r in self.queue if not r.expired(now)]
        for req in expired:
            req.state = RequestState.TIMEOUT
            req.t_finish = now
            self.timed_out.append(req)

    def _version_stranded(self, req: Request) -> bool:
        """A pinned request whose params version no replica can EVER
        serve again: relaunches always wire-init from the CURRENT
        artifact, so a version older than ``params_version`` survives
        only on still-healthy replicas — none left means waiting at
        the head would strand the request forever."""
        return (req.version is not None
                and req.version != self.params_version
                and not any(r.healthy and r.version == req.version
                            for r in self.replicas))

    def _route_key(self, req: Request) -> Optional[str]:
        """The request's prefix-affinity key (None = no affinity /
        prefix caching off). First-chunk hashing makes the key stable
        under :func:`rebase_for_recompute` — a redispatched request
        rendezvouses onto the same survivor as its prefix-mates."""
        if not self.config.prefix_caching:
            return None
        from horovod_tpu_torch.serve.prefix import prefix_route_key

        return prefix_route_key(req.prompt, self.config.page_size)

    def _dispatch(self) -> None:
        # Disaggregated pools: every admission (fresh or requeued — a
        # rebased request needs its folded prompt re-prefilled) goes to
        # the PREFILL pool only; the decode side receives work
        # exclusively through the KV handoff (serve/disagg.py).
        pool = self.replicas if self.disagg is None else \
            self.disagg.prefill_pool()
        while self.queue:
            req = self.queue[0]
            rep = pick_replica(pool, req, self._route_key(req))
            if rep is None:
                if self._version_stranded(req):
                    # The explicit cross-version policy: the stream
                    # RESTARTS from its original prompt under the new
                    # version (scheduler.restart_from_scratch) — the
                    # rebase alternative would splice tokens from two
                    # different models into one stream.
                    _log(f"request {req.rid}: pinned params v"
                         f"{req.version} can never be served again — "
                         "restarting the stream from scratch under "
                         f"v{self.params_version} (explicit policy; "
                         f"{len(req.output)} emitted token(s) "
                         "retracted as a stream restart)")
                    restart_from_scratch(req)
                    self.version_recomputed += 1
                    continue
                break   # head waits; order (and requeue priority) holds
            self.queue.pop(0)
            # Stamped per DISPATCH, not per request: the same request
            # redispatched after a decode-side death prefills again on
            # the prefill pool; colocated fleets always stamp False.
            req.prefill_only = self.disagg is not None
            try:
                accepted = rep.engine.scheduler.submit(req)
            except TransportError as e:
                # The request never reached the replica (or we cannot
                # know that it did — same thing under at-most-once: it
                # was never ACKed, so it is safe to hand to a
                # survivor). Back to the head, replica into the death
                # path, keep dispatching.
                self.queue.insert(0, req)
                req.state = RequestState.QUEUED
                self._transport_death(rep, e, self.clock())
                continue
            if not accepted:
                # Defensive only: eligible() mirrors every admission
                # check (geometry, in-flight headroom, the engine's own
                # bounded queue), so a failure here means drift the
                # router could not see. The engine already stamped the
                # reject and listed it — move that ONE record to the
                # fleet list (never both: stats must not double-count).
                if req in rep.engine.scheduler.rejected:
                    rep.engine.scheduler.rejected.remove(req)
                self.rejected.append(req)
                if req.reject_reason == "overloaded":
                    self.shed_total += 1
                continue
            rep.assigned.append(req)
            req.replica = rep.id
            if req.version is None:
                # First dispatch pins the request's ENTIRE decode to
                # this replica's params version — redispatch may only
                # rebase onto the same version (router.eligible).
                req.version = rep.version

    def _collect(self, rep: Replica) -> None:
        """Pull terminal requests out of a live replica into the fleet
        lists and release router bookkeeping."""
        eng = rep.engine
        done: List[Request] = []
        if eng.finished:
            for req in eng.finished:
                if req.t_finish is not None and req.t_admit is not None:
                    self._service_samples.append(
                        req.t_finish - req.t_admit)
            self.finished.extend(eng.finished)
            done.extend(eng.finished)
            eng.finished = []
        if eng.timed_out:
            self.timed_out.extend(eng.timed_out)
            done.extend(eng.timed_out)
            eng.timed_out = []
        if eng.evicted:
            self.evicted.extend(eng.evicted)
            done.extend(eng.evicted)
            eng.evicted = []
        if eng.scheduler.rejected:
            self.rejected.extend(eng.scheduler.rejected)
            done.extend(eng.scheduler.rejected)
            eng.scheduler.rejected = []
        if done:
            gone = set(id(r) for r in done)
            rep.assigned = [r for r in rep.assigned
                            if id(r) not in gone]

    # ------------------------------------------------------------ step

    def step(self) -> bool:
        """One fleet tick: inject due faults, run the watchdog, process
        due relaunches, wire-init fresh workers, advance a rolling
        update, expire queued deadlines, dispatch, then step every
        live replica once. Returns whether any replica made progress
        (False = idle, everything stalled, or everything waiting on a
        backoff — callers let wall time pass)."""
        if self._closed:
            raise RuntimeError("step() on a closed ServeFleet")
        now = self.clock()
        if self._fault_t0 is None:
            self._fault_t0 = now
        self._inject_faults(now)
        self._check_watchdog(now)
        self._relaunch_due(now)
        self._init_due(now)
        self._advance_update(now)
        self._expire_queued(now)
        self._dispatch()

        progressed = False
        occ: List[float] = []
        ticked: List[Replica] = []
        for rep in self.replicas:
            if not rep.healthy or rep.version is None:
                # version None = wire init still pending (its push
                # failed this tick and the death path is scheduled):
                # the proxy's step RPC would only park on the missing
                # engine.
                continue
            if rep.stall_until is not None:
                if now < rep.stall_until:
                    continue   # no step, no heartbeat: a silent stall
                rep.stall_until = None
            t0 = self.clock()
            try:
                stepped = rep.engine.step()
            except TransportError as e:
                # The wire to a process worker failed (torn frame from
                # a kill mid-write, deadline expiry, connection lost):
                # replica death, by the tentpole rule. Caught BEFORE
                # the generic handler so the incident records the
                # transport evidence and the real reaped exit code.
                self._transport_death(rep, e, now)
                continue
            except Exception as e:
                # A REAL replica crash (engine bug, allocator error,
                # device OOM) — the docstring's contract: one replica
                # is one failure domain. Classify + drain + relaunch
                # like any kill; never let it abort the fleet loop.
                import traceback

                _log(f"replica {rep.id} raised "
                     f"{type(e).__name__}: {e} — classifying as a "
                     "crash\n" + traceback.format_exc())
                self._kill_replica(rep, code=1, stalled=False, now=now)
                continue
            if stepped:
                progressed = True
                rep.steps += 1
                if rep.first_step_s is None:
                    rep.first_step_s = self.clock() - rep.spawned_at
                    self.first_steps.append({
                        "replica": rep.id,
                        "incarnation": self._incarnations[rep.id],
                        "transport": rep.transport,
                        "spawn_to_first_step_s": rep.first_step_s})
                if rep.slow_factor > 1.0:
                    dt = self.clock() - t0
                    if dt > 0:
                        self._sleep((rep.slow_factor - 1.0) * dt)
            if rep.liveness == "transport":
                # Age the transport liveness channel with the ROUTER's
                # clock: the sequence moving (the worker's engine loop
                # iterated, idle ticks included) is what freshness
                # means — reply arrival alone is only the RPC thread.
                # Stamp the clock NOW, not the tick-top `now`: one
                # slow peer step earlier in this tick (a relaunch
                # capture) must not age a healthy, advancing replica's
                # stamp toward a spurious stall kill — the same
                # discipline the end-of-tick file stamping below
                # exists for.
                hb = getattr(rep.engine, "last_hb", None)
                if hb is not None and hb != rep.hb_seq:
                    rep.hb_seq = hb
                    rep.hb_at = self.clock()
            ticked.append(rep)
            self._collect(rep)
            occ.append(rep.engine.cache.occupancy())
        if self.disagg is not None:
            # KV handoffs AFTER every replica stepped (the handoff
            # snapshots are this tick's truth): a completed transfer is
            # fleet progress even when no engine generated.
            if self.disagg.step(now):
                progressed = True
        # Heartbeats stamp at the END of the tick, together: replicas
        # step sequentially in-process, so stamping each inside the
        # loop would let one slow step (a fresh replica's capture) age
        # every PEER's file past the watchdog timeout — a spurious
        # "stalled" kill of a healthy replica. End-of-tick stamping
        # means the next check (top of the following tick) sees ~zero
        # age for every replica that completed this tick; only
        # genuinely skipped replicas — stalled or dead — go stale. An
        # idle-but-healthy replica still stamps (engine.step() False is
        # "nothing to do", not "wedged"). Process workers stamp their
        # OWN file per served tick — the fleet must never stamp for
        # them, or a wedged worker would look alive forever.
        for rep in ticked:
            if not rep.stamps_own_heartbeat:
                rep.heartbeat.touch(rep.steps)
        if occ:
            self.occupancy_samples.append(sum(occ) / len(occ))
        self.steps += 1
        return progressed

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain to idle (or ``max_steps`` fleet ticks); returns
        requests finished so far. Ticks that make no progress (a stall
        waiting for the watchdog, a relaunch waiting out its backoff)
        sleep briefly so wall time — which heartbeat mtimes and
        backoffs are measured in — actually passes. An in-progress
        rolling update keeps the loop alive past request-idle: the
        roll must complete (every replica on the new version) before
        the fleet is done."""
        while not self.idle or self._update is not None:
            if max_steps is not None and self.steps >= max_steps:
                break
            if not self.step():
                if self.idle and self._update is None:
                    break
                self._sleep(0.001)
        return self.finished

    # ---------------------------------------------------------- stats

    def reset_metrics(self) -> None:
        """Bench warmup discipline (capture+warm every replica, then
        measure from a clean slate). Only valid when idle; replica
        health/restart state survives (a mid-life reset must not
        forget a failed replica)."""
        if not self.idle:
            raise RuntimeError("reset_metrics with requests in flight")
        self.finished = []
        self.timed_out = []
        self.evicted = []
        self.rejected = []
        self._service_samples.clear()
        self.incidents = []
        self.incidents_by_class = {}
        self.redispatched_total = 0
        self.tokens_recomputed_total = 0
        self.redispatch_prefix_saved = 0
        self.shed_total = 0
        self.occupancy_samples = []
        self.steps = 0
        self._rpc_samples.clear()
        self.transport_incidents = {}
        self.push_stats = {"pushes": 0, "bytes": 0, "chunks": 0,
                           "retries": 0, "ms": 0.0}
        self.transfer_incidents = {}
        self.version_recomputed = 0
        if self.disagg is not None:
            self.disagg.reset_metrics()
        for rep in self.replicas:
            if rep.healthy and rep.engine is not None:
                try:
                    rep.engine.reset_metrics()
                except TransportError as e:
                    # A reset is the one RPC issued outside step();
                    # the death rule is the same (the replica will be
                    # relaunched with fresh metrics anyway).
                    self._transport_death(rep, e, self.clock())
                    continue
                rep.steps = 0
        self._fault_t0 = None
        self._t_start = self.clock()

    def stats(self) -> Dict:
        """SLO metrics over every request seen, plus the ``fleet``
        block: per-replica occupancy/health, rejection/timeout/
        redispatch counts, classified incidents, and
        detection/recovery evidence (the router-level satellite of
        ROADMAP's "serve-engine TTL/SLO metrics in the fleet
        router")."""
        from horovod_tpu_torch.serve.metrics import summarize

        in_service = [r for rep in self.replicas for r in rep.assigned]
        everything = (self.finished + self.timed_out + self.evicted
                      + self.rejected + list(self.queue) + in_service)
        out = summarize(everything, self.clock() - self._t_start,
                        self.chips, self.occupancy_samples)
        by_reason: Dict[str, int] = {}
        for req in self.rejected:
            key = req.reject_reason or "?"
            by_reason[key] = by_reason.get(key, 0) + 1
        detect = [i["detect_s"] for i in self.incidents
                  if i["category"] == "stalled"]
        from horovod_tpu_torch.serve.metrics import percentile

        rpc_ms = None
        if self.fleet.transport in ("process", "tcp"):
            s = self._rpc_samples
            rpc_ms = {
                "calls": len(s),
                "p50": round(percentile(s, 50), 4) if s else None,
                "p99": round(percentile(s, 99), 4) if s else None,
            }
        # Fleet-level prefix accounting off ROUTER bookkeeping (the
        # per-request stamps), so one code path covers every transport
        # — inproc engines and wire workers alike. ``tokens_saved``
        # that landed PAST a drain baseline were part of the
        # pessimistic drain-time recompute count and net out of the
        # reported ``tokens_recomputed``.
        prefix_block = None
        recomputed_net = self.tokens_recomputed_total
        if self.config.prefix_caching:
            admitted = [r for r in everything if r.t_admit is not None]
            hits = sum(1 for r in admitted if r.prefix_hit_tokens > 0)
            live_saved = sum(
                max(0, r.prefix_hit_tokens - r.prefix_hits_at_drain)
                for r in everything
                if r.prefix_hits_at_drain is not None)
            redispatch_saved = self.redispatch_prefix_saved + live_saved
            prefix_block = {
                "requests": len(admitted),
                "hits": hits,
                "hit_rate": round(hits / len(admitted), 4)
                if admitted else None,
                "prefill_tokens_saved": sum(
                    r.prefix_hit_tokens for r in admitted),
                "pages_shared": sum(
                    r.prefix_hit_pages for r in admitted),
                "redispatch_tokens_saved": redispatch_saved,
            }
            recomputed_net = max(
                0, self.tokens_recomputed_total - redispatch_saved)
        out["fleet"] = {
            "replicas": len(self.replicas),
            "transport": self.fleet.transport,
            "hosts": len(self._hosts) or None,
            "host_incidents": sum(
                1 for i in self.incidents
                if i.get("category") == "host_down"),
            "rpc_ms": rpc_ms,
            "transport_incidents": dict(self.transport_incidents),
            "params_version": self.params_version,
            "params_push": dict(self.push_stats,
                                version=self.params_version),
            "transfer_incidents": dict(self.transfer_incidents),
            "version_recomputed": self.version_recomputed,
            "update_active": self._update is not None,
            "healthy": sum(1 for r in self.replicas if r.healthy),
            "dead": sum(1 for r in self.replicas if r.state == "dead"),
            "failed": sum(1 for r in self.replicas
                          if r.state == "failed"),
            "queued": len(self.queue),
            "redispatched": self.redispatched_total,
            "tokens_recomputed": recomputed_net,
            # the pessimistic drain-time count, before netting out the
            # survivors' prefix hits (equal unless prefix caching is on
            # and a redispatched request re-matched on its survivor)
            "tokens_recomputed_raw": self.tokens_recomputed_total,
            "prefix": prefix_block,
            "shed": self.shed_total,
            "rejected_by_reason": by_reason,
            "timeout": len(self.timed_out),
            "incidents": list(self.incidents),
            "incidents_by_class": dict(self.incidents_by_class),
            "restarts_used": self.restarts_used,
            "max_restarts": self.fleet.max_restarts,
            "detect_s": round(max(detect), 4) if detect else None,
            "disagg": self.disagg.stats()
            if self.disagg is not None else None,
            "per_replica": [
                dict(replica_load(r), id=r.id, state=r.state,
                     role=r.role, steps=r.steps, restarts=r.restarts,
                     version=r.version, params_sha=r.params_sha)
                for r in self.replicas],
        }
        return out
