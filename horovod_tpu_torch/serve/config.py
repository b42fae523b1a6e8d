"""Serving engine configuration: page math + scheduler SLO knobs.

The port of ``horovod_tpu.serve.config.ServeConfig``, with the same
fields, defaults and validation. The page math contract:

* the model's position table length ``Lmax`` must divide into
  ``page_size`` pages — each request's logical cache is ``Lmax //
  page_size`` page slots, mapped to physical pages by its page table;
* physical page 0 is RESERVED as the null sink: short page tables pad
  with it, and reads beyond a request's length are masked, so its
  contents are never observed — ``num_pages - 1`` pages are allocatable.

``mesh`` (``"dp=1,tp=4"``) shards one engine's heads, MLP features
and vocab over the ranks of a ``torch.distributed`` world
(:func:`~horovod_tpu_torch.serve.engine.resolve_tp_mesh`), validated
here as the reference validates it (:meth:`ServeConfig.mesh_axes`).
:class:`FleetConfig` sizes the fleet
(:mod:`~horovod_tpu_torch.serve.fleet`), with the reference's fields,
defaults and validation. A tensor-parallel replica is a world of its
own: a worker transport (``process``, ``tcp``) runs it as one worker
process, the controller, and its followers; the ``inproc`` transport
refuses it (:func:`refuse_tp_fleet`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

#: Scheduler admission policies.
POLICIES = ("fcfs", "sjf")
#: The latency-vs-throughput SLO knob positions.
SLO_MODES = ("latency", "balanced", "throughput")
#: Page-allocation disciplines.
ADMISSIONS = ("reserve", "lazy")
#: Decode-attention implementations: ``gather`` reconstructs the dense
#: ``[S, Lmax, H, D]`` logical cache per layer per step (the exactness
#: reference); ``paged`` reads only each slot's live pages through the
#: paged-attention kernel (:mod:`horovod_tpu_torch.ops.paged_attention`).
ATTENTIONS = ("gather", "paged")
#: Fleet replica placements: ``inproc`` runs every engine in the
#: router's process (the CI fast lane, zero transport overhead, NO
#: crash isolation); ``process`` runs each replica as its own worker
#: process (:mod:`horovod_tpu_torch.serve.worker`) behind the deadline-
#: checked framed RPC transport (:mod:`horovod_tpu_torch.serve.transport`)
#: — a replica crash is one SIGKILLed OS process, never the router;
#: ``tcp`` runs the same frame protocol over TCP with a shared-secret
#: connect handshake, placing workers across HOSTS
#: (``FleetConfig.hosts``, ssh placement) so a whole machine is a
#: first-class failure domain (``host_down``).
TRANSPORTS = ("inproc", "process", "tcp")

#: Host names a TCP worker can be spawned on WITHOUT ssh (and whose
#: workers may get router-probed free ports instead of an explicit
#: base port).
LOCAL_HOSTS = ("localhost", "127.0.0.1")


def parse_host_entry(entry) -> tuple:
    """One ``FleetConfig.hosts`` entry — ``"host"`` or ``"host:port"``
    — parsed to ``(host, port_or_None)``, validated fail-fast (the
    construction-time contract: a malformed placement must never
    survive to the first spawn). ``port`` is the BASE port for that
    host's workers (worker ``i``-th on the host binds ``port + i``);
    local hosts may omit it (the router probes free ports), remote
    hosts must not (the router cannot probe a port over ssh)."""
    if not isinstance(entry, str) or not entry.strip():
        raise ValueError(
            f"hosts entry {entry!r}: expected a 'host[:port]' string")
    e = entry.strip()
    if "/" in e:
        raise ValueError(
            f"hosts entry {entry!r} looks like a unix-socket path — "
            "transport='tcp' places workers at 'host[:port]' network "
            "endpoints (the unix-socket lane is transport='process')")
    host, sep, port_s = e.rpartition(":")
    if not sep:
        return e, None
    if not host:
        raise ValueError(
            f"hosts entry {entry!r}: missing the host part")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"hosts entry {entry!r}: port {port_s!r} is not an "
            "integer") from None
    if not 1 <= port <= 65535:
        raise ValueError(
            f"hosts entry {entry!r}: port {port} outside 1..65535")
    return host, port



@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for :class:`horovod_tpu_torch.serve.ServeEngine`.

    ``page_size``/``num_pages`` size the paged KV cache (page 0
    reserved). ``decode_slots`` fixes the decode batch; ``prefill_chunk``
    the tokens per step the prefill lane processes.

    ``policy`` picks the queue order (``fcfs`` / ``sjf``); ``slo`` gates
    when NEW prefills start (``latency`` / ``balanced`` /
    ``throughput``); ``admission`` picks the page discipline (``reserve``
    worst case up front, or ``lazy`` with eviction-recompute).

    ``attention`` picks the decode-attention path: ``gather`` (the
    default and the exactness reference) reconstructs each slot's dense
    ``[Lmax, H, D]`` cache per layer per step, while ``paged`` reads only
    the ``ceil((t+1)/page_size)`` live pages through the paged-attention
    kernel. Greedy token streams are identical either way; the prefill
    lane gathers the full cache in both modes.

    ``prefix_caching`` maps a prompt's already-filled whole pages into
    the new request read-only (:mod:`~horovod_tpu_torch.serve.prefix`),
    so prefill starts at the first miss. ``speculate_k`` > 0 turns on
    speculative decoding: a draft made of the target's first
    ``draft_layers`` layers (0 = half the depth) proposes up to
    ``speculate_k`` tokens a slot a step, and the target verifies them
    in one pass; greedy streams stay those of the plain engine.
    """

    page_size: int = 16
    num_pages: int = 64
    decode_slots: int = 4
    prefill_chunk: int = 32
    max_in_flight: int = 0      # 0 = decode_slots + the prefill lane
    policy: str = "fcfs"
    slo: str = "balanced"
    admission: str = "reserve"
    attention: str = "gather"
    prefix_caching: bool = False
    speculate_k: int = 0
    draft_layers: int = 0
    eos_token: Optional[int] = None
    max_queue: int = 0          # 0 = unbounded
    requeue_evicted: bool = True
    mesh: Optional[str] = None
    #: Default per-request deadline in seconds from arrival (None = no
    #: deadline; a per-request ``ttl=`` overrides).
    default_ttl: Optional[float] = None

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved null "
                f"sink), got {self.num_pages}")
        if self.decode_slots < 1:
            raise ValueError(
                f"decode_slots must be >= 1, got {self.decode_slots}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.slo not in SLO_MODES:
            raise ValueError(f"slo {self.slo!r} not in {SLO_MODES}")
        if self.admission not in ADMISSIONS:
            raise ValueError(
                f"admission {self.admission!r} not in {ADMISSIONS}")
        if self.attention not in ATTENTIONS:
            raise ValueError(
                f"attention {self.attention!r} not in {ATTENTIONS}")
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate_k must be >= 0 (0 = speculation off), got "
                f"{self.speculate_k}")
        if self.draft_layers < 0:
            raise ValueError(
                f"draft_layers must be >= 0 (0 = auto: half the "
                f"target's depth), got {self.draft_layers}")
        if self.draft_layers > 0 and self.speculate_k == 0:
            raise ValueError(
                f"draft_layers={self.draft_layers} without "
                "speculate_k — the draft only exists to propose "
                "speculative tokens (set speculate_k >= 1)")
        if self.default_ttl is not None and self.default_ttl <= 0:
            raise ValueError(
                f"default_ttl must be > 0 seconds (or None), got "
                f"{self.default_ttl}")
        if self.mesh is not None:
            self.mesh_axes()   # fail-fast: syntax + axis-shape errors

    def mesh_axes(self) -> Optional[dict]:
        """The parsed ``mesh`` axes (``None`` when unsharded), validated
        for the serve shape: the canonical ``name=size`` syntax, fully
        specified sizes (no ``-1`` wildcard: the engine must know its
        rank budget before it touches one), and only the tensor role
        axis above size 1. Raises
        :class:`~horovod_tpu_torch.common.exceptions.InvalidArgumentError`
        at construction, with the reference's messages."""
        if self.mesh is None:
            return None
        from horovod_tpu_torch.common.exceptions import InvalidArgumentError
        from horovod_tpu_torch.parallel.logical import (ROLE_AXES,
                                                        parse_mesh_config)

        axes = parse_mesh_config(self.mesh)    # raises on bad syntax
        tensor = ROLE_AXES["tensor"]
        for name, size in axes.items():
            if size == -1:
                raise InvalidArgumentError(
                    f"ServeConfig.mesh {self.mesh!r}: the serve mesh "
                    f"must be fully specified — '-1' wildcards resolve "
                    "against a device count the config does not know")
            if name != tensor and size != 1:
                raise InvalidArgumentError(
                    f"ServeConfig.mesh {self.mesh!r}: axis {name!r} has "
                    f"size {size}, but one engine shards over the "
                    f"tensor axis ({tensor!r}) only — data parallelism "
                    "is the FLEET's job (one engine per mesh is one "
                    "logical replica)")
        return axes

    @property
    def tp_degree(self) -> int:
        """The tensor-parallel degree the ``mesh`` string names (1 when
        unsharded)."""
        axes = self.mesh_axes()
        if not axes:
            return 1
        from horovod_tpu_torch.parallel.logical import ROLE_AXES

        return axes.get(ROLE_AXES["tensor"], 1)

    @property
    def in_flight_limit(self) -> int:
        """Admitted-requests cap: ``decode_slots`` + the one prefill
        lane by default, so a prefill can always start while every slot
        decodes."""
        return self.max_in_flight if self.max_in_flight > 0 \
            else self.decode_slots + 1


def refuse_tp_fleet(config: ServeConfig, transport: str) -> None:
    """Raise :class:`~horovod_tpu_torch.common.exceptions.
    InvalidArgumentError` for tensor-parallel replicas (``config``
    sharding over more than one rank) on the ``inproc`` transport. A TP
    engine's mesh is its whole ``torch.distributed`` world, and one
    process takes part in one world: in-process replicas, several
    engines in the router's process, cannot each be the controller of
    their own. The worker transports give each replica its own world."""
    if config.tp_degree > 1 and transport == "inproc":
        from horovod_tpu_torch.common.exceptions import InvalidArgumentError

        raise InvalidArgumentError(
            f"ServeConfig.mesh={config.mesh!r} with FleetConfig("
            "transport='inproc'): a tensor-parallel engine's mesh is its "
            "whole torch.distributed world, and a process takes part in "
            "one world, so the router's process cannot hold a TP replica "
            "beside others; use transport='process' or 'tcp', where each "
            "replica is a worker process that starts its own tp-1 "
            "followers")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for :class:`horovod_tpu_torch.serve.ServeFleet` — the
    multi-replica layer on top of one :class:`ServeConfig` (every
    replica runs the same engine geometry).

    ``max_queue`` bounds the ROUTER's admission queue — the fleet's
    load-shedding valve: past it, new requests are rejected terminally
    with ``reject_reason="overloaded"`` and a ``retry_after`` hint
    instead of queueing until their TTFT diverges. 0 = unbounded (no
    shedding).

    ``max_restarts`` is the fleet-wide replica relaunch budget (the
    elastic supervisor's discipline: a crash loop must converge, not
    burn the host); each relaunch backs off exponentially —
    ``backoff_base * 2**attempts_of_that_replica``, capped at
    ``backoff_cap``. A replica whose relaunch would exceed the budget
    is marked ``failed`` and the fleet degrades (load shedding takes
    over).

    ``watchdog_timeout`` > 0 arms the stale-heartbeat watchdog
    (:class:`horovod_tpu_torch.elastic.supervisor.HealthWatchdog`): every
    live replica's heartbeat stamps at the END of each fleet TICK (all
    together, once every replica has stepped — per-step stamping would
    let one slow step age every peer's file into a spurious kill), so
    a replica that silently stops stepping is SIGKILL-classified
    ``stalled`` and relaunched instead of wedging its slice of the
    fleet forever. Size the timeout ABOVE a full fleet tick (the sum
    of all replicas' step times in-process — a relaunch recompile is
    one step), not one replica's step. The directory is ALWAYS
    namespaced per fleet instance (under ``heartbeat_dir`` when
    given) — two fleets, or a fleet and a training supervisor, on one
    host never watch each other's files.

    ``retry_after_min`` floors the overload hint so clients never get
    told to hammer back immediately.

    ``transport`` places the replicas: ``inproc`` (default — the fast,
    CI-exercisable lane) keeps every engine in the router's process;
    ``process`` spawns each replica as its own
    ``python -m horovod_tpu_torch.serve.worker`` OS process behind the
    framed Unix-socket RPC transport, so a replica crash (a REAL
    ``SIGKILL``, an OOM, a segfault) takes down exactly one worker;
    ``tcp`` runs the same frame protocol over TCP (plus a
    shared-secret connect handshake — a TCP listener is
    network-reachable) and places workers across ``hosts``: each entry
    is ``"host"`` or ``"host:port"`` (``port`` = that host's base
    port; its ``i``-th worker binds ``port + i``), replicas assigned
    round-robin, remote hosts reached over ssh (the launcher's pty-HUP
    kill discipline, secret over stdin). With ``hosts=None`` every
    worker runs on loopback — the CI lane. A lost HOST is then one
    failure domain: all its replicas drain and redispatch in a single
    classified ``host_down`` incident. The transport/hosts
    combination is validated HERE, at construction (``hosts`` without
    ``transport="tcp"``, unix-socket-path entries, duplicate
    host:port pairs, portless remote hosts all raise) — never at
    first spawn.
    Every RPC then carries ``rpc_deadline`` seconds of budget — size
    it ABOVE the worker's one-off costs inside a call (the first
    ``step`` poll after a (re)spawn waits out the engine build + torch
    import behind the worker's lock) — and any transport failure is
    converted into the replica-death path, never retried.
    ``spawn_timeout`` bounds how long a (re)spawned worker may take to
    start listening; ``shutdown_deadline`` is :meth:`ServeFleet.close
    <horovod_tpu_torch.serve.fleet.ServeFleet.close>`'s budget for the
    graceful ``shutdown`` RPC before it escalates SIGTERM → SIGKILL.

    **Weight distribution** (process/tcp transports): every worker
    incarnation receives its ServeConfig and a versioned params
    artifact OVER THE WIRE at spawn (``put_config`` + chunked
    ``push_*`` RPCs, :mod:`horovod_tpu_torch.serve.params_wire`) — no shared
    filesystem. ``push_chunk_bytes`` bounds each transfer frame (its
    base64 form must stay under the transport's 16 MiB frame cap);
    ``push_retries`` budgets how many times one push may resume after
    a transport failure (chunk writes are idempotent and
    digest-verified, so the push lane is the ONE place a
    TransportError is retried — under the same exponential backoff as
    relaunches) before the replica takes the ordinary death path.

    **Disaggregated serving**: ``pools={"prefill": P, "decode": D}``
    (``P + D == replicas``) splits the fleet into a prefill pool
    (replica ids ``0..P-1``) and a decode pool (the rest) behind the
    same router. The prefill pool runs each request's chunked prefill
    to completion and ships the finished K/V pages over the wire
    (:mod:`~horovod_tpu_torch.serve.kv_wire`) to a decode replica picked
    by the router's ordinary load keys + prefix-affinity; the two pools
    are scheduled independently. ``pools=None`` (default) keeps the
    colocated layout. The mapping from replica id to pool is fixed for
    the fleet's lifetime (relaunches keep their role), so a death on
    either side drains and redispatches WITHIN the dead replica's pool.
    """

    replicas: int = 2
    max_queue: int = 0            # 0 = unbounded router queue
    max_restarts: int = 2
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    watchdog_timeout: float = 0.0  # 0 = watchdog disabled
    heartbeat_dir: Optional[str] = None   # base dir; namespaced per fleet
    retry_after_min: float = 0.05
    transport: str = "inproc"
    rpc_deadline: float = 60.0     # per-RPC budget (process/tcp transport)
    spawn_timeout: float = 120.0   # worker must listen within this
    shutdown_deadline: float = 2.0  # graceful-shutdown RPC budget
    #: TCP placement: host entries ("host" or "host:port"), replicas
    #: round-robin. None (with transport="tcp") = all on loopback.
    hosts: Optional[tuple] = None
    #: Params-transfer chunk size in bytes (process/tcp transports).
    push_chunk_bytes: int = 1 << 20
    #: Budgeted resume-retries per params push before replica death.
    push_retries: int = 2
    #: Disaggregated prefill/decode pools: {"prefill": P, "decode": D}
    #: with P + D == replicas (normalized to a fixed-order tuple of pairs
    #: so the frozen config stays hashable). None = colocated (default).
    pools: Optional[Any] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {self.replicas}")
        if self.max_queue < 0:
            raise ValueError(
                f"max_queue must be >= 0 (0 = unbounded), got "
                f"{self.max_queue}")
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.backoff_base < 0 or self.backoff_cap < self.backoff_base:
            raise ValueError(
                f"need 0 <= backoff_base <= backoff_cap, got "
                f"{self.backoff_base}/{self.backoff_cap}")
        if self.watchdog_timeout < 0:
            raise ValueError(
                f"watchdog_timeout must be >= 0 (0 disables), got "
                f"{self.watchdog_timeout}")
        if self.retry_after_min <= 0:
            raise ValueError(
                f"retry_after_min must be > 0, got "
                f"{self.retry_after_min}")
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"transport {self.transport!r} not in {TRANSPORTS}")
        if self.rpc_deadline <= 0:
            raise ValueError(
                f"rpc_deadline must be > 0 seconds (every RPC is "
                f"deadline-checked), got {self.rpc_deadline}")
        if self.spawn_timeout <= 0:
            raise ValueError(
                f"spawn_timeout must be > 0 seconds, got "
                f"{self.spawn_timeout}")
        if self.shutdown_deadline <= 0:
            raise ValueError(
                f"shutdown_deadline must be > 0 seconds, got "
                f"{self.shutdown_deadline}")
        if not 1 <= self.push_chunk_bytes <= (8 << 20):
            raise ValueError(
                f"push_chunk_bytes must be within 1..{8 << 20} (the "
                f"base64 form of a chunk must fit the 16 MiB transport "
                f"frame bound), got {self.push_chunk_bytes}")
        if self.push_retries < 0:
            raise ValueError(
                f"push_retries must be >= 0, got {self.push_retries}")
        if self.hosts is not None:
            if self.transport != "tcp":
                raise ValueError(
                    f"hosts= places workers over the network and needs "
                    f"transport='tcp' (got transport="
                    f"{self.transport!r}) — the 'process' transport is "
                    "unix-socket, same-host by construction")
            if isinstance(self.hosts, str):
                raise ValueError(
                    "hosts must be a sequence of 'host[:port]' entries, "
                    f"not the single string {self.hosts!r} (a string "
                    "would iterate per-character)")
            seen = set()
            for entry in self.hosts:
                host, port = parse_host_entry(entry)   # raises fail-fast
                if host not in LOCAL_HOSTS and port is None:
                    raise ValueError(
                        f"hosts entry {entry!r}: a remote host needs an "
                        "explicit base port — the router cannot probe "
                        "free ports over ssh")
                if (host, port) in seen:
                    raise ValueError(
                        f"duplicate host:port entry {entry!r} — two "
                        "hosts' workers would race for the same ports")
                seen.add((host, port))
            # Normalize to a tuple so the frozen config stays hashable
            # whatever sequence the caller passed.
            object.__setattr__(self, "hosts", tuple(self.hosts))
        if self.pools is not None:
            pools = dict(self.pools)
            if set(pools) != {"prefill", "decode"}:
                raise ValueError(
                    f"pools must name exactly {{'prefill', 'decode'}} "
                    f"(disaggregation is a two-phase split, not a "
                    f"general pool map), got keys {sorted(pools)}")
            for name in ("prefill", "decode"):
                n = pools[name]
                if not isinstance(n, int) or n < 1:
                    raise ValueError(
                        f"pools[{name!r}] must be an int >= 1 (an empty "
                        f"pool starves the other side), got {n!r}")
            total = pools["prefill"] + pools["decode"]
            if total != self.replicas:
                raise ValueError(
                    f"pools must partition the fleet exactly: "
                    f"prefill + decode = {total} but replicas = "
                    f"{self.replicas}")
            # Normalize to a fixed-order tuple of pairs: hashable, and
            # the prefill count is always pools[0][1].
            object.__setattr__(
                self, "pools",
                (("prefill", pools["prefill"]),
                 ("decode", pools["decode"])))

    # -- disaggregated-pool helpers (colocated fleets: pools is None) --

    @property
    def prefill_replicas(self) -> int:
        """Size of the prefill pool (0 when colocated)."""
        return 0 if self.pools is None else int(self.pools[0][1])

    def pool_of(self, replica_id: int) -> Optional[str]:
        """Pool of ``replica_id``: ids ``0..P-1`` prefill, the rest
        decode; ``None`` when the fleet is colocated. The mapping is
        positional and immutable — a relaunched replica keeps its
        role."""
        if self.pools is None:
            return None
        return "prefill" if replica_id < self.prefill_replicas \
            else "decode"
