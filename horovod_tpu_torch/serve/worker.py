"""Replica worker process: one ServeEngine behind the fleet transport.

The port of ``horovod_tpu.serve.worker``. ``python -m
horovod_tpu_torch.serve.worker --socket S --rank R --heartbeat-dir D
[--device cuda|cpu]`` runs ONE
:class:`~horovod_tpu_torch.serve.engine.ServeEngine` as its own OS
process — the crash-isolation boundary: a replica that segfaults, OOMs,
or is SIGKILLed takes down exactly one worker, never the router or its
peers. On a one-card host every worker shares the card, each with its
own CUDA context. ``--bind host:port`` (instead of ``--socket``) serves
the same frame protocol over TCP — the multi-host placement: the
listener demands the fleet's shared secret (``HOROVOD_SECRET``; every
accepted connection passes the HMAC handshake before an RPC is served),
and liveness rides a heartbeat SEQUENCE in every ping/step/collect
reply instead of a file the router could not see.

**Wire init (the fleet's default).** With no ``--params``/``--config``
the worker starts with NOTHING from any filesystem: it binds, serves
the transfer RPCs (``put_config`` + ``push_begin``/``push_chunk``/
``push_commit`` — :mod:`~horovod_tpu_torch.serve.params_wire`),
assembles the versioned params artifact into its own private temp dir
with per-chunk CRCs, whole-artifact digest verify, and an atomic-rename
commit, and only THEN imports torch and builds the engine. The same
push RPCs later swap weights live (the fleet's zero-downtime rolling
update). ``--params P --config C`` (both together) is the standalone
file mode for running a worker by hand.

Two threads, one failure story:

* the **engine loop** (main thread) steps the engine whenever it has
  work, harvests terminal requests into the collect outbox, and
  touches the replica's heartbeat file at the END of each served tick
  (idle ticks included), so a ``stall:`` fault genuinely wedges this
  thread and ONLY the stale heartbeat + the fleet's
  :class:`~horovod_tpu_torch.elastic.supervisor.HealthWatchdog` catch
  it;
* the **RPC thread** serves the router's calls (``submit`` / ``step`` /
  ``collect`` / ``stats`` / ``drain`` / ``reset_metrics`` / ``fault`` /
  ``shutdown`` / ``ping``) over the framed protocol
  (:mod:`~horovod_tpu_torch.serve.transport`), sharing the engine under
  one lock. It stays responsive through an engine-loop stall — which
  routes a wedged replica to the watchdog (``stalled``) instead of an
  RPC deadline (``crashed``).

The socket is bound BEFORE ``import torch`` so the router's connect
succeeds early; the first RPCs then wait (inside their deadline) for
engine construction. A worker that dies during startup never binds,
never heartbeats — the router observes the connect failure plus the
reaped exit code and classifies ``crashed``. Under disaggregated pools
the ``kv_export_*`` RPCs ship a parked request's K/V pages out of this
worker and the ``kv_import_*`` RPCs admit another worker's into it
(:mod:`~horovod_tpu_torch.serve.kv_wire`).

**A tensor-parallel replica** (the pushed config's ``mesh`` shards
over ``tp`` > 1 ranks) is a world of its own: at engine build this
worker starts ``tp - 1`` follower processes and becomes rank 0, the
engine's controller (:mod:`~horovod_tpu_torch.serve.tp_replica`).
``--cards`` names each rank's card (``--device cuda``) and
``--group-timeout`` the group's timeout. The followers get the config
and the weights from this process over the group, never from a file;
every RPC still lands here, and the engine fans each data-plane action
(a step, a weight swap, a page export or import) out to them. They run
in this worker's process group and die with it.

Test hooks (environment): ``HVD_SERVE_WORKER_FAIL_START`` exits with
that code before binding; ``HVD_SERVE_WORKER_TORN_COLLECT_AFTER=N``
writes half of the reply after N collects and dies (the kill-mid-write
shape); ``HVD_SERVE_WORKER_INIT_TIMEOUT`` bounds the wire-init wait.

Timestamps: the router stamps every request's latency trail with its
OWN clock at collect time — worker-side clock stamps never cross the
process boundary.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from horovod_tpu_torch.run.driver import EXIT_CLEAN, EXIT_USAGE
from horovod_tpu_torch.serve import params_wire
from horovod_tpu_torch.serve.transport import serve_connection

# ------------------------------------------------------------------ params


def save_params(params, path: str) -> None:
    """Serialize a params tree (tensors or arrays) to one deterministic
    artifact file (:func:`params_wire.params_to_blob` — the container
    the wire transfer ships), committed with tmp + atomic rename so a
    crash mid-write never leaves a torn file."""
    blob = params_wire.params_to_blob(params)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_params(path: str):
    """Inverse of :func:`save_params`: host (CPU) tensors, which the
    engine moves to its device."""
    with open(path, "rb") as f:
        blob = f.read()
    return params_wire.params_from_blob(blob, device="cpu")


def _jsonable(x: Any) -> Any:
    """Stats payloads -> JSON-safe (numpy scalars/arrays demoted)."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


# ------------------------------------------------------------------- host


class WorkerHost:
    """The worker's two-thread engine host (see module docstring).

    ``secret`` (TCP placement) arms the shared-secret connect
    handshake: every accepted connection must answer the HMAC
    challenge before a single RPC frame is served — a TCP listener is
    network-reachable, unlike the filesystem-gated Unix socket.

    ``engine`` may be ``None`` (wire init): the RPC thread then serves
    the transfer RPCs immediately — they are pure file I/O against the
    worker's private artifact dir — while the main thread waits for
    config + a digest-verified params artifact before paying the heavy
    torch import and the engine build (:meth:`attach_engine`). Engine-facing
    RPCs arriving in that window wait for the engine inside their own
    deadline (the established first-RPC-after-spawn discipline).

    Every call that touches the device holds the one engine lock: the
    engine thread captures its lane as a CUDA graph inside
    ``engine.step()``, and a CUDA call from the RPC thread during a
    capture would break it. ``device`` is where a pushed artifact's
    weights land when they replace the engine's."""

    def __init__(self, engine, heartbeat=None, secret=None, *,
                 params_version: int = 0,
                 params_sha: Optional[str] = None):
        self.engine = engine
        self.heartbeat = heartbeat
        self._secret = secret
        #: Versioned-weights bookkeeping: which artifact this worker's
        #: engine decodes with (file mode stamps it at startup; wire
        #: init and rolling updates stamp it at push_commit). The sha
        #: is the fleet's digest-verify handle.
        self._params_version = params_version
        self._params_sha = params_sha
        #: Transfer state (wire init + rolling updates).
        self._assembler = None
        self._artifact_dir: Optional[str] = None
        self._pending_config: Optional[Dict] = None
        self._committed_path: Optional[str] = None
        self._engine_ready = threading.Event()
        if engine is not None:
            self._engine_ready.set()
        self._init_ready = threading.Event()
        #: Transport liveness channel: bumped once per engine-loop
        #: iteration (idle ticks included — "nothing to do" is not
        #: "wedged"), reported in every ping/step/collect reply so a
        #: router that cannot see this machine's heartbeat FILE can
        #: age the same signal off the wire.
        self._hb_seq = 0
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        #: router rid -> the ENGINE's Request (the worker's own rids
        #: never cross the wire).
        self._requests: Dict[int, Any] = {}
        #: Disaggregated-serving transfer state, keyed by router rid:
        #: prefill-side senders (exported blob + manifest) and
        #: decode-side receivers (assembler + the pending Request,
        #: engine-admitted only at commit).
        self._kv_senders: Dict[int, Any] = {}
        self._kv_receivers: Dict[int, Any] = {}
        self._terminal: List[Dict] = []
        self._ticks = 0
        self._stall_pending: Optional[Dict] = None
        self._slow = 1.0
        self._collects = 0
        self._last_hb = 0.0
        #: The tensor-parallel replica's world (tp_replica.TpWorld), or
        #: None for a one-rank engine.
        self.tp_world = None
        #: Seconds between an idle controller's keepalives to its
        #: followers (set with the world).
        self.keepalive_s = 0.0
        torn = os.environ.get("HVD_SERVE_WORKER_TORN_COLLECT_AFTER")
        #: test hook: after N collect responses, write HALF the next
        #: collect reply frame and die — the deterministic
        #: kill-mid-write shape the codec/fuzz pin exercises e2e.
        self._torn_after = int(torn) if torn else None

    # ------------------------------------------------- engine loop

    def serve_loop(self) -> None:
        last_action = time.monotonic()
        while not self._shutdown.is_set():
            with self._lock:
                stall, self._stall_pending = self._stall_pending, None
            if stall is not None:
                secs = stall.get("secs")
                if secs is None:
                    # A genuine wedge: the engine thread stops stepping
                    # and stops heartbeating, forever. Only SIGKILL (the
                    # watchdog's, or close()'s escalation) — or an
                    # explicit shutdown RPC — ends it.
                    while not self._shutdown.is_set():
                        time.sleep(1.0)
                    break
                time.sleep(float(secs))
            t0 = time.perf_counter()
            with self._lock:
                progressed = self.engine.step()
                if progressed:
                    self._ticks += 1
                self._harvest_locked()
            self._hb_seq += 1
            if progressed and self._slow > 1.0:
                dt = time.perf_counter() - t0
                if dt > 0:
                    time.sleep((self._slow - 1.0) * dt)
            if self.heartbeat is not None:
                # END of the served tick (idle ones included): the
                # fleet's liveness cadence, stamped by the worker
                # itself — rate-limited to 50 ms so a fast/idle loop
                # is not ~500 file writes/s for zero information (the
                # watchdog only needs sub-timeout freshness; a long
                # tick, e.g. a compile, always ends with a touch).
                now = time.monotonic()
                if now - self._last_hb >= 0.05:
                    self.heartbeat.touch(self._ticks)
                    self._last_hb = now
            if progressed:
                last_action = time.monotonic()
            elif self.tp_world is not None and \
                    time.monotonic() - last_action >= self.keepalive_s:
                # Followers wait for the next action inside the group's
                # timeout: an idle controller tells them it lives.
                with self._lock:
                    self.engine.keepalive()
                last_action = time.monotonic()
            if not progressed:
                time.sleep(0.002)

    def _harvest_locked(self) -> None:
        eng = self.engine
        for lst in (eng.finished, eng.timed_out, eng.evicted,
                    eng.scheduler.rejected):
            for req in lst:
                rid = getattr(req, "_router_rid", None)
                if rid is None:
                    continue   # not router-owned (defensive)
                self._terminal.append(self._serialize(rid, req))
                self._requests.pop(rid, None)
            lst.clear()

    @staticmethod
    def _serialize(rid: int, req) -> Dict:
        return {
            "rid": int(rid),
            "state": req.state,
            "output": [int(t) for t in req.output],
            "prefill_pos": int(req.prefill_pos),
            "generated_len": len(req.generated),
            "evictions": int(req.evictions),
            # Prefix-cache stamps (0 when caching is off) — the router
            # mirror needs them for the redispatch-meets-prefix
            # accounting; readers must tolerate their absence (stub
            # workers and pre-prefix workers never send them).
            "prefix_hit_tokens": int(getattr(req, "prefix_hit_tokens",
                                             0)),
            "prefix_hit_pages": int(getattr(req, "prefix_hit_pages",
                                            0)),
            "reject_reason": req.reject_reason,
            "retry_after": req.retry_after,
        }

    # --------------------------------------------------- wire init

    def attach_engine(self, engine, heartbeat=None, tp_world=None,
                      group_timeout: float = 0.0) -> None:
        """Hand the freshly-built engine to the host (wire init: the
        main thread builds it once config + params have arrived and
        verified). Unblocks every engine-facing RPC waiting in
        :meth:`_require_engine`. ``tp_world`` is a tensor-parallel
        replica's world, whose followers get a keepalive every quarter
        of ``group_timeout`` while the engine idles."""
        self.tp_world = tp_world
        self.keepalive_s = group_timeout / 4
        self.engine = engine
        if heartbeat is not None:
            self.heartbeat = heartbeat
        self._engine_ready.set()

    def wait_init(self, timeout: float) -> bool:
        """Main-thread wait (wire init) for config + a committed params
        artifact; False on timeout or shutdown-before-init."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._shutdown.is_set():
                return False
            if self._init_ready.wait(0.25):
                return True
        return False

    @property
    def init_config(self) -> Optional[Dict]:
        return self._pending_config

    @property
    def init_params_path(self) -> Optional[str]:
        return self._committed_path

    def _require_engine(self):
        """Engine-facing RPCs block here until the engine exists (the
        wire-init window / the post-spawn torch import and engine
        build). The CALLER's
        deadline is the real bound; this local one only turns a worker
        whose engine can never come up into a typed remote error
        instead of a forever-parked RPC thread."""
        if not self._engine_ready.wait(600.0):
            raise RuntimeError(
                "engine not initialized (no config/params pushed?)")
        return self.engine

    def _ensure_artifact_dir(self) -> str:
        if self._artifact_dir is None:
            # Worker-private, never shared: the whole point of the wire
            # transfer is that no other host/process reads this.
            self._artifact_dir = tempfile.mkdtemp(
                prefix="hvd-worker-params-")
        return self._artifact_dir

    # -------------------------------------------------- RPC thread

    def handle(self, method: str, params: Dict) -> Any:
        fn = getattr(self, "_rpc_" + method, None)
        if fn is None or not method:
            raise ValueError(f"unknown RPC method {method!r}")
        return fn(params)

    def _rpc_ping(self, p: Dict) -> Dict:
        return {"pid": os.getpid(), "ticks": self._ticks,
                "hb": self._hb_seq,
                "params_version": self._params_version or None,
                "params_sha256": self._params_sha,
                "tp": (self.tp_world.describe()
                       if self.tp_world is not None else None),
                **self._decode_evidence()}

    def _rpc_rank_counters(self, p: Dict) -> Dict:
        """Every rank's counters (``ServeEngine.rank_counters``: pid,
        lane ticks, K4 wrapper calls, lane captures and replays): a
        tensor-parallel replica's followers take part over the group."""
        self._require_engine()
        with self._lock:
            return {"ranks": self.engine.rank_counters()}

    def _decode_evidence(self) -> Dict:
        """How this process decoded: the paged-attention wrapper's launch
        count and the decode lane's graph captures and replays. Host
        counters only (no device call, no import: a ping during wire
        init must not load torch); None before the engine exists."""
        pa = sys.modules.get("horovod_tpu_torch.ops.paged_attention")
        graph = (getattr(self.engine, "lane_graphs", None) or {}).get(False)
        return {
            "decode_launches": (pa.paged_attention_decode.launches
                                if pa is not None else None),
            "lane_captures": graph.captures if graph is not None else None,
            "lane_replays": graph.replays if graph is not None else None}

    # ------------------------------------------- transfer RPCs
    #
    # put_config + push_begin/push_chunk/push_commit: the wire-native
    # weight-distribution lane (serve/params_wire.py). These are the
    # ONLY RPCs the fleet may retry after a TransportError — chunk
    # writes are idempotent (same bytes at the same offset, contiguity
    # enforced, whole-artifact digest at commit), unlike submit.

    def _rpc_put_config(self, p: Dict) -> Dict:
        cfg = p.get("config")
        if not isinstance(cfg, dict):
            raise ValueError(f"put_config: expected a config mapping, "
                             f"got {type(cfg).__name__}")
        if self._engine_ready.is_set():
            if self._pending_config == dict(cfg):
                # Idempotent re-send: a wire-init retry whose previous
                # attempt lost only the REPLY (e.g. a commit acked
                # worker-side, torn on the way back) re-runs the whole
                # sequence — an identical config is a no-op, never a
                # spurious replica death out of the one retried lane.
                return {}
            raise ValueError(
                "put_config after engine construction — the engine "
                "geometry is fixed for a worker's lifetime (weights "
                "roll via push_*, geometry changes respawn)")
        self._pending_config = dict(cfg)
        self._maybe_init_ready()
        return {}

    def _rpc_push_begin(self, p: Dict) -> Dict:
        man = p.get("manifest")
        superseding = (
            isinstance(man, dict)
            and (man.get("version"), man.get("sha256"))
            != (self._params_version, self._params_sha))
        if self._committed_path is not None \
                and not self._engine_ready.is_set() and superseding:
            # A SUPERSEDING transfer (different version/digest) must
            # not land while the main thread is still building the
            # engine from the init artifact (it would prune the file
            # mid-load, or leave old weights under a new version
            # stamp) — wait the build out; the caller's RPC deadline
            # bounds us, exactly the first-step-after-spawn
            # discipline (size rpc_deadline above the engine build).
            # A re-push of the SAME artifact (a retry whose previous
            # attempt lost only the commit reply) proceeds
            # immediately: its bytes and commit are idempotent, so it
            # must never sit out the build burning the push budget.
            self._require_engine()
        asm = params_wire.ArtifactAssembler(self._ensure_artifact_dir())
        have = asm.begin(man)
        self._assembler = asm
        return {"have_bytes": have}

    def _rpc_push_chunk(self, p: Dict) -> Dict:
        if self._assembler is None:
            raise ValueError("push_chunk before push_begin")
        return {"have_bytes": self._assembler.write_chunk(p)}

    def _rpc_push_commit(self, p: Dict) -> Dict:
        asm = self._assembler
        if asm is None:
            raise ValueError("push_commit before push_begin")
        path, sha = asm.commit()
        version = int(asm.manifest["version"])
        self._assembler = None
        # One weight copy on disk, not one per roll: superseded
        # versions (full model artifacts) are pruned at commit.
        params_wire.prune_artifacts(self._ensure_artifact_dir(), path)
        if self._engine_ready.is_set():
            # Rolling update: the fleet drained this replica first, so
            # the engine is idle — decode the artifact to host tensors
            # here, then swap weights in place under the lock, between
            # steps (the copy to the card is a device call: never during
            # a capture). A busy engine raising here is the drift
            # signal, surfaced typed to the fleet.
            params = load_params(path)
            with self._lock:
                self.engine.update_params(params)
        else:
            self._committed_path = path
        self._params_version, self._params_sha = version, sha
        self._maybe_init_ready()
        return {"version": version, "sha256": sha}

    def _maybe_init_ready(self) -> None:
        if self._pending_config is not None \
                and self._committed_path is not None:
            self._init_ready.set()

    # ------------------------------------------- engine RPCs

    def _rpc_submit(self, p: Dict) -> Dict:
        from horovod_tpu_torch.serve.scheduler import make_request

        self._require_engine()
        with self._lock:
            eng = self.engine
            req = make_request(
                eng.config, eng.clock,
                np.asarray(p["prompt"], np.int32),
                int(p["max_new_tokens"]),
                temperature=float(p.get("temperature", 0.0)),
                top_k=int(p.get("top_k", 0)),
                eos_token=p.get("eos_token"),
                seed=int(p.get("seed", 0)),
                # reconstruct arrival in THIS process's clock so the
                # engine-side TTL sweep keeps the original deadline
                arrival=eng.clock() - float(p.get("age", 0.0)),
                ttl=p.get("ttl"))
            req._router_rid = int(p["rid"])
            # Disaggregated serving: a prefill-pool dispatch parks the
            # request in the engine's handoff bay at prefill completion
            # instead of decoding it here.
            req.prefill_only = bool(p.get("prefill_only", False))
            if eng.scheduler.submit(req):
                self._requests[int(p["rid"])] = req
                return {"accepted": True}
            # engine stamped the reject; report it inline (never also
            # via the outbox — the router owns the single record)
            if req in eng.scheduler.rejected:
                eng.scheduler.rejected.remove(req)
            return {"accepted": False,
                    "reject_reason": req.reject_reason,
                    "retry_after": req.retry_after}

    def _rpc_step(self, p: Dict) -> Dict:
        self._require_engine()
        with self._lock:
            eng = self.engine
            out = {"ticks": self._ticks,
                   "hb": self._hb_seq,
                   "free_slots": eng._free_slots(),
                   "occupancy": float(eng.cache.occupancy()),
                   "queue_len": len(eng.scheduler.queue),
                   "in_flight": eng.in_flight,
                   "idle": eng.idle,
                   # Disaggregated serving: router rids parked in the
                   # handoff bay, K/V pages ready to ship.
                   "handoff": [int(r._router_rid) for r in eng.handoff
                               if getattr(r, "_router_rid", None)
                               is not None]}
            # Prefix-cache snapshot (absent when caching is off — the
            # proxy, like every consumer, tolerates the missing key).
            ps = eng.prefix_stats()
            if ps is not None:
                out["prefix"] = {
                    "lookups": ps["lookups"], "hits": ps["hits"],
                    "tokens_hit": ps["tokens_hit"],
                    "entries": ps["entries"],
                    "pages_shared": ps["pages_shared"],
                }
            return out

    def _rpc_collect(self, p: Dict) -> Dict:
        since = p.get("since") or {}
        self._require_engine()
        with self._lock:
            self._harvest_locked()
            events, self._terminal = self._terminal, []
            progress = []
            for rid_s, n in since.items():
                req = self._requests.get(int(rid_s))
                if req is None:
                    continue   # terminal event already covers it
                progress.append({
                    "rid": int(rid_s),
                    "tokens": [int(t) for t in req.output[int(n):]],
                    "prefill_pos": int(req.prefill_pos),
                    "generated_len": len(req.generated),
                    # Live prefix stamps: the router mirror must see
                    # them BEFORE a crash-drain reads its baseline.
                    "prefix_hit_tokens": int(getattr(
                        req, "prefix_hit_tokens", 0)),
                    "prefix_hit_pages": int(getattr(
                        req, "prefix_hit_pages", 0)),
                })
        self._collects += 1
        return {"events": events, "progress": progress,
                "hb": self._hb_seq}

    def _rpc_stats(self, p: Dict) -> Dict:
        self._require_engine()
        with self._lock:
            return _jsonable(self.engine.stats())

    def _rpc_drain(self, p: Dict) -> Dict:
        self._require_engine()
        deadline = time.monotonic() + float(p.get("timeout", 5.0))
        while time.monotonic() < deadline:
            with self._lock:
                if self.engine.idle:
                    return {"idle": True}
            time.sleep(0.005)
        return {"idle": False}

    def _rpc_reset_metrics(self, p: Dict) -> Dict:
        self._require_engine()
        with self._lock:
            self.engine.reset_metrics()   # raises if not idle
            self._ticks = 0
        return {"ticks": 0}

    def _rpc_fault(self, p: Dict) -> Dict:
        # Deliberately NO _require_engine: fault arming only sets host
        # flags the serve loop consumes post-attach, and the fleet may
        # arm a fault in the same tick that wire-inits this worker —
        # waiting here would deadlock against the very thread whose
        # pushes make the engine ready.
        kind = p.get("kind")
        with self._lock:
            if kind == "stall":
                self._stall_pending = {"secs": p.get("secs")}
            elif kind == "slow":
                self._slow = float(p["factor"])
            else:
                raise ValueError(f"unknown fault kind {kind!r} (the "
                                 "kill edition is a real signal)")
        return {}

    # ------------------------------------- disaggregated KV transfer
    #
    # kv_export_* (prefill side) / kv_import_* (decode side): the KV
    # handoff lane (serve/kv_wire.py over serve/chunk_stream.py). The
    # SAME framing/CRC/resume discipline as the params push — but NOT
    # a retried lane: a TransportError mid-transfer takes the death
    # path (drain -> rebase_for_recompute -> requeue, at-most-once);
    # only a still-healthy pair resumes (begin returns have_bytes).
    # Export (a device-to-host copy of the pages) and the commit's
    # import (a host-to-device copy into the page tensors) hold the
    # engine lock: the engine thread may be capturing its lane.

    def _rpc_kv_export_begin(self, p: Dict) -> Dict:
        from horovod_tpu_torch.serve.kv_wire import KvSender

        eng = self._require_engine()
        rid = int(p["rid"])
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                raise ValueError(
                    f"kv_export_begin: rid {rid} is not live here "
                    "(expired, finished, or never dispatched)")
            # KeyError (typed over the wire) when not parked: the
            # request expired or finished before the fleet asked.
            blob = eng.export_handoff(req.rid)
        cb = int(p.get("chunk_bytes")
                 or params_wire.DEFAULT_CHUNK_BYTES)
        sender = KvSender(blob, rid, cb)
        self._kv_senders[rid] = sender
        return {"manifest": sender.manifest}

    def _rpc_kv_export_chunk(self, p: Dict) -> Dict:
        rid = int(p["rid"])
        sender = self._kv_senders.get(rid)
        if sender is None:
            raise ValueError(f"kv_export_chunk: no open export for "
                             f"rid {rid}")
        return {"chunk": sender.chunk(int(p["index"]))}

    def _rpc_kv_export_end(self, p: Dict) -> Dict:
        """Close one export. ``commit=True`` (the decode side ACKED its
        digest-verified import): release the parked request's pages and
        forget the rid WITHOUT a terminal event — ownership moved, the
        stream did not end. ``commit=False``: drop only the sender; the
        request stays parked for a retry or redispatch."""
        rid = int(p["rid"])
        self._kv_senders.pop(rid, None)
        if not p.get("commit", True):
            return {}
        self._require_engine()
        with self._lock:
            req = self._requests.pop(rid, None)
            if req is not None:
                self.engine.release_handoff(req.rid)
        return {}

    def _rpc_kv_import_begin(self, p: Dict) -> Dict:
        from horovod_tpu_torch.serve.kv_wire import KvReceiver
        from horovod_tpu_torch.serve.scheduler import make_request

        eng = self._require_engine()
        rid = int(p["rid"])
        r = p["req"]
        with self._lock:
            req = make_request(
                eng.config, eng.clock,
                np.asarray(r["prompt"], np.int32),
                int(r["max_new_tokens"]),
                temperature=float(r.get("temperature", 0.0)),
                top_k=int(r.get("top_k", 0)),
                eos_token=r.get("eos_token"),
                seed=int(r.get("seed", 0)),
                arrival=eng.clock() - float(r.get("age", 0.0)),
                ttl=r.get("ttl"))
            req._router_rid = rid
            # The prefill side already emitted these (normally just the
            # first token): they count against the budget and position
            # the sampler, and collect(since=N) never re-streams them.
            req.generated = [int(t) for t in r.get("generated", [])]
            req.output = list(req.generated)
        # A re-begin for the same rid reuses the receiver — the
        # assembled prefix survives for resume-from-offset.
        recv = self._kv_receivers.get(rid)
        if recv is None:
            recv = KvReceiver(rid)
            self._kv_receivers[rid] = recv
        recv.req = req
        return {"have_bytes": recv.begin(p["manifest"])}

    def _rpc_kv_import_chunk(self, p: Dict) -> Dict:
        rid = int(p["rid"])
        recv = self._kv_receivers.get(rid)
        if recv is None:
            raise ValueError(f"kv_import_chunk: no open import for "
                             f"rid {rid}")
        return {"have_bytes": recv.write_chunk(p["chunk"])}

    def _rpc_kv_import_commit(self, p: Dict) -> Dict:
        """Digest-verify the assembled blob and admit the request into
        THIS engine at its handoff position. The receiver is dropped
        only on SUCCESS — a failed admit (pages filled up since the
        router's check) keeps the assembled bytes, so a later retry
        re-commits without re-shipping."""
        rid = int(p["rid"])
        recv = self._kv_receivers.get(rid)
        if recv is None:
            raise ValueError(f"kv_import_commit: no open import for "
                             f"rid {rid}")
        blob = recv.commit()
        self._require_engine()
        with self._lock:
            self.engine.admit_prefilled(recv.req, blob)
            self._requests[rid] = recv.req
        del self._kv_receivers[rid]
        return {"accepted": True}

    def _rpc_kv_import_abort(self, p: Dict) -> Dict:
        recv = self._kv_receivers.pop(int(p["rid"]), None)
        if recv is not None:
            recv.abort()
        return {}

    def _rpc_shutdown(self, p: Dict) -> Dict:
        self._shutdown.set()
        # The engine thread may be genuinely wedged (a bounded stall
        # mid-sleep): guarantee exit shortly after the reply flushes,
        # through the taxonomy's clean code either way.
        timer = threading.Timer(0.5, os._exit, args=(EXIT_CLEAN,))
        timer.daemon = True
        timer.start()
        return {"pid": os.getpid()}

    # ---------------------------------------------- plumbing

    def _send_hook(self, sock: socket.socket, frame: bytes) -> bool:
        if self._torn_after is not None \
                and self._collects >= self._torn_after:
            sock.settimeout(5.0)
            sock.sendall(frame[:max(1, len(frame) // 2)])
            os._exit(1)   # die mid-write: the torn-frame crash shape
        return False

    def rpc_loop(self, server_sock: socket.socket) -> None:
        from horovod_tpu_torch.serve.transport import server_handshake

        while not self._shutdown.is_set():
            server_sock.settimeout(0.25)
            try:
                conn, _ = server_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                if self._secret:
                    # TCP listener: anything that routes to the port
                    # can connect — prove the fleet secret before a
                    # single RPC frame is served, drop otherwise.
                    if not server_handshake(
                            conn, self._secret,
                            time.monotonic() + 5.0):
                        continue
                serve_connection(conn, self.handle,
                                 should_stop=self._shutdown.is_set,
                                 send_hook=self._send_hook)


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    # Startup-failure test hook: before ANY heavy work, so the fleet
    # sees a worker that dies pre-bind, pre-heartbeat (classified
    # crashed, consumes restart budget).
    fail = os.environ.get("HVD_SERVE_WORKER_FAIL_START")
    if fail:
        print("serve.worker: HVD_SERVE_WORKER_FAIL_START set — "
              "exiting before startup", file=sys.stderr, flush=True)
        return int(fail)

    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve.worker",
        description="One serving-fleet replica worker process.")
    ap.add_argument("--socket", default="",
                    help="Unix-domain socket path to serve RPCs on "
                         "(the same-host 'process' transport)")
    ap.add_argument("--bind", default="",
                    help="TCP 'host:port' to listen on instead of a "
                         "unix socket (the multi-host 'tcp' "
                         "transport; port 0 = ephemeral). Requires "
                         "HOROVOD_SECRET in the environment — a TCP "
                         "listener is network-reachable, so every "
                         "connection must pass the shared-secret "
                         "handshake")
    ap.add_argument("--params", default="",
                    help="params artifact file (worker.save_params). "
                         "Omit BOTH --params and --config for wire "
                         "init: config + params then arrive over the "
                         "RPC wire (put_config + push_*) — the fleet's "
                         "default, no filesystem assumption")
    ap.add_argument("--config", default="",
                    help="path to the ServeConfig JSON (file mode; "
                         "see --params)")
    ap.add_argument("--params-version", type=int, default=1,
                    help="artifact version stamp for file mode (wire "
                         "init takes it from the pushed manifest)")
    ap.add_argument("--rank", type=int, default=0,
                    help="replica id (heartbeat file + logs)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the card, the "
                         "default) or cpu")
    ap.add_argument("--cards", default="",
                    help="a tensor-parallel replica's card for each rank, "
                         "comma-separated (--device cuda; default: every "
                         "rank on the device's card)")
    ap.add_argument("--group-timeout", type=float, default=300.0,
                    help="a tensor-parallel replica's group timeout in "
                         "seconds (its world's meeting and every "
                         "collective)")
    ap.add_argument("--heartbeat-dir", default="",
                    help="fleet heartbeat directory ('' = no beacon; "
                         "tcp workers normally run without one — "
                         "liveness rides the transport)")
    args = ap.parse_args(argv)
    if bool(args.socket) == bool(args.bind):
        ap.error("exactly one of --socket (unix) or --bind host:port "
                 "(tcp) is required")
    if bool(args.params) != bool(args.config):
        ap.error("--params and --config come together (file mode) or "
                 "not at all (wire init: both arrive over the RPC "
                 "wire)")

    # Bind BEFORE the heavy init: the router's connect succeeds as soon
    # as the process is alive; its first RPCs wait inside their own
    # deadline for the engine to finish constructing.
    secret = ""
    if args.bind:
        host, _, port_s = args.bind.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            print(f"serve.worker[{args.rank}]: --bind {args.bind!r} is "
                  "not host:port", file=sys.stderr, flush=True)
            return EXIT_USAGE
        secret = os.environ.get("HOROVOD_SECRET", "")
        if not secret:
            print(f"serve.worker[{args.rank}]: --bind needs "
                  "HOROVOD_SECRET in the environment — refusing to "
                  "serve an unauthenticated network listener",
                  file=sys.stderr, flush=True)
            return EXIT_USAGE
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((host or "0.0.0.0", port))
        except OSError as e:
            print(f"serve.worker[{args.rank}]: cannot bind "
                  f"{args.bind}: {e}", file=sys.stderr, flush=True)
            return EXIT_USAGE
        srv.listen(2)
        bound_port = srv.getsockname()[1]
        # Advertised-address resolution (run/network.py's offline-safe
        # fallback chain): which endpoint peers should dial when the
        # bind address is a wildcard.
        from horovod_tpu_torch.run.network import advertise_ip

        adv = host if host and host != "0.0.0.0" else advertise_ip()
        print(f"serve.worker[{args.rank}]: tcp listener on "
              f"{args.bind} (advertise {adv}:{bound_port})",
              file=sys.stderr, flush=True)
    else:
        try:
            os.unlink(args.socket)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(args.socket)
        except OSError as e:
            print(f"serve.worker[{args.rank}]: cannot bind "
                  f"{args.socket}: {e}", file=sys.stderr, flush=True)
            return EXIT_USAGE
        srv.listen(2)

    def _build_engine(cfg_kwargs, params_path):
        # The heavy half, shared by both modes: torch import + engine
        # construction. Runs AFTER the socket is bound, so the
        # router's connect always succeeds early. The kernels were
        # built by the fleet before the spawn: loading them here is a
        # cache hit, never a compile under the watchdog. Returns the
        # engine and a tensor-parallel replica's world (else None).
        from horovod_tpu_torch.serve.config import ServeConfig
        from horovod_tpu_torch.serve.engine import ServeEngine

        cfg = ServeConfig(**cfg_kwargs)
        if cfg.tp_degree > 1:
            from horovod_tpu_torch.serve.tp_replica import start_world

            world = start_world(
                cfg_kwargs, load_params(params_path), device=args.device,
                cards=([int(c) for c in args.cards.split(",")]
                       if args.cards else None),
                timeout=args.group_timeout)
            print(f"serve.worker[{args.rank}]: tensor-parallel world "
                  f"{world.describe()}", file=sys.stderr, flush=True)
            return world.engine, world
        return ServeEngine(load_params(params_path), cfg,
                           device=args.device), None

    from horovod_tpu_torch.elastic.signals import Heartbeat

    hb = Heartbeat(args.heartbeat_dir, rank=args.rank) \
        if args.heartbeat_dir else None

    if not args.params:
        # WIRE INIT: serve the transfer RPCs first (pure file I/O, no
        # torch), build the engine only once a digest-verified artifact
        # and the config have both arrived over the wire.
        host_loop = WorkerHost(None, None, secret=secret or None)
        rpc = threading.Thread(target=host_loop.rpc_loop, args=(srv,),
                               daemon=True,
                               name=f"serve-worker-rpc-{args.rank}")
        rpc.start()
        print(f"serve.worker[{args.rank}]: serving on "
              f"{args.bind or args.socket} (pid {os.getpid()}) — "
              "awaiting config + params over the wire",
              file=sys.stderr, flush=True)
        init_timeout = float(os.environ.get(
            "HVD_SERVE_WORKER_INIT_TIMEOUT", "600"))
        if not host_loop.wait_init(init_timeout):
            print(f"serve.worker[{args.rank}]: no config/params "
                  f"arrived within {init_timeout:g}s — exiting",
                  file=sys.stderr, flush=True)
            srv.close()
            return EXIT_USAGE
        engine, world = _build_engine(host_loop.init_config,
                                      host_loop.init_params_path)
        host_loop.attach_engine(engine, hb, world, args.group_timeout)
        print(f"serve.worker[{args.rank}]: engine up on params "
              f"v{host_loop._params_version} "
              f"(sha256 {(host_loop._params_sha or '')[:12]})",
              file=sys.stderr, flush=True)
    else:
        # FILE MODE (standalone / debugging): params + config from
        # disk, version stamped from the CLI, sha from the file bytes.
        with open(args.config) as f:
            cfg_kwargs = json.load(f)
        engine, world = _build_engine(cfg_kwargs, args.params)
        with open(args.params, "rb") as f:
            sha = params_wire.sha256_hex(f.read())
        host_loop = WorkerHost(engine, hb, secret=secret or None,
                               params_version=args.params_version,
                               params_sha=sha)
        host_loop.attach_engine(engine, hb, world, args.group_timeout)
        rpc = threading.Thread(target=host_loop.rpc_loop, args=(srv,),
                               daemon=True,
                               name=f"serve-worker-rpc-{args.rank}")
        rpc.start()
        print(f"serve.worker[{args.rank}]: serving on "
              f"{args.bind or args.socket} (pid {os.getpid()})",
              file=sys.stderr, flush=True)
    host_loop.serve_loop()
    if host_loop.tp_world is not None:
        host_loop.tp_world.close(host_loop._lock)
    srv.close()
    return EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
