"""Disaggregated prefill/decode serving: the KV handoff coordinator.

The port of ``horovod_tpu.serve.disagg``: host bookkeeping only (the
device work is the engines' export and import of pages).

``FleetConfig(pools={"prefill": P, "decode": D})`` splits the fleet
into two pools behind the existing router (replica ids ``0..P-1``
prefill, the rest decode; the mapping is positional and survives
relaunches). The fleet then stamps ``prefill_only=True`` on every
dispatch: a prefill replica runs the request's chunked prefill to
completion, emits the first token, and PARKS it in its engine's
handoff bay (:attr:`ServeEngine.handoff
<horovod_tpu_torch.serve.engine.ServeEngine.handoff>`) with the
finished KV pages held. Each fleet tick, :class:`DisaggCoordinator` sweeps the
prefill pool for parked requests and, for each, picks a decode
replica with the SAME policy the router uses for admission
(:func:`~horovod_tpu_torch.serve.router.pick_replica` over the decode
pool only: the existing load keys + prefix-affinity) and ships the
pages:

* **wire transports** (process/tcp): the worker RPC verbs
  ``kv_export_begin/chunk/end`` and ``kv_import_begin/chunk/commit``
  (:mod:`~horovod_tpu_torch.serve.kv_wire` over
  :mod:`~horovod_tpu_torch.serve.chunk_stream` — per-chunk crc32, whole-blob
  sha256 digest-verify at commit, resume-from-offset via
  ``import_begin``'s ``have_bytes``);
* **inproc**: the two engines directly, but through the SAME
  KvSender/KvReceiver chunk codec — ``kv_bytes_shipped`` and the
  framing checks mean the same thing on every transport.

Ownership moves exactly once, in this order: the decode side's
digest-verified ``commit`` admits the request into its engine at the
handoff position → the ROUTER's bookkeeping moves (``assigned`` lists,
``req.replica``, proxy mirrors) → the prefill side releases the pages
(``kv_export_end commit=True`` — no terminal event; the stream did
not end). The inproc lane swaps the last two steps (release BEFORE
admit): the Request object is shared between the engines, and
``admit_prefilled`` rewrites ``req.pages``/``page_table`` in place —
releasing after would free the decode side's live grant.

Failure modes are first-class and reuse shipped machinery — a KV
transfer is NEVER retried across a :class:`TransportError` (unlike
the params-push lane):

* **prefill side dies mid-transfer** (or a ``partition:`` netfault on
  its host tears the KV channel): ``_transport_death`` → the replica's
  ``assigned`` drains through ``rebase_for_recompute`` → requeue at
  the head, at-most-once; the decode side's partial import is aborted
  best-effort (its assembled bytes are dropped — a redispatch
  re-prefills anyway).
* **decode side dies mid-transfer**: its own death path; the request
  STAYS PARKED on the healthy prefill replica (pages held) and the
  next tick retries against another decode replica — the sender is
  dropped (``commit=False``) and re-created; the export is
  bit-identical by construction.
* **decode pool saturated / no eligible replica**: the request simply
  stays parked — no spin, no drop; parked requests count against the
  prefill replica's in-flight (so admission backpressure holds) and
  keep their TTL (the engine's deadline sweep covers the bay).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from horovod_tpu_torch.serve.kv_wire import KvReceiver, KvSender
from horovod_tpu_torch.serve.router import pick_replica
from horovod_tpu_torch.serve.transport import TransportError


def _log(msg: str) -> None:
    print(f"[disagg] {msg}", flush=True)


class DisaggCoordinator:
    """Per-fleet KV-handoff coordinator, invoked once per fleet tick (after
    every replica stepped — the handoff snapshots are fresh). Holds
    only transfer metrics and the one-shot test fault hook; all
    request/replica state lives in the fleet's own bookkeeping."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.transfers = 0
        self.kv_bytes_shipped = 0
        self.chunks_shipped = 0
        self.transfer_ms: List[float] = []
        #: transfer failures by side ("prefill"/"decode"), each one a
        #: replica-death incident routed through the fleet's machinery.
        self.failures: Dict[str, int] = {}
        #: One-shot deterministic fault hook for tests: "prefill" or
        #: "decode" makes the NEXT transfer die mid-chunk-loop on that
        #: side (synthetic TransportError into the genuine death
        #: path), exactly the shape a partition: netfault produces.
        self.fault_next_transfer: Optional[str] = None

    # ------------------------------------------------------------ pools

    def prefill_pool(self) -> List:
        return [r for r in self.fleet.replicas if r.role == "prefill"]

    def decode_pool(self) -> List:
        return [r for r in self.fleet.replicas if r.role == "decode"]

    # ------------------------------------------------------------- tick

    def step(self, now: float) -> int:
        """Sweep the prefill pool and ship every parked request a
        decode replica will take. Returns transfers completed (the
        fleet folds it into tick progress)."""
        moved = 0
        for prep in list(self.prefill_pool()):
            if not prep.healthy or prep.engine is None:
                continue
            for rid in list(self._handoff_rids(prep)):
                if not prep.healthy:
                    break   # a transfer failure killed it mid-sweep
                req = next((r for r in prep.assigned if r.rid == rid),
                           None)
                if req is None:
                    continue   # drained/expired between snapshots
                drep = pick_replica(self.decode_pool(), req,
                                    self.fleet._route_key(req))
                if drep is None:
                    continue   # decode pool busy/down: stays parked
                if self._transfer(prep, drep, req, now):
                    moved += 1
        return moved

    def _handoff_rids(self, rep) -> List[int]:
        if rep.transport == "inproc":
            return list(rep.engine.handoff_ready())
        return list(getattr(rep.engine, "handoff_rids", ()))

    # -------------------------------------------------------- transfer

    def _transfer(self, prep, drep, req, now: float) -> bool:
        t0 = time.perf_counter()
        if prep.transport == "inproc":
            ok = self._transfer_inproc(prep, drep, req, now)
        else:
            ok = self._transfer_wire(prep, drep, req, now)
        if ok:
            self.transfers += 1
            self.transfer_ms.append((time.perf_counter() - t0) * 1e3)
        return ok

    def _consume_fault(self, side: str) -> bool:
        if self.fault_next_transfer != side:
            return False
        self.fault_next_transfer = None
        return True

    def _record_failure(self, side: str) -> None:
        self.failures[side] = self.failures.get(side, 0) + 1

    def _move(self, prep, drep, req, now: float,
              streamed: int) -> None:
        """The at-most-once ownership move, in ROUTER bookkeeping: the
        request leaves the prefill replica's assigned list for the
        decode replica's, and (wire transports) the proxy mirrors
        move with it — the decode proxy starts collecting PAST the
        tokens the router already streamed (``streamed``), so the
        handoff token is never re-emitted."""
        prep.assigned = [r for r in prep.assigned if r is not req]
        drep.assigned.append(req)
        req.replica = drep.id
        if prep.transport != "inproc":
            pproxy, dproxy = prep.engine, drep.engine
            pproxy._by_rid.pop(req.rid, None)
            pproxy._streamed.pop(req.rid, None)
            pproxy._prefix_seen.pop(req.rid, None)
            dproxy._by_rid[req.rid] = req
            dproxy._streamed[req.rid] = streamed
            dproxy._prefix_seen[req.rid] = (0, 0)

    # ---------------------------------------------------- inproc lane

    def _transfer_inproc(self, prep, drep, req, now: float) -> bool:
        """Both engines in this process — same codec, same ordering
        discipline, except release-before-admit (see the module
        docstring: the Request object is SHARED)."""
        fleet = self.fleet
        peng, deng = prep.engine, drep.engine
        blob = peng.export_handoff(req.rid)
        sender = KvSender(blob, req.rid, fleet.fleet.push_chunk_bytes)
        recv = KvReceiver(req.rid)
        recv.begin(sender.manifest)
        tear_at = sender.num_chunks // 2
        for i in range(sender.num_chunks):
            if i == tear_at and self._consume_fault("prefill"):
                self._record_failure("prefill")
                _log(f"request {req.rid}: prefill replica {prep.id} "
                     "died mid-transfer (injected) — drain/requeue")
                fleet._kill_replica(prep, code=1, stalled=False,
                                    now=now)
                return False
            if i == tear_at and self._consume_fault("decode"):
                self._record_failure("decode")
                _log(f"request {req.rid}: decode replica {drep.id} "
                     "died mid-transfer (injected) — request stays "
                     f"parked on prefill replica {prep.id}")
                fleet._kill_replica(drep, code=1, stalled=False,
                                    now=now)
                return False
            recv.write_chunk(sender.chunk(i))
        verified = recv.commit()   # digest-verified, same as the wire
        self.kv_bytes_shipped += sender.total_bytes
        self.chunks_shipped += sender.num_chunks
        # SHARED Request: release the prefill side's pages BEFORE
        # admit rewrites req.pages/page_table with the decode grant.
        peng.release_handoff(req.rid)
        req.prefill_only = False
        try:
            deng.admit_prefilled(req, verified)
        except Exception as e:
            # Decode-side admit failed (pages filled since the
            # eligibility check): the prefill pages are already gone,
            # so take the shipped recovery path — rebase + requeue at
            # the head, at-most-once (exactly a drain of one request).
            self._record_failure("decode")
            _log(f"request {req.rid}: decode admit failed "
                 f"({type(e).__name__}: {e}) — rebase + requeue")
            self._requeue(prep, req, now)
            return False
        self._move(prep, drep, req, now, streamed=len(req.generated))
        return True

    def _requeue(self, prep, req, now: float) -> None:
        """One request's edition of the fleet drain: rebase
        generated-so-far into the prompt and requeue at the head
        (at-most-once — nothing already streamed is re-emitted)."""
        from horovod_tpu_torch.serve.scheduler import (RequestState,
                                                 rebase_for_recompute)

        fleet = self.fleet
        prep.assigned = [r for r in prep.assigned if r is not req]
        req.pages = []
        req.page_table = None
        fleet.tokens_recomputed_total += \
            req.prefill_pos + len(req.generated)
        if req.prefix_hits_at_drain is not None:
            fleet.redispatch_prefix_saved += max(
                0, req.prefix_hit_tokens - req.prefix_hits_at_drain)
        req.prefix_hits_at_drain = req.prefix_hit_tokens
        if rebase_for_recompute(req):
            req.state = RequestState.QUEUED
            req.requeued = True
            req.redispatches += 1
            fleet.queue.insert(0, req)
            fleet.redispatched_total += 1
        else:
            req.state = RequestState.FINISHED
            req.t_finish = now
            if req.t_admit is not None:
                fleet._service_samples.append(now - req.t_admit)
            fleet.finished.append(req)

    # ------------------------------------------------------- wire lane

    def _transfer_wire(self, prep, drep, req, now: float) -> bool:
        """Process/tcp transports: drive the worker KV verbs. Every
        TransportError routes into the throwing SIDE's death path —
        never a blind RPC retry (at-most-once would not survive one).
        A synthetic injected tear takes the same path, so tests pin
        the identical recovery shape a real partition produces."""
        fleet = self.fleet
        rid = req.rid
        pcli, dcli = prep.engine.client, drep.engine.client
        streamed = len(req.generated)
        try:
            m = pcli.call("kv_export_begin", {
                "rid": rid,
                "chunk_bytes": fleet.fleet.push_chunk_bytes,
            })["manifest"]
        except TransportError as e:
            self._prefill_died(prep, drep, rid, e, now)
            return False
        payload = {
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "eos_token": req.eos_token,
            "seed": int(req.seed),
            "age": max(0.0, now - req.arrival),
            "ttl": req.ttl,
            "generated": [int(t) for t in req.generated],
        }
        try:
            have = int(dcli.call("kv_import_begin", {
                "rid": rid, "manifest": m, "req": payload,
            })["have_bytes"])
        except TransportError as e:
            self._decode_died(prep, drep, rid, e, now)
            return False
        n = int(m["num_chunks"])
        start = have // int(m["chunk_bytes"])
        tear_at = max(start, start + (n - start) // 2)
        shipped = 0
        for i in range(start, n):
            try:
                if i == tear_at and self._consume_fault("prefill"):
                    raise TransportError(
                        "injected: prefill side torn mid-transfer")
                c = pcli.call("kv_export_chunk",
                              {"rid": rid, "index": i})["chunk"]
            except TransportError as e:
                self._prefill_died(prep, drep, rid, e, now)
                return False
            try:
                if i == tear_at and self._consume_fault("decode"):
                    raise TransportError(
                        "injected: decode side torn mid-transfer")
                dcli.call("kv_import_chunk",
                          {"rid": rid, "chunk": c})
            except TransportError as e:
                self._decode_died(prep, drep, rid, e, now)
                return False
            shipped += int(c["size"])
        try:
            dcli.call("kv_import_commit", {"rid": rid})
        except TransportError as e:
            self._decode_died(prep, drep, rid, e, now)
            return False
        # Committed on the decode side: the ownership move happens NOW
        # (router truth), before the prefill-side release — a release
        # failure past this point costs only the dead replica's pages.
        self.kv_bytes_shipped += shipped
        self.chunks_shipped += max(0, n - start)
        self._move(prep, drep, req, now, streamed=streamed)
        try:
            pcli.call("kv_export_end", {"rid": rid, "commit": True})
        except TransportError as e:
            # The request already lives on the decode side; the
            # prefill replica alone dies (its parked pages die with
            # its engine — nothing to leak).
            self._record_failure("prefill")
            fleet._transport_death(prep, e, now)
        return True

    def _prefill_died(self, prep, drep, rid, err, now: float) -> None:
        """Prefill-side transport failure: its death path drains the
        parked request (rebase + requeue, at-most-once); the decode
        side's partial import is aborted best-effort."""
        fleet = self.fleet
        self._record_failure("prefill")
        _log(f"request {rid}: prefill replica {prep.id} lost "
             f"mid-transfer ({type(err).__name__}) — drain/requeue")
        fleet._transport_death(prep, err, now)
        if drep.healthy and drep.engine is not None:
            try:
                drep.engine.client.call("kv_import_abort",
                                        {"rid": rid})
            except TransportError as e2:
                self._record_failure("decode")
                fleet._transport_death(drep, e2, now)

    def _decode_died(self, prep, drep, rid, err, now: float) -> None:
        """Decode-side transport failure: its death path runs; the
        request stays parked on the healthy prefill replica (pages
        held), whose sender is dropped — the next tick re-exports
        bit-identically toward another decode replica."""
        fleet = self.fleet
        self._record_failure("decode")
        _log(f"request {rid}: decode replica {drep.id} lost "
             f"mid-transfer ({type(err).__name__}) — request stays "
             f"parked on prefill replica {prep.id}")
        fleet._transport_death(drep, err, now)
        if prep.healthy and prep.engine is not None:
            try:
                prep.engine.client.call(
                    "kv_export_end", {"rid": rid, "commit": False})
            except TransportError as e2:
                self._record_failure("prefill")
                fleet._transport_death(prep, e2, now)

    # ---------------------------------------------------------- stats

    def reset_metrics(self) -> None:
        self.transfers = 0
        self.kv_bytes_shipped = 0
        self.chunks_shipped = 0
        self.transfer_ms = []
        self.failures = {}

    def stats(self) -> Dict:
        from horovod_tpu_torch.serve.metrics import percentile

        s = self.transfer_ms
        return {
            "pools": {"prefill": len(self.prefill_pool()),
                      "decode": len(self.decode_pool())},
            "transfers": self.transfers,
            "kv_bytes_shipped": self.kv_bytes_shipped,
            "chunks_shipped": self.chunks_shipped,
            "transfer_ms_p50": round(percentile(s, 50), 4) if s
            else None,
            "transfer_ms_p99": round(percentile(s, 99), 4) if s
            else None,
            "parked": sum(len(self._handoff_rids(r))
                          for r in self.prefill_pool()
                          if r.healthy and r.engine is not None),
            "failures": dict(self.failures),
        }


__all__ = ["DisaggCoordinator"]
