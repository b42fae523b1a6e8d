"""Fleet routing policy: least-loaded replica selection + the overload
hint.

The port's copy of ``horovod_tpu.serve.router``.

Pure functions over the fleet's replica objects — the router never
touches device arrays and holds no state of its own, so
:class:`~horovod_tpu_torch.serve.fleet.ServeFleet` (which owns the admission
queue and the replica lifecycle) is the single writer and these
policies are unit-testable in isolation.

Routing is least-loaded with a deliberate key order:

1. **free decode slots** (desc) — the resource a new request occupies
   first; a replica with idle lanes finishes new work soonest;
2. **page occupancy** (asc) — the eviction-pressure tiebreak: between
   two replicas with equal lanes, the one with more free KV pages is
   less likely to evict-recompute;
3. **dispatched-but-unfinished count** (asc) — breaks cold-start ties
   (all replicas idle) so a burst spreads round-robin instead of
   piling onto replica 0;
4. **replica id** — total order, so routing is deterministic for the
   bit-exactness pins.

With prefix caching on, a request carrying a route key (the stable
hash of its page-aligned prompt prefix — :func:`~horovod_tpu_torch.serve.
prefix.prefix_route_key`) ranks its **rendezvous weight** (desc)
AHEAD of all four: requests sharing a prefix land on the replica that
already holds its pages — one cold prefill per unique prefix per
REPLICA — and the load keys only break exact-weight ties.
Highest-random-weight hashing keeps the affinity stateless and
deterministic: when the prefix's home replica dies (or is saturated —
it simply drops out of the eligible set), the next-ranked survivor
becomes the home, with no routing table to migrate.

A replica is only *eligible* when healthy and when the request fits
under its in-flight limit right now — the router holds backlog at the
FLEET level (one queue to shed from, cheaper redispatch, better
balancing) instead of deep-queueing inside replicas.
"""

from __future__ import annotations

from typing import Optional, Sequence


def replica_load(rep) -> dict:
    """One replica's routing-relevant load (also the ``stats()``
    per-replica cell): free decode slots, page occupancy, and the
    dispatched-but-unfinished request count."""
    eng = rep.engine
    if eng is None:
        return {"free_slots": 0, "occupancy": 1.0,
                "in_flight": len(rep.assigned)}
    return {
        "free_slots": eng._free_slots(),
        "occupancy": eng.cache.occupancy(),
        "in_flight": len(rep.assigned),
    }


def eligible(rep, req) -> bool:
    """May ``req`` be dispatched to ``rep`` right now? Healthy,
    INITIALIZED (a wire-init worker has no weights until its first
    params push commits — ``rep.version`` is None until then),
    ACCEPTING (a replica mid-rolling-update is draining: routing new
    work to it would make the drain a livelock), VERSION-compatible
    (a request already streaming under params version V may only
    continue on a replica serving exactly V — the version pin that
    makes a mid-stream weight mix impossible), the geometry admits the
    request at all, there is in-flight headroom
    (dispatched-but-unfinished stays under the engine's in-flight
    limit, so the router never deep-queues into a replica), and the
    engine's OWN bounded queue — a standalone-engine knob the fleet
    config may still carry — has room. The last check matters: an
    engine-side queue reject is TERMINAL, while the router's contract
    is that a backlogged request WAITS at the fleet head until a
    replica frees up."""
    if not rep.healthy or rep.engine is None:
        return False
    if getattr(rep, "version", 1) is None \
            or not getattr(rep, "accepting", True):
        return False
    req_version = getattr(req, "version", None)
    if req_version is not None and rep.version != req_version:
        return False
    eng = rep.engine
    if not eng.cache.fits(req.prompt_len, req.max_new_tokens):
        return False
    if len(rep.assigned) >= eng.config.in_flight_limit:
        return False
    c = eng.config
    return not c.max_queue or len(eng.scheduler.queue) < c.max_queue


def pick_replica(replicas: Sequence, req,
                 route_key: Optional[str] = None) -> Optional[object]:
    """The least-loaded eligible replica for ``req`` (None = every
    replica is down or saturated; the fleet queue's head WAITS — no
    skip — preserving arrival order the same way the scheduler's
    reserve admission does). ``route_key`` (prefix caching on, prompt
    at least one full page) ranks the rendezvous weight ahead of the
    load keys — see the module docstring's key-order rationale."""
    from horovod_tpu_torch.serve.prefix import rendezvous_rank

    candidates = [r for r in replicas if eligible(r, req)]
    if not candidates:
        return None
    loads = {r.id: replica_load(r) for r in candidates}

    def load_key(r):
        return (-loads[r.id]["free_slots"],
                loads[r.id]["occupancy"],
                loads[r.id]["in_flight"],
                r.id)

    if route_key is None:
        return min(candidates, key=load_key)
    return min(candidates, key=lambda r: (
        (-rendezvous_rank(route_key, r.id),) + load_key(r)))


def retry_after_hint(backlog: int, healthy_slots: int,
                     service_samples: Sequence[float],
                     floor: float) -> float:
    """Advisory seconds-until-retry for an overloaded rejection.

    Little's-law flavored: the backlog ahead of the client, divided by
    the fleet's current parallel service capacity, times the observed
    mean request service time (admit -> finish). With no finished
    requests yet (cold start) the floor alone is returned — an honest
    "soon" rather than a made-up number."""
    if not service_samples or healthy_slots < 1:
        return floor
    mean_service = sum(service_samples) / len(service_samples)
    return max(floor, (backlog + 1) * mean_service / healthy_slots)
