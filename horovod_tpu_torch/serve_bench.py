"""Serving bench lane of the port: ``python -m horovod_tpu_torch.serve_bench``.

The single-engine half of the JAX package's ``tools/serve_bench.py``:
open-loop Poisson load over one continuous-batching
:class:`~horovod_tpu_torch.serve.ServeEngine`, printing ONE JSON record
with generated tokens/s, p50/p99 time-to-first-token, p50/p99 per-token
latency and page occupancy, beside the card's name and power limit.

Arrivals are drawn up front from a Poisson process (exponential gaps at
``--rate``) and requests enter the engine when the wall clock passes
their arrival time, so a saturated engine pays queueing delay in TTFT.
Every lane warms its engine (and, on the card, captures its lane) with
one short request before the measured window.

Modes (the JAX tool's flags and defaults, one A/B per record):

* (default) continuous batching; ``--static`` the static-batching
  baseline (batches of ``--decode-slots`` that drain completely);
  ``--ab`` both on the identical workload;
* ``--attention gather|paged`` and ``--ab-attention``;
* ``--speculate K`` (``--draft-layers``, 0 = half the depth) and
  ``--ab-spec``: speculation off then on over the identical workload,
  aborting unless every greedy stream is bit-identical across the sides;
* ``--prefix`` and ``--ab-prefix``: prefix caching off then on over the
  many-users-one-system-prompt workload (``--system-prompt-len``, auto =
  4 pages), aborting unless the streams are identical, exactly one
  prefill is cold, and the cached side saved prefill tokens;
* ``--capture on|off`` (the port's own): the engine's lane as a CUDA
  graph replay (the engine's default) or eager, for an A/B across two
  records;
* ``--fleet N``: N replicas behind the fault-tolerant router
  (:class:`~horovod_tpu_torch.serve.ServeFleet`), placed by
  ``--fleet-transport inproc|process|tcp`` (``--fleet-hosts`` for tcp);
  ``--fault-plan`` (the serving fault dialect) and
  ``--rolling-update-at`` (a zero-downtime roll to version 2 of the same
  weights) run the fleet clean THEN faulted over the identical workload
  and abort unless every request that finished on both sides emitted
  the bit-identical greedy stream; ``--ab-prefix`` composes with the
  fleet (one cold prefill per prefix per replica);
* ``--pools P,D`` splits the fleet into a prefill pool of P replicas and
  a decode pool of D (disaggregated serving, ``serve/disagg.py``;
  implies ``--fleet P+D``), and ``serve.fleet`` stamps the ``disagg``
  block (transfers, bytes and chunks shipped, transfer p50/p99 ms,
  parked, failures); ``--ab-disagg`` runs the identical workload on a
  colocated fleet of the same size, then on the pools, aborting unless
  every greedy stream is bit-identical across the sides, and stamps
  ``serve.disagg``; with ``--fault-plan`` a third lane runs the pools
  faulted and pins its streams against the clean pools.

* ``--mesh dp=1,tp=N`` shards one engine over the N ranks of a
  ``torch.distributed`` world (``torchrun --nproc-per-node N``; a world
  the caller started is taken as it is): rank 0 runs the workload and
  prints the record, the others follow (``ServeEngine.follow``), each on
  its own card where the host has N, else all on the first card over
  gloo. ``--ab-tp`` runs the identical workload on a tp=1 engine (rank 0
  alone, the followers idle) and on the sharded one, aborting unless
  every greedy stream is bit-identical and the sharded side's
  ``kv_bytes_per_chip`` is at most ``1/tp`` of the run's single-chip
  bytes; ``serve.tp`` carries the degree, the per-chip bytes and the
  collectives' backend. Over NCCL (a card a rank) the sharded lane is
  captured on every rank as the tp=1 lane is; over gloo it cannot be:
  pass ``--capture off`` (``--ab-tp`` runs both sides with the same
  setting).

Every fleet record carries ``per_card``: each lane's tokens/s of the
card, the figure to hold against a single engine when replicas share a
card (a ``--mesh`` record too: its ranks share one card or take one
each). ``--pin-exact`` re-decodes every finished greedy request through
``models.parallel_lm.lm_decode``; ``--require-finished`` fails unless
every request finished (a fleet: unless every request not shed
finished).
On the CPU (``run(args, device="cpu")``, the tests) the numbers time
PyTorch's CPU kernels, not the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np

from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.bench import card_description
from horovod_tpu_torch.lm_common import add_model_args, build_params
from horovod_tpu_torch.models import parallel_lm as plm
from horovod_tpu_torch.serve import (FleetConfig, ServeConfig,
                                     ServeEngine, ServeFleet)
from horovod_tpu_torch.serve.config import LOCAL_HOSTS, parse_host_entry
from horovod_tpu_torch.serve.prefix import prefix_route_key


def make_workload(args, system_prompt_len: int = 0):
    """Pre-drawn open-loop workload: ``(arrival_offset_s, prompt,
    max_new)`` triples, arrivals the cumulative sum of exponential gaps.
    With ``system_prompt_len`` > 0 every prompt is one shared system
    prompt + a unique tail of ``--prompt-min/max`` tokens."""
    rng = np.random.default_rng(args.seed)
    system = rng.integers(0, args.vocab,
                          size=system_prompt_len).astype(np.int32)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                         size=args.requests))
    out = []
    for i in range(args.requests):
        lp = int(rng.integers(args.prompt_min, args.prompt_max + 1))
        n = int(rng.integers(args.new_min, args.new_max + 1))
        tail = rng.integers(0, args.vocab, size=lp).astype(np.int32)
        out.append((float(arrivals[i]), np.concatenate([system, tail]), n))
    return out


def _drain_arrivals(eng, pending, t0, now):
    while pending and pending[0][0] <= now - t0:
        arrival, prompt, n = pending.pop(0)
        eng.submit(prompt, n, arrival=t0 + arrival)


def _warm(eng, workload):
    """Warm the engine (on the card: its lane's warm-up step and capture)
    with a two-token request, then reset the metrics, so the measured
    window starts warm; shared by both runners so A/B sides warm
    alike."""
    eng.submit(workload[0][1][:2], 2)
    eng.run()
    eng.reset_metrics()


def _idle_wait(eng, pending, t0):
    time.sleep(min(0.001, max(0.0, pending[0][0] - (eng.clock() - t0))))


def run_continuous(params, cfg, workload, *, device, capture=True,
                   warm=True):
    """Continuous batching under the open-loop clock; returns the engine,
    drained (and, tensor-parallel, its followers released). A mesh makes
    the engine span ``tp_degree`` chips, so tokens/s/chip divides by
    it."""
    eng = ServeEngine(params, cfg, device=device, capture=capture,
                      chips=cfg.tp_degree)
    if warm:
        _warm(eng, workload)
    pending = sorted(workload, key=lambda w: w[0])
    t0 = eng._t_start = eng.clock()
    while pending or not eng.idle:
        _drain_arrivals(eng, pending, t0, eng.clock())
        if not eng.step() and pending:
            _idle_wait(eng, pending, t0)
    eng.close()
    return eng


def run_static(params, cfg, workload, *, device, capture=True, warm=True):
    """Static batching baseline: the same engine, with requests admitted
    in barrier batches of up to ``decode_slots``, each drained fully
    before the next is admitted."""
    eng = ServeEngine(params, cfg, device=device, capture=capture,
                      chips=cfg.tp_degree)
    if warm:
        _warm(eng, workload)
    pending = sorted(workload, key=lambda w: w[0])
    arrived = []
    t0 = eng._t_start = eng.clock()
    while pending or arrived or not eng.idle:
        while pending and pending[0][0] <= eng.clock() - t0:
            arrived.append(pending.pop(0))
        if eng.idle and arrived:
            batch, arrived = (arrived[:cfg.decode_slots],
                              arrived[cfg.decode_slots:])
            for arrival, prompt, n in batch:
                eng.submit(prompt, n, arrival=t0 + arrival)
            eng.run()        # the barrier: drain the whole batch
        elif pending:
            _idle_wait(eng, pending, t0)
        else:
            eng.run()
    eng.close()
    return eng


def tp_world(device: DeviceLike):
    """The ``torch.distributed`` world a ``--mesh`` run shards over, and
    this rank's device: the caller's world when one is up, else one
    started from the launcher's environment (``torchrun``) — NCCL with a
    card a rank where the host has one for each, else gloo with every
    rank on the first card (or the CPU when ``device`` says so). Returns
    ``(device, backend, cards)``."""
    import os

    import torch
    import torch.distributed as dist

    dev = resolve_device(device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    own = dev.type == "cuda" and dev.index is None and \
        torch.cuda.device_count() >= world
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local if own else 0)
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if own else "gloo",
                                init_method="env://")
    if not dist.is_initialized():
        return dev, None, 1 if dev.type == "cuda" else 0
    cards = dist.get_world_size() if own else (1 if dev.type == "cuda"
                                                else 0)
    return dev, dist.get_backend(), cards


def run_fleet(params, cfg, fleet_cfg, workload, *, device, fault_plan="",
              update_at=None, warm=True):
    """Open-loop Poisson load over a :class:`ServeFleet`; returns the
    fleet, drained, and its requests in arrival order (the index the
    clean-vs-faulted pin compares by). ``fault_plan`` is armed after the
    warm-up, so fire offsets count from the first measured step; percent
    ``at=`` forms resolve against the last arrival. ``update_at``
    (seconds from the measured start) triggers a rolling update to
    version 2 of the same weights, so streams stay comparable with the
    clean run; the loop runs until the roll completes."""
    fl = ServeFleet(params, cfg, fleet_cfg, device=device)
    try:
        if warm:
            # One short request per replica: the router spreads them, so
            # every replica warms (and captures) before the window.
            for _ in range(fleet_cfg.replicas):
                fl.submit(workload[0][1][:2], 2)
            fl.run()
            fl.reset_metrics()
        if fault_plan:
            fl.arm_fault_plan(fault_plan,
                              horizon=max(w[0] for w in workload))
        pending = sorted(workload, key=lambda w: w[0])
        reqs = []
        t0 = fl._t_start = fl.clock()
        updated = update_at is None
        while pending or not fl.idle or not updated or fl.update_active:
            if not updated and fl.clock() - t0 >= update_at:
                fl.update_params(params)
                updated = True
            while pending and pending[0][0] <= fl.clock() - t0:
                arrival, prompt, n = pending.pop(0)
                reqs.append(fl.submit(prompt, n, arrival=t0 + arrival))
            if not fl.step():
                if pending:
                    time.sleep(min(0.001, max(0.0, pending[0][0]
                                              - (fl.clock() - t0))))
                else:
                    time.sleep(0.001)   # a stall or backoff: let time pass
    except BaseException:
        fl.close()
        raise
    return fl, reqs


def pin_redispatch_exact(clean_reqs, faulted_reqs):
    """The drain/redispatch pin: every request that finished on BOTH the
    clean and the faulted fleet (same workload index) emitted the
    bit-identical greedy stream — tokens emitted before a kill were
    never re-emitted nor diverged from. Returns the pairs compared."""
    compared = 0
    for i, (rc, rf) in enumerate(zip(clean_reqs, faulted_reqs)):
        if rc.temperature > 0 or rc.state != "finished" \
                or rf.state != "finished":
            continue
        if rc.output != rf.output:
            raise SystemExit(f"REDISPATCH PIN FAILED: request #{i} "
                             f"clean={rc.output} faulted={rf.output}")
        compared += 1
    return compared


def pin_sides(a_reqs, b_reqs, label):
    """The A/B exactness abort: the i-th submitted request must emit the
    bit-identical greedy stream on both sides (the same workload, so the
    same prompts). Returns the pairs compared."""
    if len(a_reqs) != len(b_reqs):
        raise SystemExit(f"{label} PIN FAILED: {len(a_reqs)} requests on "
                         f"one side, {len(b_reqs)} on the other")
    compared = 0
    for i, (ra, rb) in enumerate(zip(a_reqs, b_reqs)):
        if list(ra.prompt[:ra.orig_prompt_len]) != \
                list(rb.prompt[:rb.orig_prompt_len]):
            raise SystemExit(f"{label} PIN FAILED: request #{i} prompts "
                             "differ across sides")
        if ra.temperature > 0 or ra.state != "finished" \
                or rb.state != "finished":
            continue
        if ra.output != rb.output:
            raise SystemExit(f"{label} PIN FAILED: request #{i} "
                             f"{ra.output} vs {rb.output}")
        compared += 1
    if not compared:
        raise SystemExit(f"{label} PIN FAILED: no greedy pairs finished "
                         "on both sides")
    return compared


def pin_disagg_sides(colo_reqs, dis_reqs):
    """The ``--ab-disagg`` exactness abort: the i-th submitted request
    must emit the bit-identical greedy stream on the colocated fleet and
    on the disaggregated pools — the KV handoff ships the SAME pages the
    prefill produced, so not one token may move. Returns pairs
    compared."""
    if len(colo_reqs) != len(dis_reqs):
        raise SystemExit(
            f"DISAGG AB PIN FAILED: {len(colo_reqs)} requests "
            f"colocated vs {len(dis_reqs)} disaggregated")
    compared = 0
    for i, (rc, rd) in enumerate(zip(colo_reqs, dis_reqs)):
        if list(rc.prompt[:rc.orig_prompt_len]) != \
                list(rd.prompt[:rd.orig_prompt_len]):
            raise SystemExit(
                f"DISAGG AB PIN FAILED: request #{i} prompts differ "
                "across sides (workload must be identical)")
        if rc.temperature > 0 or \
                rc.state != "finished" or rd.state != "finished":
            continue
        if rc.output != rd.output:
            raise SystemExit(
                f"DISAGG AB PIN FAILED: request #{i} "
                f"colocated={rc.output} disagg={rd.output}")
        compared += 1
    if not compared:
        raise SystemExit("DISAGG AB PIN FAILED: no greedy pairs "
                         "finished on both sides — nothing compared")
    return compared


def pin_prefix_cold(reqs, page_size, label):
    """The ``--ab-prefix`` efficiency pin: among the finished requests
    sharing a matchable prefix on one replica (a single engine is one
    replica, ``Request.replica`` None), EXACTLY ONE paid a cold prefill
    (``prefix_hit_tokens == 0``). Holds deterministically because each
    engine admits through one prefill lane: a prefix-mate is matched
    only after the first one's prefill indexed its pages. Returns
    ``(unique_prefixes, cold_prefills)``."""
    groups = {}
    for r in reqs:
        if r.state != "finished":
            continue
        key = prefix_route_key(r.prompt[:r.orig_prompt_len], page_size)
        if key is not None:
            groups.setdefault((key, r.replica), []).append(r)
    cold_total = 0
    for (key, home), grp in sorted(groups.items(), key=str):
        cold = sum(1 for r in grp if r.prefix_hit_tokens == 0)
        if cold != 1:
            raise SystemExit(
                f"PREFIX COLD PIN FAILED ({label}): {cold} cold "
                f"prefill(s) for prefix {key[:12]}"
                + ("" if home is None else f" on replica {home}")
                + f" ({len(grp)} requests; want exactly 1)")
        cold_total += cold
    return len({k for k, _ in groups}), cold_total


def pin_exact(params, eng, device):
    """Every finished greedy request must match its own ``lm_decode``."""
    for req in eng.finished:
        if req.temperature > 0 or not req.output:
            continue
        prompt = req.prompt[:req.orig_prompt_len]
        ref = plm.lm_decode(params, prompt[None], len(req.output),
                            device=device)[0].tolist()
        if req.output != ref:
            raise SystemExit(f"EXACTNESS PIN FAILED: request {req.rid} "
                             f"engine={req.output} lm_decode={ref}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve_bench",
        description="Open-loop serving bench of one ServeEngine.")
    add_model_args(ap)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--prompt-min", type=int, default=64)
    ap.add_argument("--prompt-max", type=int, default=256)
    ap.add_argument("--new-min", type=int, default=32)
    ap.add_argument("--new-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="0 = auto: worst case for the in-flight limit")
    ap.add_argument("--decode-slots", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--policy", choices=("fcfs", "sjf"), default="fcfs")
    ap.add_argument("--slo", choices=("latency", "balanced", "throughput"),
                    default="balanced")
    ap.add_argument("--admission", choices=("reserve", "lazy"),
                    default="reserve")
    ap.add_argument("--attention", choices=("gather", "paged"),
                    default="gather")
    ap.add_argument("--ab-attention", action="store_true")
    ap.add_argument("--speculate", type=int, default=0,
                    help="speculative window k (0 = off)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers of the layer-skip draft (0 = half)")
    ap.add_argument("--ab-spec", action="store_true")
    ap.add_argument("--prefix", action="store_true")
    ap.add_argument("--ab-prefix", action="store_true")
    ap.add_argument("--system-prompt-len", type=int, default=-1,
                    help="-1 = auto: 4 pages under --ab-prefix, else 0")
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--capture", choices=("on", "off"), default="on",
                    help="the engine's lane as a CUDA graph replay (on) "
                         "or eager (off)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="N replicas behind the fault-tolerant router "
                         "(0 = a single engine)")
    ap.add_argument("--fleet-transport", default="inproc",
                    choices=("inproc", "process", "tcp"),
                    help="replica placement: engines in this process, "
                         "one worker process each over a Unix socket, "
                         "or workers over TCP")
    ap.add_argument("--fleet-hosts", default="",
                    help="comma-separated 'host[:port]' placement for "
                         "--fleet-transport tcp (empty = loopback)")
    ap.add_argument("--fleet-rpc-deadline", type=float, default=60.0,
                    help="per-RPC deadline seconds (wire transports)")
    ap.add_argument("--fault-plan", default="",
                    help="serving fault plan, e.g. "
                         "'kill:replica=1,at=40%%': runs clean THEN "
                         "faulted and pins the streams identical")
    ap.add_argument("--rolling-update-at", default="",
                    help="roll the fleet to version 2 of the same "
                         "weights at this offset (seconds, '2.5s' or "
                         "'50%%' of the arrival horizon) in the faulted "
                         "lane")
    ap.add_argument("--fleet-push-chunk-bytes", type=int, default=1 << 20,
                    help="params-transfer chunk size (wire transports)")
    ap.add_argument("--fleet-push-retries", type=int, default=2,
                    help="resume-retries per params push")
    ap.add_argument("--fleet-max-restarts", type=int, default=2,
                    help="fleet-wide replica relaunch budget")
    ap.add_argument("--fleet-watchdog-timeout", type=float, default=0.0,
                    help="stale-heartbeat watchdog seconds (0 = off; "
                         "stall: plans need it)")
    ap.add_argument("--fleet-max-queue", type=int, default=0,
                    help="router queue bound (0 = unbounded)")
    ap.add_argument("--fleet-backoff", type=float, default=0.05,
                    help="relaunch backoff base (doubles per attempt)")
    ap.add_argument("--pools", default="",
                    help="disaggregated prefill/decode pools as 'P,D' "
                         "(replica ids 0..P-1 prefill, the rest "
                         "decode); implies --fleet P+D")
    ap.add_argument("--ab-disagg", action="store_true",
                    help="run colocated then disaggregated on the "
                         "identical workload; abort unless every "
                         "greedy stream is bit-identical; stamp "
                         "serve.disagg (requires --pools)")
    ap.add_argument("--mesh", default="",
                    help="ServeConfig.mesh: shard one engine over the "
                         "ranks of a torch.distributed world, e.g. "
                         "'dp=1,tp=4' under torchrun --nproc-per-node 4 "
                         "(heads, MLP features and vocab sharded; K/V "
                         "pages head-sharded); per-chip metrics divide "
                         "by the tp degree. Empty = unsharded")
    ap.add_argument("--ab-tp", action="store_true",
                    help="run the IDENTICAL workload unsharded (tp=1, "
                         "rank 0 alone) then TP-sharded over --mesh; "
                         "abort unless every greedy stream is "
                         "bit-identical and the sharded side's "
                         "kv_bytes_per_chip <= 1/tp of the single-chip "
                         "bytes; stamp serve.tp")
    ap.add_argument("--pin-exact", action="store_true")
    ap.add_argument("--require-finished", action="store_true")
    return ap


def _validate(ap, args) -> None:
    """The JAX tool's argument checks for the single-engine modes
    (``ap.error``: exit code 2)."""
    if args.layers < 1 or args.d_model % args.heads:
        ap.error("need --layers >= 1 and --d-model divisible by --heads")
    if args.requests < 1 or args.rate <= 0:
        ap.error("--requests must be >= 1 and --rate > 0")
    if args.prompt_min < 1 or args.prompt_max < args.prompt_min or \
            args.new_min < 1 or args.new_max < args.new_min:
        ap.error("need 1 <= prompt-min <= prompt-max and "
                 "1 <= new-min <= new-max")
    if args.ab_attention and (args.ab or args.static):
        ap.error("--ab-attention is exclusive with --ab/--static (one A/B "
                 "per record)")
    if args.ab_prefix and (args.ab or args.static or args.ab_attention):
        ap.error("--ab-prefix is exclusive with --ab/--static/"
                 "--ab-attention (one A/B per record)")
    if args.ab_prefix and args.prefix:
        ap.error("--ab-prefix runs both prefix sides itself; drop --prefix")
    if args.speculate < 0:
        ap.error("--speculate must be >= 0 (0 = off)")
    if args.draft_layers and not args.speculate:
        ap.error("--draft-layers sizes the speculation draft — it "
                 "requires --speculate K")
    if args.ab_spec:
        if args.ab or args.static or args.ab_attention or args.ab_prefix:
            ap.error("--ab-spec is exclusive with --ab/--static/"
                     "--ab-attention/--ab-prefix (one A/B per record)")
        if args.speculate < 1:
            ap.error("--ab-spec compares speculation off against on — it "
                     "requires --speculate K with K >= 1")
    if args.ab_tp:
        if args.ab or args.static or args.ab_attention or \
                args.ab_prefix or args.ab_spec:
            ap.error("--ab-tp is exclusive with --ab/--static/"
                     "--ab-attention/--ab-prefix/--ab-spec (one A/B per "
                     "record)")
        if not args.mesh:
            ap.error("--ab-tp compares tp=1 against a sharded mesh — "
                     "it requires --mesh (e.g. --mesh dp=1,tp=4)")
    if args.mesh and args.fleet:
        ap.error("--mesh shards ONE engine across chips; the fleet "
                 "router sees each mesh as a single logical replica "
                 "and composing the two is not wired into the bench — "
                 "drop one")
    if args.system_prompt_len < -1:
        ap.error("--system-prompt-len must be >= 0 (-1 = auto)")
    _validate_fleet(ap, args)


def _validate_fleet(ap, args):
    """The JAX tool's fleet checks (argparse errors, exit code 2), the
    pools' included; on a rolling update, sets ``args.update_at`` to its
    ``(seconds, fraction)``."""
    from horovod_tpu_torch.elastic.faults import (FaultPlanError,
                                                  _parse_at,
                                                  parse_serve_fault_plan)

    args.update_at = None
    if args.ab_spec and args.fleet:
        ap.error("--ab-spec is exclusive with --fleet (one A/B per "
                 "record; speculation composes with the fleet via "
                 "--speculate)")
    _validate_pools(ap, args)
    if args.fleet < 0:
        ap.error("--fleet must be >= 0 (0 = single engine)")
    if args.fleet and (args.ab or args.static or args.ab_attention):
        ap.error("--fleet is exclusive with --ab/--static/"
                 "--ab-attention (one A/B per record)")
    if args.ab_prefix and (args.fault_plan or args.rolling_update_at):
        ap.error("--ab-prefix is exclusive with --fault-plan/"
                 "--rolling-update-at (one A/B per record)")
    if args.fault_plan and not args.fleet:
        ap.error("--fault-plan requires --fleet N (faults address "
                 "fleet replicas)")
    if args.fleet_hosts and args.fleet_transport != "tcp":
        ap.error("--fleet-hosts places workers over the network and "
                 "needs --fleet-transport tcp")
    if args.rolling_update_at:
        if not args.fleet:
            ap.error("--rolling-update-at rolls a FLEET's weights — it "
                     "requires --fleet N")
        try:
            args.update_at = _parse_at(
                f"--rolling-update-at={args.rolling_update_at}",
                args.rolling_update_at)
        except FaultPlanError as e:
            ap.error(str(e))
    if not args.fault_plan:
        return
    try:
        actions = parse_serve_fault_plan(args.fault_plan)
    except FaultPlanError as e:
        ap.error(str(e))
    n_hosts = len([h for h in args.fleet_hosts.split(",")
                   if h.strip()]) or 1
    for a in actions:
        if a.replica is not None and a.replica >= args.fleet:
            ap.error(f"fault action {a}: replica {a.replica} is outside "
                     f"--fleet {args.fleet}")
        if a.host is not None:
            if args.fleet_transport != "tcp":
                ap.error(f"fault action {a}: host-addressed faults "
                         "(kill:host=/partition:) need --fleet-transport "
                         "tcp — hosts are not a failure domain on the "
                         f"{args.fleet_transport} transport")
            if a.host >= n_hosts:
                ap.error(f"fault action {a}: host {a.host} is outside "
                         f"the {n_hosts}-host placement")
        if a.kind in ("transfer", "corrupt") and \
                args.fleet_transport == "inproc":
            ap.error(f"fault action {a}: {a.kind} faults address the "
                     "params-push wire — use --fleet-transport process "
                     "or tcp")
    if any(a.kind == "stall" for a in actions) and \
            args.fleet_watchdog_timeout <= 0:
        ap.error("stall: fault plans need --fleet-watchdog-timeout > 0 — "
                 "an unwatched stall hangs the lane forever")


def _validate_pools(ap, args):
    """The JAX tool's ``--pools``/``--ab-disagg`` checks (argparse
    errors); sets ``args.pools_map`` (None = colocated) and, when
    ``--fleet`` is absent, ``args.fleet = P + D``."""
    args.pools_map = None
    if args.pools:
        try:
            p_n, d_n = (int(x) for x in args.pools.split(","))
        except ValueError:
            ap.error(f"--pools must be 'P,D' (two ints), got "
                     f"{args.pools!r}")
        if p_n < 1 or d_n < 1:
            ap.error(f"--pools needs both pools >= 1, got {args.pools}")
        if args.fleet and args.fleet != p_n + d_n:
            ap.error(f"--pools {args.pools} must partition --fleet "
                     f"{args.fleet} exactly (P + D = {p_n + d_n})")
        args.fleet = args.fleet or (p_n + d_n)
        args.pools_map = {"prefill": p_n, "decode": d_n}
        if args.ab_spec:
            ap.error("--pools drives a fleet — exclusive with "
                     "--ab-spec (one A/B per record)")
    if args.ab_disagg:
        if not args.pools:
            ap.error("--ab-disagg compares colocated against "
                     "disaggregated pools — it requires --pools P,D")
        if args.ab or args.static or args.ab_attention or \
                args.ab_prefix or args.ab_spec:
            ap.error("--ab-disagg is exclusive with --ab/--static/"
                     "--ab-attention/--ab-prefix/--ab-tp/--ab-spec "
                     "(one A/B per record)")
        if args.rolling_update_at:
            ap.error("--ab-disagg is exclusive with "
                     "--rolling-update-at (one A/B per record; the "
                     "faulted third lane composes via --fault-plan)")


def run(args, device: DeviceLike = None, ap=None) -> Optional[dict]:
    """One bench record from parsed ``args`` on ``device`` (None = the
    card); None on a tensor-parallel follower rank."""
    ap = ap or build_parser()
    _validate(ap, args)
    dev = resolve_device(device)
    capture = args.capture == "on"
    ps = args.page_size
    spl = args.system_prompt_len
    if spl < 0:
        spl = 4 * ps if args.ab_prefix else 0
    # Lmax covers the worst request (the shared system prompt included),
    # rounded up to whole pages.
    lmax = -(-(spl + args.prompt_max + args.new_max) // ps) * ps
    num_pages = args.num_pages
    if num_pages <= 0:
        num_pages = (args.decode_slots + 1) * (lmax // ps) + 1
    try:
        cfg = ServeConfig(
            page_size=ps, num_pages=num_pages,
            decode_slots=args.decode_slots,
            prefill_chunk=args.prefill_chunk, policy=args.policy,
            slo=args.slo, admission=args.admission,
            attention=args.attention, prefix_caching=args.prefix,
            mesh=args.mesh or None, speculate_k=args.speculate,
            draft_layers=args.draft_layers)
    except ValueError as e:          # a bad --mesh string
        ap.error(str(e))
    if args.ab_tp and cfg.tp_degree < 2:
        ap.error(f"--ab-tp needs a sharded side: --mesh {args.mesh!r} "
                 f"resolves to tp={cfg.tp_degree}")
    tp_info = None
    if cfg.mesh is not None:
        dev, backend, cards = tp_world(device)
        tp_info = {"backend": backend, "cards": cards}
    params = build_params(args, lmax, device=dev)
    workload = make_workload(args, system_prompt_len=spl)

    def lane(tag, lane_cfg=cfg, runner=run_continuous):
        eng = runner(params, lane_cfg, workload, device=dev,
                     capture=capture)
        stats = eng.stats()
        p, sp = stats.get("prefix"), stats.get("spec")
        print(f"[serve_bench] {tag}: "
              f"{stats['tokens_per_sec_per_chip']} tok/s/chip, "
              f"ttft p50/p99 {stats['ttft_ms']['p50']}/"
              f"{stats['ttft_ms']['p99']} ms, "
              f"tbt p50/p99 {stats['tbt_ms']['p50']}/"
              f"{stats['tbt_ms']['p99']} ms, {stats['by_state']}"
              + (f", prefix hit_rate {p['hit_rate']} "
                 f"({p['prefill_tokens_saved']} prefill tokens saved, "
                 f"{p['cow_copies']} COW copies)" if p else "")
              + (f", spec k={sp['k']} dl={sp['draft_layers']} "
                 f"accept_rate {sp['accept_rate']} tokens_per_step "
                 f"{sp['tokens_per_step']}" if sp else ""),
              file=sys.stderr, flush=True)
        if args.pin_exact:
            pin_exact(params, eng, dev)
        if args.require_finished and \
                stats["by_state"].get("finished") != args.requests:
            raise SystemExit(
                f"not all requests finished: {stats['by_state']}")
        reqs = sorted(eng.finished + eng.evicted + eng.timed_out
                      + eng.scheduler.rejected, key=lambda r: r.rid)
        return stats, reqs

    def ratio(a, b):
        a, b = a["tokens_per_sec_per_chip"], b["tokens_per_sec_per_chip"]
        return round(a / b, 3) if a and b else None

    if tp_info is not None:
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() != 0:
            # A follower: its shard of the (one) sharded lane.
            ServeEngine(params, cfg, device=dev, capture=capture,
                        chips=cfg.tp_degree).follow()
            return None
    if args.ab_tp:
        mode, headline, serve = tp_record(args, cfg, lane, tp_info)
    elif args.fleet:
        mode, headline, serve = fleet_record(args, params, cfg, workload,
                                             dev, spl, ap)
    elif args.ab_prefix:
        off, off_reqs = lane("prefix=off", dataclasses.replace(
            cfg, prefix_caching=False))
        on, on_reqs = lane("prefix=on", dataclasses.replace(
            cfg, prefix_caching=True))
        compared = pin_sides(off_reqs, on_reqs, "PREFIX AB")
        uniq, colds = pin_prefix_cold(on_reqs, ps, "cached side")
        if not (on.get("prefix") or {}).get("prefill_tokens_saved"):
            raise SystemExit("PREFIX AB FAILED: the cached side saved no "
                             f"prefill tokens ({on.get('prefix')})")
        print(f"[serve_bench] prefix pins: {compared} greedy streams "
              f"bit-identical off vs on; {colds} cold prefill(s) for "
              f"{uniq} unique prefix(es)", file=sys.stderr, flush=True)
        mode, headline = "ab_prefix", on
        serve = dict(on, mode=mode, ab_prefix={
            "off": dict(off, prefix=None),
            "system_prompt_tokens": spl,
            "unique_prefixes": uniq,
            "cold_prefills": colds,
            "exact_pin": {"compared": compared, "identical": True},
            "cached_over_cold": ratio(on, off),
        })
    elif args.ab_spec:
        base, base_reqs = lane("spec=off", dataclasses.replace(
            cfg, speculate_k=0, draft_layers=0))
        spec, spec_reqs = lane(f"spec=on [k={args.speculate}]")
        compared = pin_sides(base_reqs, spec_reqs, "SPEC AB")
        sp = spec.get("spec") or {}
        print(f"[serve_bench] spec pins: {compared} greedy streams "
              f"bit-identical base vs speculative; accept_rate "
              f"{sp.get('accept_rate')}, tokens_per_step "
              f"{sp.get('tokens_per_step')}", file=sys.stderr, flush=True)
        mode, headline = "ab_spec", spec
        serve = dict(spec, mode=mode, ab_spec={
            "base": dict(base, spec=None),
            "k": args.speculate,
            "draft_layers": sp.get("draft_layers"),
            "accept_rate": sp.get("accept_rate"),
            "tokens_per_step": sp.get("tokens_per_step"),
            "exact_pin": {"compared": compared, "identical": True},
            "spec_over_base": ratio(spec, base),
        })
    elif args.ab_attention:
        gat, _ = lane("attention=gather",
                      dataclasses.replace(cfg, attention="gather"))
        pag, _ = lane("attention=paged",
                      dataclasses.replace(cfg, attention="paged"))
        mode, headline = "ab_attention", pag
        serve = dict(pag, mode=mode, ab_attention={
            "gather": gat, "paged_over_gather": ratio(pag, gat)})
    elif args.ab:
        cont, _ = lane("continuous")
        stat, _ = lane("static", runner=run_static)
        mode, headline = "ab", cont
        serve = dict(cont, mode=mode, ab={
            "static": stat, "continuous_over_static": ratio(cont, stat)})
    else:
        mode = "static" if args.static else "continuous"
        headline = lane(mode, runner=run_static if args.static
                        else run_continuous)[0]
        serve = dict(headline, mode=mode)
    if tp_info is not None and not args.ab_tp:
        serve["tp"] = {"degree": cfg.tp_degree, "mesh": args.mesh,
                       "kv_bytes_per_chip":
                           headline["attention"]["kv_bytes_per_chip"],
                       "backend": tp_info["backend"]}
    per_card = None
    if args.fleet:
        per_card = fleet_per_card(args, mode, serve)
    elif tp_info is not None:
        per_card = tp_per_card(cfg, mode, serve, tp_info)
    return {
        "metric": f"serve_{mode}_tokens_per_sec_per_chip",
        "value": headline["tokens_per_sec_per_chip"],
        "unit": "tokens/sec/chip",
        "vs_baseline": None,
        "serve": serve,
        "per_card": per_card,
        "card": card_description(dev),
        "config": {
            "page_size": ps, "num_pages": num_pages,
            "decode_slots": args.decode_slots,
            "prefill_chunk": args.prefill_chunk,
            "policy": args.policy, "slo": args.slo,
            "admission": args.admission,
            "attention": "ab" if args.ab_attention else args.attention,
            "prefix_caching": "ab" if args.ab_prefix else args.prefix,
            "mesh": args.mesh or None,
            "speculate_k": "ab" if args.ab_spec else args.speculate,
            "draft_layers": args.draft_layers,
            "system_prompt_len": spl,
            "rate": args.rate,
            "requests": args.requests,
            "fleet": ({
                "replicas": args.fleet,
                "transport": args.fleet_transport,
                "hosts": args.fleet_hosts or None,
                "max_restarts": args.fleet_max_restarts,
                "watchdog_timeout": args.fleet_watchdog_timeout,
                "max_queue": args.fleet_max_queue,
                "backoff_base": args.fleet_backoff,
                "fault_plan": args.fault_plan or None,
                "rolling_update_at": args.rolling_update_at or None,
                "push_chunk_bytes": args.fleet_push_chunk_bytes,
                "push_retries": args.fleet_push_retries,
                "pools": args.pools or None,
            } if args.fleet else None),
            "capture": args.capture,
            "model": {"layers": args.layers, "d_model": args.d_model,
                      "heads": args.heads, "vocab": args.vocab,
                      "dtype": "float32"},
        },
    }


def tp_record(args, cfg, lane, tp_info):
    """``--ab-tp``: the identical workload on a tp=1 engine (rank 0
    alone) and on the sharded one; ``(mode, headline stats, serve
    block)`` with the JAX tool's ``serve.tp`` and its two pins."""
    tpd = cfg.tp_degree
    single, single_reqs = lane("tp=1", dataclasses.replace(cfg, mesh=None))
    shard, shard_reqs = lane(f"tp={tpd} [{args.mesh}]")
    # Sharding heads is a layout change, not a numerics change: every
    # greedy stream must be the same on both sides.
    if len(single_reqs) != len(shard_reqs):
        raise SystemExit(
            f"TP AB PIN FAILED: {len(single_reqs)} requests on the tp=1 "
            f"side vs {len(shard_reqs)} on tp={tpd}")
    compared = 0
    for i, (rs, rt) in enumerate(zip(single_reqs, shard_reqs)):
        if rs.temperature > 0 or rs.state != "finished" \
                or rt.state != "finished":
            continue
        if rs.output != rt.output:
            raise SystemExit(f"TP AB PIN FAILED: request #{i} "
                             f"tp1={rs.output} tp{tpd}={rt.output}")
        compared += 1
    if not compared:
        raise SystemExit("TP AB PIN FAILED: no greedy pairs finished on "
                         "both sides — nothing compared")
    # The bandwidth pin: the sharded side holds 1/tp of the decode K/V
    # bytes a chip, against the same run's full-model bytes a step (the
    # two lanes batch differently under wall-clock arrivals).
    attn = shard["attention"]
    kv_full = (attn["kv_bytes_per_step_paged"] if attn["mode"] == "paged"
               else attn["kv_bytes_per_step_gather"])
    kv_chip = attn["kv_bytes_per_chip"]
    if kv_full and kv_chip and kv_chip > kv_full / tpd * 1.001:
        raise SystemExit(
            f"TP AB BYTES PIN FAILED: kv_bytes_per_chip {kv_chip} on "
            f"tp={tpd} exceeds 1/{tpd} of the run's single-chip bytes "
            f"{kv_full}")
    print(f"[serve_bench] tp pins: {compared} greedy streams "
          f"bit-identical tp=1 vs tp={tpd}; kv_bytes_per_chip {kv_chip} "
          f"<= {kv_full}/{tpd}", file=sys.stderr, flush=True)
    a, b = single["tokens_per_sec_per_chip"], shard["tokens_per_sec_per_chip"]
    return "ab_tp", shard, dict(shard, mode="ab_tp", tp={
        "degree": tpd,
        "mesh": args.mesh,
        "backend": tp_info["backend"],
        "single": single,
        "kv_bytes_per_chip": kv_chip,
        "kv_bytes_per_chip_single": kv_full,
        "exact_pin": {"compared": compared, "identical": True},
        # Wall-clock throughput of the whole engine against tp=1's.
        "tp_over_single": round(b * tpd / a, 3) if a and b else None,
    })


def tp_per_card(cfg, mode, serve, tp_info):
    """A ``--mesh`` record's tokens/s of one card: the engine's tokens
    over the cards its ranks occupy (one each, or all on one card); the
    tp=1 side of ``--ab-tp`` holds one card."""
    cards = max(1, tp_info["cards"])
    lanes = {"tp": (serve, cfg.tp_degree / cards)}
    if mode == "ab_tp":
        lanes["tp1"] = (serve["tp"]["single"], 1)
    return {"cards": cards, "tokens_per_sec": {
        name: (round(st["tokens_per_sec_per_chip"] * k, 1)
               if st["tokens_per_sec_per_chip"] else None)
        for name, (st, k) in lanes.items()}}


def fleet_cards(args):
    """The cards a ``--fleet`` run's replicas occupy. The fleet adds no
    placement of its own: in process and as local workers every replica
    runs on the host's first visible card; over tcp the replicas of one
    host share that host's card."""
    hosts = [h.strip() for h in args.fleet_hosts.split(",") if h.strip()]
    if args.fleet_transport != "tcp" or not hosts:
        return 1
    names = [parse_host_entry(h)[0] for h in hosts]
    used = {names[rid % len(names)] for rid in range(args.fleet)}
    return len({"local" if h in LOCAL_HOSTS else h for h in used})


def fleet_per_card(args, mode, serve):
    """Each lane's tokens/s of one card. ``stats()`` divides the tokens by
    one chip per replica, as the reference does; replicas that share a
    card make that a share of the card, so this is the figure to hold
    against a single engine's ``tokens_per_sec_per_chip``."""
    cards = fleet_cards(args)
    if mode == "fleet_fault_ab":
        lanes = {"clean": serve["fleet_ab"]["clean"], "faulted": serve}
    elif mode == "ab_prefix":
        lanes = {"off": serve["ab_prefix"]["off"], "on": serve}
    elif mode == "ab_disagg":
        lanes = {"colocated": serve["disagg"]["colocated"],
                 "disagg": serve}
    else:
        lanes = {"clean": serve}
    return {"cards": cards, "tokens_per_sec": {
        name: (round(st["tokens_per_sec_per_chip"] * args.fleet / cards, 1)
               if st["tokens_per_sec_per_chip"] else None)
        for name, st in lanes.items()}}


def fleet_record(args, params, cfg, workload, dev, spl, ap):
    """The ``--fleet`` lanes: ``(mode, headline stats, serve block)`` of
    the JAX tool's record — ``fleet`` (one clean run),
    ``fleet_fault_ab`` (clean then faulted, ``serve.fleet_ab``),
    ``ab_prefix`` (prefix caching off then on over the fleet) or
    ``ab_disagg`` (colocated then disaggregated pools,
    ``serve.disagg``)."""
    hosts = tuple(h.strip() for h in args.fleet_hosts.split(",")
                  if h.strip()) or None
    try:
        fleet_cfg = FleetConfig(
            replicas=args.fleet, max_queue=args.fleet_max_queue,
            max_restarts=args.fleet_max_restarts,
            backoff_base=args.fleet_backoff,
            watchdog_timeout=args.fleet_watchdog_timeout,
            transport=args.fleet_transport,
            rpc_deadline=args.fleet_rpc_deadline,
            push_chunk_bytes=args.fleet_push_chunk_bytes,
            push_retries=args.fleet_push_retries, hosts=hosts,
            pools=args.pools_map)
    except ValueError as e:
        ap.error(str(e))
    update_at = None
    if args.update_at is not None:
        secs, frac = args.update_at
        update_at = secs if secs is not None else \
            frac * max(w[0] for w in workload)

    def lane(tag, fault_plan="", update=None, lane_cfg=cfg,
             lane_fleet=fleet_cfg):
        fl, reqs = run_fleet(params, lane_cfg, lane_fleet, workload,
                             device=dev, fault_plan=fault_plan,
                             update_at=update)
        try:
            stats = fl.stats()
            f = stats["fleet"]
            push = f["params_push"]
            print(f"[serve_bench] {tag}: "
                  f"{stats['tokens_per_sec_per_chip']} tok/s/chip, "
                  f"ttft p50/p99 {stats['ttft_ms']['p50']}/"
                  f"{stats['ttft_ms']['p99']} ms, {stats['by_state']}, "
                  f"incidents {f['incidents_by_class']}, redispatched "
                  f"{f['redispatched']} ({f['tokens_recomputed']} KV "
                  f"tokens recomputed), shed {f['shed']}, transport "
                  f"{f['transport']}"
                  + (f", rpc p50/p99 {f['rpc_ms']['p50']}/"
                     f"{f['rpc_ms']['p99']} ms" if f.get("rpc_ms") else "")
                  + (f", params v{push['version']}: {push['pushes']} "
                     f"push(es) {push['bytes']}B/{push['chunks']}ck in "
                     f"{push['ms']:.1f}ms, {push['retries']} retries"
                     if push["pushes"] else "")
                  + ((lambda d: f", disagg {d['pools']['prefill']}"
                      f"p+{d['pools']['decode']}d: {d['transfers']} KV "
                      f"transfer(s) {d['kv_bytes_shipped']}B, transfer "
                      f"p50/p99 {d['transfer_ms_p50']}/"
                      f"{d['transfer_ms_p99']} ms")(f["disagg"])
                     if f.get("disagg") else ""),
                  file=sys.stderr, flush=True)
            if args.pin_exact:
                pin_exact(params, fl, dev)
            if args.require_finished:
                finished = stats["by_state"].get("finished", 0)
                rejected = stats["by_state"].get("rejected", 0)
                if finished + rejected != args.requests or not finished:
                    raise SystemExit(
                        f"not every non-rejected request finished: "
                        f"{stats['by_state']}")
        finally:
            fl.close()
        return stats, reqs

    n = args.fleet
    if args.ab_disagg:
        return disagg_record(args, fleet_cfg, lane)
    if args.ab_prefix:
        off, off_reqs = lane(f"fleet x{n} prefix=off", lane_cfg=(
            dataclasses.replace(cfg, prefix_caching=False)))
        on, on_reqs = lane(f"fleet x{n} prefix=on", lane_cfg=(
            dataclasses.replace(cfg, prefix_caching=True)))
        compared = pin_sides(off_reqs, on_reqs, "PREFIX AB")
        uniq, colds = pin_prefix_cold(on_reqs, cfg.page_size,
                                      "fleet cached side")
        homes = len({r.replica for r in on_reqs if r.state == "finished"
                     and prefix_route_key(r.prompt[:r.orig_prompt_len],
                                          cfg.page_size) is not None})
        pb = on["fleet"]["prefix"] or {}
        if not pb.get("prefill_tokens_saved"):
            raise SystemExit("PREFIX AB FAILED: the cached fleet side "
                             f"saved no prefill tokens ({pb})")
        print(f"[serve_bench] prefix pins: {compared} greedy streams "
              f"bit-identical off vs on; {colds} cold prefill(s) for "
              f"{uniq} unique prefix(es) across {homes} replica home(s)",
              file=sys.stderr, flush=True)
        a, b = off["tokens_per_sec_per_chip"], on["tokens_per_sec_per_chip"]
        return "ab_prefix", on, dict(on, mode="ab_prefix", ab_prefix={
            "off": dict(off, prefix=None),
            "system_prompt_tokens": spl,
            "unique_prefixes": uniq,
            "replica_homes": homes,
            "cold_prefills": colds,
            "exact_pin": {"compared": compared, "identical": True},
            "cached_over_cold": round(b / a, 3) if a and b else None,
        })
    clean, clean_reqs = lane(f"fleet x{n} clean")
    if not (args.fault_plan or update_at is not None):
        return "fleet", clean, dict(clean, mode="fleet")
    tag = f"fleet x{n} faulted"
    if args.fault_plan:
        tag += f" [{args.fault_plan}]"
    if update_at is not None:
        tag += f" [rolling update at {update_at:.2f}s]"
    faulted, faulted_reqs = lane(tag, args.fault_plan, update=update_at)
    compared = pin_redispatch_exact(clean_reqs, faulted_reqs)
    print(f"[serve_bench] redispatch pin: {compared} greedy streams "
          "bit-identical clean vs faulted", file=sys.stderr, flush=True)
    c99 = (clean.get("ttft_ms") or {}).get("p99")
    f99 = (faulted.get("ttft_ms") or {}).get("p99")
    return "fleet_fault_ab", faulted, dict(
        faulted, mode="fleet_fault_ab", fleet_ab={
            "clean": clean,
            "fault_plan": args.fault_plan or None,
            "rolling_update_at": args.rolling_update_at or None,
            "redispatch_pin": {"compared": compared, "identical": True},
            "p99_ttft_clean_ms": c99,
            "p99_ttft_faulted_ms": f99,
            "faulted_over_clean_p99_ttft":
                round(f99 / c99, 3) if c99 and f99 else None,
        })


def disagg_record(args, fleet_cfg, lane):
    """``--ab-disagg``: the identical workload on a colocated fleet of
    the same size, then on the pools (and, with ``--fault-plan``, the
    pools faulted); the JAX tool's ``serve.disagg`` block."""
    pools = args.pools_map
    colo, colo_reqs = lane(f"fleet x{args.fleet} colocated",
                           lane_fleet=dataclasses.replace(fleet_cfg,
                                                          pools=None))
    dtag = (f"fleet x{args.fleet} disagg {pools['prefill']}p+"
            f"{pools['decode']}d")
    dis, dis_reqs = lane(dtag)
    compared = pin_disagg_sides(colo_reqs, dis_reqs)
    df = (dis.get("fleet") or {}).get("disagg") or {}
    if not df.get("transfers"):
        raise SystemExit("DISAGG AB FAILED: the disaggregated side shipped "
                         f"no KV transfers ({df or 'no disagg block'})")
    print(f"[serve_bench] disagg pin: {compared} greedy streams "
          "bit-identical colocated vs disaggregated "
          f"({df['transfers']} KV transfer(s), {df['kv_bytes_shipped']} "
          "bytes shipped)", file=sys.stderr, flush=True)
    redispatch_block = None
    if args.fault_plan:
        faulted, faulted_reqs = lane(f"{dtag} faulted [{args.fault_plan}]",
                                     args.fault_plan)
        rcompared = pin_redispatch_exact(dis_reqs, faulted_reqs)
        print(f"[serve_bench] disagg redispatch pin: {rcompared} greedy "
              "streams bit-identical disagg-clean vs disagg-faulted",
              file=sys.stderr, flush=True)
        redispatch_block = {
            "fault_plan": args.fault_plan,
            "compared": rcompared, "identical": True,
            "incidents_by_class":
                (faulted.get("fleet") or {}).get("incidents_by_class"),
            "redispatched": (faulted.get("fleet") or {}).get("redispatched"),
        }
    c99 = (colo.get("ttft_ms") or {}).get("p99")
    d99 = (dis.get("ttft_ms") or {}).get("p99")
    return "ab_disagg", dis, dict(dis, mode="ab_disagg", disagg={
        "pools": dict(pools),
        "colocated": colo,
        "transfers": df.get("transfers"),
        "kv_bytes_shipped": df.get("kv_bytes_shipped"),
        "transfer_ms_p50": df.get("transfer_ms_p50"),
        "transfer_ms_p99": df.get("transfer_ms_p99"),
        "ttft_ms": dis.get("ttft_ms"),
        "tbt_ms": dis.get("tbt_ms"),
        "colocated_ttft_ms": colo.get("ttft_ms"),
        "colocated_tbt_ms": colo.get("tbt_ms"),
        "exact_pin": {"compared": compared, "identical": True},
        "redispatch_pin": redispatch_block,
        "p99_ttft_colocated_ms": c99,
        "p99_ttft_disagg_ms": d99,
        "disagg_over_colocated": round(d99 / c99, 3) if c99 and d99
        else None,
    })


def main(argv=None) -> int:
    import torch.distributed as dist

    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        record = run(args, ap=ap)
    finally:
        # A --mesh run's world (started from the launcher's environment).
        if dist.is_initialized():
            dist.destroy_process_group()
    if record is not None:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
