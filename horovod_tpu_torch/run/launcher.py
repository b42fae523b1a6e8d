"""The ``hvdrun-torch`` console entry: ``hvdrun-torch -np N [-H hosts]
[--restarts K | --elastic ...] -- cmd args...``.

The port of ``horovod_tpu.run.launcher`` (the ``horovodrun`` analogue;
Horovod's documented launch was ``mpirun -np N python train.py``): the
launcher places the ranks and sets their environment itself, with no
MPI runtime. ``python -m horovod_tpu_torch.run`` is the same CLI.

``--elastic`` hands the job to
:func:`horovod_tpu_torch.elastic.supervisor.supervise` (classify each
worker exit, tear the world down, relaunch from the latest snapshot
manifest), with the reference's flags and validation; ``--fault-plan``
is validated here and reaches the workers as ``HOROVOD_FAULT_PLAN``.
The JAX package's ``--jax`` (one global jax device mesh across the
workers) has no counterpart: every rank's ``hvd.init()`` joins the
job's ``torch.distributed`` world through the environment the launcher
sets.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from horovod_tpu_torch.run import launch_command


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch an N-rank horovod_tpu_torch job.")
    parser.add_argument("-np", "--num-proc", type=int, required=True,
                        help="total number of ranks")
    parser.add_argument("-H", "--hosts", default=None,
                        help="host1:slots,host2:slots (default: all local)")
    parser.add_argument("--restarts", type=int, default=0,
                        help="relaunch the whole job up to N times after a "
                             "failure (with a rank-0 checkpoint and a "
                             "re-broadcast the relaunch resumes from the "
                             "last saved step); exit code 2 is never "
                             "relaunched. 0 = fail fast")
    parser.add_argument("--elastic", action="store_true",
                        help="preemption-tolerant supervision "
                             "(horovod_tpu_torch.elastic): classify each "
                             "worker exit (clean / usage / preempted / "
                             "resized / stalled / crashed), tear down "
                             "the world and relaunch; workers resume "
                             "from the latest snapshot manifest "
                             "(elastic.run_elastic / Snapshotter). "
                             "Preemptions (exit 75 or SIGTERM) and "
                             "resizes (exit 76) relaunch for free; "
                             "crashes and stalls consume the "
                             "--max-restarts budget")
    parser.add_argument("--max-restarts", type=int, default=1,
                        help="crash-restart budget for --elastic "
                             "(default 1; preemptions don't consume it)")
    parser.add_argument("--min-np", type=int, default=None,
                        help="elastic world floor: a preemption "
                             "relaunches at the surviving rank count "
                             "(>= this) instead of retrying full size; "
                             "workers reshard-resume through the "
                             "manifest cursor remap (default: -np, a "
                             "fixed world)")
    parser.add_argument("--max-np", type=int, default=None,
                        help="elastic world ceiling for regrowth "
                             "(default: -np)")
    parser.add_argument("--slots-file", default=None,
                        help="path to a file holding the currently "
                             "available worker-slot count (kept current "
                             "by the fleet scheduler/agent); each "
                             "relaunch clamps the world to min(slots, "
                             "--max-np), so a shrunken job grows back "
                             "when capacity returns")
    parser.add_argument("--watchdog-timeout", type=float, default=None,
                        help="health-watchdog deadline in seconds: a "
                             "rank whose heartbeat (touched every "
                             "window boundary) goes stale past this is "
                             "killed, classified 'stalled' and the job "
                             "relaunched (default: "
                             "HOROVOD_WATCHDOG_TIMEOUT or 300; 0 "
                             "disables)")
    parser.add_argument("--metrics-file", default=None,
                        help="append one PERF_RUNS.tsv-format JSON line "
                             "of recovery metrics (restarts by class, "
                             "world trajectory, time-to-detect/"
                             "relaunch) at job end")
    parser.add_argument("--fault-plan", default=None,
                        help="deterministic fault injection plan, e.g. "
                             "'kill:rank=1,step=7;resize:rank=0,step=9,"
                             "n=1' — validated here, exported to "
                             "workers as HOROVOD_FAULT_PLAN (grammar: "
                             "docs/elastic.md)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="training command")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.num_proc < 1:
        parser.error("-np must be >= 1")
    if args.restarts < 0:
        parser.error("--restarts must be >= 0")
    if args.max_restarts < 0:
        parser.error("--max-restarts must be >= 0")
    if args.restarts and args.elastic:
        parser.error("--restarts and --elastic are mutually exclusive "
                     "(--elastic already relaunches; use --max-restarts)")
    for flag in ("min_np", "max_np", "slots_file", "watchdog_timeout",
                 "metrics_file"):
        if getattr(args, flag) is not None and not args.elastic:
            parser.error(f"--{flag.replace('_', '-')} requires --elastic")
    min_np = args.min_np if args.min_np is not None else args.num_proc
    max_np = args.max_np if args.max_np is not None else args.num_proc
    if args.elastic and not 1 <= min_np <= args.num_proc <= max_np:
        parser.error(f"need 1 <= --min-np ({min_np}) <= -np "
                     f"({args.num_proc}) <= --max-np ({max_np})")
    env = None
    if args.fault_plan is not None:
        # Validate the grammar HERE so a typo'd plan is a usage error at
        # launch, not a silently-injecting-nothing "green" run.
        from horovod_tpu_torch.elastic.faults import FaultPlanError, \
            parse_fault_plan

        try:
            plan = parse_fault_plan(args.fault_plan)
        except FaultPlanError as e:
            parser.error(str(e))
        if any(a.kind == "resize" for a in plan) and not args.elastic:
            parser.error("resize: fault actions need --elastic (the "
                         "supervisor is what relaunches at the new "
                         "world size)")
        for a in plan:
            if a.kind == "resize" and not min_np <= a.n <= max_np:
                parser.error(
                    f"fault plan resize n={a.n} is outside the elastic "
                    f"world bounds [{min_np}, {max_np}]; widen "
                    "--min-np/--max-np or fix the plan")
        env = dict(os.environ)
        env["HOROVOD_FAULT_PLAN"] = args.fault_plan
    cmd = args.command[1:] if args.command[0] == "--" else args.command
    if args.elastic:
        from horovod_tpu_torch.elastic.supervisor import (
            slots_file_capacity, supervise)

        capacity_fn = (slots_file_capacity(args.slots_file)
                       if args.slots_file else None)
        return supervise(cmd, np=args.num_proc, hosts=args.hosts,
                         env=env,
                         max_restarts=args.max_restarts,
                         restart_delay=3.0 if args.hosts else 0.0,
                         min_np=min_np, max_np=max_np,
                         capacity_fn=capacity_fn,
                         watchdog_timeout=args.watchdog_timeout,
                         metrics_path=args.metrics_file)
    for attempt in range(args.restarts + 1):
        rc = launch_command(cmd, np=args.num_proc, hosts=args.hosts,
                            env=env)
        if rc == 0:
            return 0
        if rc == 2:
            # Exit code 2 is the usage-error convention: it reruns
            # identically, so the restart budget is not spent on it.
            print("hvdrun-torch: exit code 2 (usage error): a "
                  "deterministic failure, not relaunching",
                  file=sys.stderr, flush=True)
            return rc
        if attempt < args.restarts:
            print(f"hvdrun-torch: attempt {attempt + 1} failed (exit {rc}); "
                  f"relaunching ({args.restarts - attempt} restart(s) "
                  "left)", file=sys.stderr, flush=True)
            # Local ranks are reaped before launch_command returns; an
            # ssh rank's teardown (a pty HUP) is asynchronous.
            if args.hosts:
                time.sleep(3.0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
