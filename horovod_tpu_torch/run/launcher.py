"""The ``hvdrun-torch`` console entry: ``hvdrun-torch -np N [-H hosts]
[--restarts K] -- cmd args...``.

The port of ``horovod_tpu.run.launcher`` (the ``horovodrun`` analogue;
Horovod's documented launch was ``mpirun -np N python train.py``): the
launcher places the ranks and sets their environment itself, with no
MPI runtime. ``python -m horovod_tpu_torch.run`` is the same CLI.

The elastic flags are parsed but not ported yet (ROADMAP.md Queue 1
item 5.3): each exits with a usage error (code 2). The JAX package's
``--jax`` (one global jax device mesh across the workers) has no
counterpart: every rank's ``hvd.init()`` joins the job's
``torch.distributed`` world through the environment the launcher sets.
"""

from __future__ import annotations

import argparse
import sys
import time

from horovod_tpu_torch.run import launch_command

#: Flags of the JAX package's elastic supervisor, with their defaults:
#: parsed, and refused until elastic training is ported.
_ELASTIC_FLAGS = (("--elastic", False), ("--max-restarts", None),
                  ("--min-np", None), ("--max-np", None),
                  ("--slots-file", None), ("--watchdog-timeout", None),
                  ("--metrics-file", None), ("--fault-plan", None))


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
                        help="not ported yet (ROADMAP.md Queue 1 item 5.3)")
    for flag, _ in _ELASTIC_FLAGS[1:]:
        parser.add_argument(flag, default=None,
                            help="not ported yet (ROADMAP.md Queue 1 "
                                 "item 5.3)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="training command")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.num_proc < 1:
        parser.error("-np must be >= 1")
    if args.restarts < 0:
        parser.error("--restarts must be >= 0")
    given = [flag for flag, default in _ELASTIC_FLAGS
             if getattr(args, flag[2:].replace("-", "_")) != default]
    if given:
        parser.error(f"{', '.join(given)}: elastic training is not ported "
                     "to horovod_tpu_torch yet (ROADMAP.md Queue 1 item "
                     "5.3); use --restarts for whole-job relaunches")
    cmd = args.command[1:] if args.command[0] == "--" else args.command
    for attempt in range(args.restarts + 1):
        rc = launch_command(cmd, np=args.num_proc, hosts=args.hosts)
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
