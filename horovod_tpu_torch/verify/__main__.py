"""CLI: ``python -m horovod_tpu_torch.verify``, the port's static
verification gate.

Exit status as ``tools/hvdverify``'s: 0 when every finding is suppressed
(or there is none), 1 otherwise, 2 for a usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence


def main(argv: Sequence[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.verify",
        description="Collective-schedule verifier of the port: runs each "
                    "program in a simulated world and checks the ranks' "
                    "recorded schedules (rules HVV101-HVV203).")
    parser.add_argument("--sweep", action="store_true",
                        help="verify the full program registry (the gate)")
    parser.add_argument("--group", default="",
                        help="comma list of registry groups")
    parser.add_argument("--program", default="",
                        help="comma list of registry program names")
    parser.add_argument("--list", action="store_true", dest="list_programs",
                        help="print the program registry and exit")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    parser.add_argument("--schedule", action="store_true",
                        help="print each program's schedule (rank 0)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON object per program "
                             "(summary + findings)")
    args = parser.parse_args(argv)

    from horovod_tpu_torch.verify.registry import REGISTRY, programs
    from horovod_tpu_torch.verify.rules import RULES

    if args.list_rules:
        for rule_id, doc in sorted(RULES.items()):
            print(f"{rule_id}  {doc}")
        return 0
    if args.list_programs:
        for p in REGISTRY:
            marks = [m for m, on in (
                ("byte-reconciled", p.reconcile), ("shardings", p.shardings),
                ("axis-vocabulary", p.logical_mesh),
                ("equivalence", p.equivalence)) if on]
            print(f"{p.name:34s} [{p.group}] world {p.world}"
                  + (f"  ({', '.join(marks)})" if marks else ""))
        return 0

    groups = [g.strip() for g in args.group.split(",") if g.strip()]
    names = [n.strip() for n in args.program.split(",") if n.strip()]
    if not (args.sweep or groups or names):
        parser.error("nothing to do: pass --sweep, --group or --program")
    try:
        selected = programs(groups or None, names or None)
    except KeyError as e:
        parser.error(str(e))

    import warnings

    from horovod_tpu_torch.verify.core import verify

    # The port's ladder calls torch's reduce_scatter_tensor and
    # all_gather_into_tensor, which newer torch marks deprecated.
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")

    active = suppressed = 0
    for prog in selected:
        res = verify(prog)
        active += len(res.active)
        suppressed += len(res.suppressed)
        if args.json:
            print(json.dumps({
                "program": res.name, "collectives": res.summary,
                "findings": [{"rule": f.rule, "message": f.message,
                              "source": f.source,
                              "suppressed": f.suppressed}
                             for f in res.findings]}), flush=True)
            continue
        s = res.summary
        print(f"{res.name:34s} {s['count']:3d} collective(s) "
              f"{s['mb']:10.2f} MB  {len(res.active)} finding(s)"
              + (f" ({len(res.suppressed)} suppressed)"
                 if res.suppressed else ""), flush=True)
        for f in (res.findings if args.show_suppressed else res.active):
            print(f"  {f.format()}")
        if args.schedule:
            for op in res.schedule:
                print(f"    {op.describe()}")
    if not args.json:
        print(f"verify: {len(selected)} program(s), {active} finding(s), "
              f"{suppressed} suppressed")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
