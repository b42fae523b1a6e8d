"""One rank of :func:`horovod_tpu_torch.run.run`:
``python -m horovod_tpu_torch.run.task_exec``.

The port of ``horovod_tpu.run.task_exec``: read the rank's identity and
the driver's addresses from the environment the launcher set, probe for
a reachable driver address, register, fetch the task, run it and report
its result or its traceback. A watchdog thread exits the process when
the launcher dies, so orphaned ranks never linger. Nothing here imports
torch; the task does, if it needs it.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback


def _parent_watchdog(parent_pid: int) -> None:
    while True:
        if os.getppid() != parent_pid:
            os._exit(1)  # the launcher died; do not linger
        time.sleep(1.0)


def main() -> int:
    rank = int(os.environ["HOROVOD_RANK"])
    key = bytes.fromhex(os.environ["HOROVOD_SECRET"])

    threading.Thread(target=_parent_watchdog, args=(os.getppid(),),
                     daemon=True).start()

    from horovod_tpu_torch.run.driver import WorkerClient, probe_service

    # HOROVOD_DRIVER carries one or more candidate endpoints (a multi-NIC
    # host publishes every interface); take the first that answers.
    candidates = os.environ["HOROVOD_DRIVER"].split(",")
    if len(candidates) == 1:
        host, _, port = candidates[0].rpartition(":")
        addr = (host, int(port))
    else:
        addr = probe_service(candidates, key)

    client = WorkerClient(addr, key)
    client.register(rank, os.uname().nodename)
    try:
        # Fetching can fail too (the function unpickles by reference from
        # a module this worker cannot import): report it, so the driver
        # fails fast instead of waiting out its timeout.
        task = client.fetch_task(rank)
        result = task.fn(*task.args, **task.kwargs)
    except BaseException:
        client.report(rank, False, traceback.format_exc())
        return 1
    client.report(rank, True, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
