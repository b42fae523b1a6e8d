"""Gloo worlds for the tests of ``horovod_tpu_torch``: N rank processes
that run one function of a test module and meet in one process group.

The ranks meet through a ``FileStore`` in the world's own directory
(:func:`init_url`), so no port is chosen: a port found free, closed and
bound again only by rank 0 could be taken in between by another process
of a parallel test run. Each rank leaves its process group before it
exits (:func:`run_rank`): a gloo group alive at interpreter exit can
abort the process in its teardown ("terminate called without an active
exception") after the rank's work is done.
"""

from __future__ import annotations

import os
import subprocess
import sys
import uuid
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def init_url(out) -> str:
    """A fresh ``file://`` rendezvous in the directory ``out``."""
    return "file://" + os.path.join(str(out), f"store-{uuid.uuid4().hex}")


def run_rank(module: str, fn: str, *args) -> None:
    """In a rank process: ``module.fn(*args)``, then leave the process
    group if the function left it standing."""
    import importlib

    getattr(importlib.import_module(module), fn)(*args)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(module: str, fn: str, rank_args, timeout: float, env=None):
    """Start one process a rank, running ``module.fn(*rank_args[r])``
    through :func:`run_rank`; wait for all, killing every one still alive
    when one fails or the ``timeout`` (seconds, for each) passes. Fails
    with every rank's log unless each exits with 0."""
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import gloo_worlds; "
            "gloo_worlds.run_rank({!r}, {!r}, *{!r})")
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore::FutureWarning")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(str(TESTS), str(REPO), module,
                                           fn, tuple(args))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for args in rank_args]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            logs.append(stdout + stderr[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} rc={p.returncode}\n{log}"
        for r, (p, log) in enumerate(zip(procs, logs)))


def start_world(n: int, out, module: str, fn: str = "_worker",
                timeout: float = 180, env=None) -> None:
    """Run ``module.fn(rank, n, init, out)`` in ``n`` rank processes,
    ``init`` the world's rendezvous URL (:func:`init_url`)."""
    init = init_url(out)
    spawn(module, fn, [(r, n, init, str(out)) for r in range(n)], timeout,
          env)
