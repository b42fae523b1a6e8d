"""A tensor-parallel fleet replica: one worker process and its followers.

A fleet replica whose :class:`~horovod_tpu_torch.serve.config.
ServeConfig` shards over ``tp`` > 1 ranks (``mesh="dp=1,tp=N"``) is a
``torch.distributed`` world of its own. The fleet spawns one worker
(:mod:`~horovod_tpu_torch.serve.worker`) as usual; once its config and
weights have arrived over the RPC wire, the worker calls
:func:`start_world`, which starts ``tp - 1`` follower processes
(``python -m horovod_tpu_torch.serve.tp_replica``), meets them in a
``TCPStore`` the worker itself serves on loopback, and hands them the
config and the dense weights over the world's group. The worker is
rank 0 of the world, the engine's controller: it serves the RPCs and
the heartbeat. Each follower builds the same engine and runs
:meth:`~horovod_tpu_torch.serve.engine.ServeEngine.follow` until the
controller closes it. A follower reads nothing from a filesystem: its
argv names the store, its rank and device, and the rest comes over the
group.

**Cards.** ``cards`` lists the card of each rank
(:func:`replica_cards`: replica ``i`` of a fleet on ``n`` cards takes
cards ``(i*tp + r) % n``). Ranks on distinct cards form an NCCL world,
so the engine captures its lane (``capture=True``); ranks that share a
card form a gloo world (NCCL refuses two ranks on one device), and the
lane runs eagerly. On the CPU every rank is a CPU rank over gloo.

**Followers die with the replica.** They run in the worker's process
group, so the fleet's kill of the worker (``killpg``) takes them too;
each also asks the kernel to kill it when its parent dies
(``PR_SET_PDEATHSIG``), or polls its parent where that is missing, so a
worker that crashes on its own leaves no follower blocked in a
collective. The group's timeout is the worker's ``--group-timeout``
(the fleet passes the larger of its ``spawn_timeout`` and
``rpc_deadline``), and an idle controller sends a keepalive well inside
it (:meth:`~horovod_tpu_torch.serve.engine.ServeEngine.keepalive`).
"""

from __future__ import annotations

import argparse
import atexit
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

#: Seconds a closed world's followers get to leave before they are
#: killed.
FOLLOWER_EXIT_S = 10.0


def replica_cards(replica: int, tp: int, ncards: int) -> List[int]:
    """The cards of a TP replica's ranks: replica ``i`` takes cards
    ``(i*tp + r) % ncards`` for its ranks ``r``, so the replicas of a
    fleet spread over the host's cards and share them only when there
    are fewer cards than ranks."""
    return [(replica * tp + r) % max(1, ncards) for r in range(tp)]


def rank_devices(device: str, tp: int, cards: Optional[Sequence[int]]):
    """``(devices, backend)`` of a TP replica's ranks: one card a rank
    (``cards``; all on ``device``'s card without it) over NCCL when the
    cards are distinct, else gloo; CPU ranks over gloo."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * tp, "gloo"
    if cards is None:
        cards = [dev.index or 0] * tp
    devices = [torch.device("cuda", int(c)) for c in cards]
    return devices, "nccl" if len(set(cards)) == tp else "gloo"


class TpWorld:
    """A started replica world (:func:`start_world`): the controller's
    ``engine``, the follower processes, the backend and the cards."""

    def __init__(self, engine, followers: List[subprocess.Popen],
                 backend: str, devices):
        self.engine = engine
        self.followers = followers
        self.backend = backend
        self.devices = [str(d) for d in devices]

    def describe(self) -> Dict:
        """The world as the worker's ``ping`` reports it."""
        return {"degree": len(self.devices), "backend": self.backend,
                "devices": self.devices,
                "followers": [p.pid for p in self.followers]}

    def close(self, lock) -> None:
        """End the followers: close the engine under the worker's engine
        ``lock`` (their ``follow()`` returns), give them
        :data:`FOLLOWER_EXIT_S` to leave, kill what is left, and reap."""
        try:
            with lock:
                self.engine.close()
        finally:
            _reap(self.followers, FOLLOWER_EXIT_S)


def _reap(procs: List[subprocess.Popen], grace: float = 0.0) -> None:
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _timedelta(seconds: float):
    import datetime

    return datetime.timedelta(seconds=float(seconds))


def start_world(cfg_kwargs: Dict, params, *, device: str = "cuda",
                cards: Optional[Sequence[int]] = None,
                timeout: float = 300.0) -> TpWorld:
    """Rank 0 of a TP replica's world (the module docstring): start the
    ``tp - 1`` followers, meet them, send them ``cfg_kwargs`` (a
    :class:`ServeConfig`'s fields) and the dense ``params``, and build
    the controller's engine. ``timeout`` (seconds) bounds the meeting
    and every collective of the group. A failure kills the followers."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import ServeEngine, broadcast_params

    cfg = ServeConfig(**cfg_kwargs)
    tp = cfg.tp_degree
    devices, backend = rank_devices(device, tp, cards)
    store = dist.TCPStore("127.0.0.1", 0, tp, is_master=True,
                          timeout=_timedelta(timeout),
                          wait_for_workers=False)
    followers = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.tp_replica",
         "--store", f"127.0.0.1:{store.port}", "--rank", str(r),
         "--world", str(tp), "--device", str(devices[r]),
         "--backend", backend, "--timeout", str(timeout),
         "--parent", str(os.getpid())])
        for r in range(1, tp)]
    atexit.register(_reap, followers)
    try:
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(backend, store=store, rank=0,
                                world_size=tp, timeout=_timedelta(timeout))
        dist.broadcast_object_list(
            [dict(cfg_kwargs)], src=0,
            device=devices[0] if backend == "nccl" else None)
        dense = broadcast_params(params, src=0, device=devices[0])
        engine = ServeEngine(dense, cfg, device=devices[0],
                             capture=backend == "nccl", chips=tp)
    except BaseException:
        _reap(followers)
        raise
    return TpWorld(engine, followers, backend, devices)


def _die_with_parent(parent: int) -> None:
    """Be killed when the process that started this one dies: the
    kernel's parent-death signal where there is one, else a thread that
    polls the parent."""
    try:
        import ctypes

        PR_SET_PDEATHSIG = 1
        libc = ctypes.CDLL(None, use_errno=True)
        if libc.prctl(PR_SET_PDEATHSIG, int(signal.SIGKILL)) != 0:
            raise OSError(ctypes.get_errno(), "prctl")
    except (OSError, AttributeError):
        def watch():
            while os.getppid() == parent:
                time.sleep(0.5)
            os._exit(1)

        threading.Thread(target=watch, daemon=True,
                         name="tp-follower-parent").start()
    if os.getppid() != parent:      # the parent died before the signal
        os._exit(1)


def follower_main(argv=None) -> int:
    """One follower of a TP replica (``python -m
    horovod_tpu_torch.serve.tp_replica --store HOST:PORT --rank R
    --world N --device D --backend B --timeout S --parent PID``): meet
    the controller, take the config and the weights over the group,
    build the engine and follow until the controller closes it."""
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve.tp_replica",
        description="One follower rank of a tensor-parallel replica.")
    ap.add_argument("--store", required=True,
                    help="the controller's TCPStore, host:port")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, required=True,
                    help="the group's timeout in seconds")
    ap.add_argument("--parent", type=int, required=True,
                    help="the controller's pid: this process dies with it")
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import ServeEngine, broadcast_params

    host, _, port = args.store.rpartition(":")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host, int(port), args.world, is_master=False,
                          timeout=_timedelta(args.timeout))
    dist.init_process_group(args.backend, store=store, rank=args.rank,
                            world_size=args.world,
                            timeout=_timedelta(args.timeout))
    box = [None]
    dist.broadcast_object_list(
        box, src=0, device=dev if args.backend == "nccl" else None)
    dense = broadcast_params(None, src=0, device=dev)
    eng = ServeEngine(dense, ServeConfig(**box[0]), device=dev,
                      capture=args.backend == "nccl", chips=args.world)
    del dense
    eng.follow()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(follower_main())
