"""The rank processes of tests/test_torch_autotune.py's gloo world of two,
and the helpers that the test module shares with them. Kept apart from
the test module so that a rank imports no JAX."""

import math
import os
import time

import torch

from horovod_tpu_torch import distributed as thvd
from horovod_tpu_torch.common import basics

MB = 1 << 20


class Clock:
    """The fake ``time.perf_counter``: it moves only when told to."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def xform(threshold):
    return math.log2(1.0 + threshold / float(MB))


def make_net(seed=0):
    """Four parameter tensors of 4, 12, 2 and 8 KB (float32)."""
    torch.manual_seed(seed)
    return torch.nn.ParameterList([torch.nn.Parameter(torch.randn(s))
                                   for s in (1024, 3072, 512, 2048)])


def net_loss(net, seed):
    g = torch.Generator().manual_seed(seed)
    return sum(((p - torch.randn(p.shape, generator=g)) ** 2).mean()
               for p in net)


def rank_curve(rank):
    """Rank 0's step times have their valley at 8 MB, rank 1's at 1 MB."""
    target = math.log2(9.0) if rank == 0 else 1.0
    return lambda t, h: 1.0 + (xform(t) - target) ** 2


def _worker(rank, n, init, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    os.environ["HOROVOD_AUTOTUNE"] = "1"
    os.environ["HOROVOD_AUTOTUNE_LOG"] = os.path.join(out, f"log{rank}.tsv")
    clock = Clock()
    time.perf_counter = clock
    thvd.init(device="cpu")
    tuner = basics._state.autotuner
    tuner.window = 1
    default = basics.config().fusion_threshold
    raw, synced = [], []
    sync = tuner._sync_value

    def spy(value):
        raw.append(value)
        synced.append(sync(value))
        return synced[-1]

    tuner._sync_value = spy
    curve = rank_curve(rank)
    cands = [0, 4096, 8192, 16384, 12288, 2048]
    tuner.candidates = [tuner.candidates[0]] + [(c, False) for c in cands]
    tuner.max_probes = 5

    def train():
        net = make_net(seed=5)
        opt = thvd.DistributedOptimizer(torch.optim.Adam(net.parameters(),
                                                         lr=1e-2))
        for i in range(16):
            clock.now += curve(basics.config().fusion_threshold, False)
            opt.zero_grad()
            net_loss(net, 10 * i + rank).backward()
            opt.step()
        return [p.detach().clone() for p in net]

    tuned = train()
    res = {"probed": list(tuner.probed.items()), "raw": raw,
           "synced": synced, "converged": tuner.converged,
           "best": (tuner.best_threshold, tuner.best_score),
           "generation": tuner.generation,
           "threshold": basics.config().fusion_threshold}
    basics._state.autotuner = None
    basics.config().fusion_threshold = default
    untuned = train()
    res["tuned"] = [p.numpy() for p in tuned]
    res["tuned_equals_untuned"] = all(torch.equal(a, b)
                                      for a, b in zip(tuned, untuned))
    thvd.shutdown()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
