"""The gloo worlds of the port's tests (``tests/gloo_worlds.py``).

Two worlds started at the same moment from one process both come up:
their ranks meet through a ``FileStore`` in each world's own directory,
so neither picks a port the other (or any other test's world) could
take. The workers here leave their process groups standing, as a test's
worker may: ``run_rank`` destroys them before the process exits.
"""

import os
import threading

import torch

import gloo_worlds


def _worker(rank, n, init, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    torch.save({"sum": float(t), "init": init},
               os.path.join(out, f"rank{rank}.pt"))


def test_two_worlds_started_together_both_come_up(tmp_path):
    outs = [tmp_path / "a", tmp_path / "b"]
    for d in outs:
        d.mkdir()
    start = threading.Barrier(2)
    errors = []

    def world(out):
        start.wait()
        try:
            gloo_worlds.start_world(2, out, "test_torch_worlds", timeout=120)
        except BaseException as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=world, args=(d,)) for d in outs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    assert not errors, errors
    inits = set()
    for d in outs:
        got = [torch.load(d / f"rank{r}.pt") for r in range(2)]
        assert [g["sum"] for g in got] == [3.0, 3.0]
        assert got[0]["init"] == got[1]["init"]
        inits.add(got[0]["init"])
    assert len(inits) == 2
    assert all(i.startswith(f"file://{d}") for i, d in
               zip(sorted(inits), sorted(map(str, outs))))


def test_init_url_names_a_fresh_file_and_no_port(tmp_path):
    a, b = gloo_worlds.init_url(tmp_path), gloo_worlds.init_url(tmp_path)
    assert a != b and a.startswith(f"file://{tmp_path}/store-")
    assert not os.path.exists(a[len("file://"):])
