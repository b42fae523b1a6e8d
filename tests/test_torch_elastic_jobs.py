"""Elastic jobs through the port's launcher, on the CPU:
``python -m horovod_tpu_torch.run --elastic`` over ranks that train with
:func:`horovod_tpu_torch.elastic.run_elastic` (the JAX package's
``tests/test_elastic.py::TestEndToEnd`` and ``TestEndToEndResize``).

* rank 1 killed at step 7 (``kill:rank=1,step=7``), at K = 1 and K = 3:
  the supervisor classifies the crash and relaunches once, and every
  rank's final state and last-write-wins loss trajectory equal the clean
  job's, bit for bit; rank 1 resumed from a snapshot, not from 0;
* a malformed plan and a resize outside the world bounds exit 2;
* ``stall:rank=1,step=5`` under ``HOROVOD_WATCHDOG_TIMEOUT=2``: the
  watchdog kills the silent rank, the incident is ``stalled``, and the
  relaunch finishes;
* a shrink from 2 ranks to 1 (``resize:rank=0,step=7,n=1``) consumes
  every sample of the global stream exactly once.

The ranks are this file run as a script (``MODE OUT CKPT ...``): each
trains a least-squares model on the CPU (``device="cpu"``, given by
name), importing torch and the port's ``elastic``, ``checkpoint`` and
``data`` modules only. As in the JAX package's workers, the ranks run no
collective: the resize worker evaluates the global batch on every rank,
so the state stays replicated bit for bit.
"""

import hashlib
import os
import sys

DEVICE = "cpu"
N, DIM, BATCH = 64, 4, 4
RESIZE_N = 512


def _digest(state):
    import torch

    from horovod_tpu_torch._pytree import flatten

    h = hashlib.sha256()
    for leaf in flatten(state)[0]:
        h.update(leaf.detach().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _write_final(out_dir, rank, state, resumed):
    final = os.path.join(out_dir, f"rank{rank}.final")
    with open(f"{final}.tmp", "w") as f:
        f.write(f"{_digest(state)} resumed={resumed}\n")
    os.replace(f"{final}.tmp", final)


def _lsq_step(state, batch):
    import torch

    w = state["w"].detach().requires_grad_(True)
    loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [w])
    return ({"w": w.detach() - state["lr"] * g, "lr": state["lr"],
             "step": state["step"] + 1}, {"loss": loss.detach()})


def _data(n, seed=0):
    import numpy as np

    root = np.random.RandomState(seed)
    return {"x": root.normal(size=(n, DIM)).astype(np.float32),
            "y": root.normal(size=(n, 1)).astype(np.float32)}


def _init_state():
    import torch

    return {"w": torch.zeros((DIM, 1), dtype=torch.float32, device=DEVICE),
            "lr": torch.tensor(0.05, device=DEVICE),
            "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}


def train_worker(out_dir, ckpt_dir, steps, every, k):
    """One rank of the kill/stall jobs: its own shard, no collective."""
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.checkpoint import CheckpointManager

    steps, every, k = int(steps), int(every), int(k)
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    size = int(os.environ.get("HOROVOD_SIZE", "1"))
    source = elastic.ShardedBatchSource(_data(N), batch_size=BATCH,
                                        rank=rank, size=size, seed=0)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{rank}.traj"), "a") as traj:
        def on_step(completed, metrics):
            # repr() keeps every bit of the float: an exact comparison.
            traj.write(f"{completed} {float(metrics['loss'])!r}\n")
            traj.flush()

        with CheckpointManager(os.path.join(ckpt_dir, f"rank{rank}"),
                               backend="numpy") as manager:
            state, _, resumed = elastic.run_elastic(
                _lsq_step, _init_state(), source.batch_at, steps,
                manager=manager, snapshot_every=every, spill_every=1,
                steps_per_dispatch=k, on_step=on_step)
    _write_final(out_dir, rank, state, resumed)


def resize_worker(out_dir, ckpt_dir, total_samples, every, k):
    """One rank of the resize job: every rank evaluates the GLOBAL batch
    (all ranks' shards), so the state is replicated without collectives;
    the budget is in samples, so the global stream is the same at any
    world size. Logs ``S <attempt> <size> <step> <watermark> <ids...>``
    per step and ``Z <old> <new> <lr>`` when the LR is rescaled."""
    import numpy as np
    import torch

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.checkpoint import CheckpointManager

    total_samples, every, k = int(total_samples), int(every), int(k)
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    size = int(os.environ.get("HOROVOD_SIZE", "1"))
    attempt = int(os.environ.get("HOROVOD_ELASTIC_RESTART", "0"))
    arrays = _data(RESIZE_N)
    sources = [elastic.ShardedBatchSource(arrays, batch_size=BATCH, rank=r,
                                          size=size, seed=0)
               for r in range(size)]
    own = sources[rank]
    global_batch = BATCH * size
    num_steps = total_samples // global_batch

    def batch_for(step):
        parts = [s.batch_at(step) for s in sources]
        return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

    os.makedirs(out_dir, exist_ok=True)
    traj = open(os.path.join(out_dir, f"rank{rank}.traj"), "a")
    samples = open(os.path.join(out_dir, f"rank{rank}.samples"), "a")

    def on_step(completed, metrics):
        traj.write(f"{completed} {float(metrics['loss'])!r}\n")
        traj.flush()
        for s in range(completed - k, completed):
            ids = np.concatenate([src.indices_at(s) for src in sources])
            samples.write(f"S {attempt} {size} {s} {s * global_batch} "
                          + " ".join(str(int(i)) for i in ids) + "\n")
        samples.flush()

    def on_resize(old_world, new_world, st):
        st = dict(st, lr=st["lr"] * (new_world / old_world))
        samples.write(f"Z {old_world} {new_world} {float(st['lr'])!r}\n")
        samples.flush()
        return st

    try:
        state, _, resumed = elastic.run_elastic(
            _lsq_step, _init_state(), batch_for, num_steps,
            manager=CheckpointManager(os.path.join(ckpt_dir, f"rank{rank}"),
                                      backend="numpy"),
            snapshot_every=every, spill_every=1, steps_per_dispatch=k,
            on_step=on_step, world_size=size, rank=rank,
            cursor_fn=own.cursor,
            resume_manager=CheckpointManager(
                os.path.join(ckpt_dir, "rank0"), backend="numpy"),
            remap_step=own.resume_step, on_resize=on_resize)
    finally:
        traj.close()
        samples.close()
    _write_final(out_dir, rank, state, resumed)


if __name__ == "__main__":
    # A rank of one of the jobs below: nothing past this point runs.
    mode, *args = sys.argv[1:]
    {"train": train_worker, "resize": resize_worker}[mode](*args)
    sys.exit(0)


import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve()


def _clean_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("HOROVOD_FAULT_PLAN", None)
    env.pop("HOROVOD_HEARTBEAT_DIR", None)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _cli(args, mode, out, ckpt, *worker_args, env=None, timeout=300):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", *args,
           sys.executable, str(HERE), mode, str(out), str(ckpt),
           *map(str, worker_args)]
    return subprocess.run(cmd, env=env or _clean_env(), cwd=str(REPO),
                          timeout=timeout, capture_output=True, text=True)


def _job(tmp_path, tag, k, fault=None, env=None, steps=18, every=3):
    args = ["-np", "2", "--elastic", "--max-restarts", "1"]
    if fault:
        args += ["--fault-plan", fault]
    out = tmp_path / f"{tag}-out"
    proc = _cli(args, "train", out, tmp_path / f"{tag}-ckpt", steps, every,
                k, env=env)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return out, proc


def _last_wins(path: Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        step, value = line.split()
        out[int(step)] = value
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_killed_rank_resumes_bit_exact(tmp_path, k):
    clean, _ = _job(tmp_path, f"clean{k}", k)
    fault, proc = _job(tmp_path, f"fault{k}", k, fault="kill:rank=1,step=7")
    assert "crashed" in proc.stderr
    assert proc.stderr.count("relaunching all 2 rank(s)") == 1
    for rank in (0, 1):
        want = (clean / f"rank{rank}.final").read_text().split()
        got = (fault / f"rank{rank}.final").read_text().split()
        assert got[0] == want[0]
        assert _last_wins(fault / f"rank{rank}.traj") == \
            _last_wins(clean / f"rank{rank}.traj")
        assert len(_last_wins(clean / f"rank{rank}.traj")) == 18 // k
    # The kill fires at the first boundary at or past step 7 (7, or 9 in
    # windows of 3), after that boundary's snapshot at K = 3.
    assert (fault / "rank1.final").read_text().split()[1] == \
        f"resumed={6 if k == 1 else 9}"


@pytest.mark.parametrize("flags,needle", [
    (["-np", "1", "--elastic", "--fault-plan", "explode:rank=0"],
     "fault plan"),
    (["-np", "2", "--elastic", "--fault-plan",
      "resize:rank=0,step=7,n=1"], "bounds"),
])
def test_bad_plans_are_usage_errors(tmp_path, flags, needle):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", *flags,
         sys.executable, "-c", "pass"], env=_clean_env(), cwd=str(REPO),
        timeout=120, capture_output=True, text=True)
    assert proc.returncode == 2
    assert needle in proc.stderr


def test_stalled_rank_is_killed_by_the_watchdog(tmp_path):
    out, proc = _job(tmp_path, "stall", 1, fault="stall:rank=1,step=5",
                     env=_clean_env(HOROVOD_WATCHDOG_TIMEOUT="2"))
    assert "health watchdog" in proc.stderr
    assert "stalled" in proc.stderr
    assert proc.stderr.count("relaunching") == 1
    for rank in (0, 1):
        assert (out / f"rank{rank}.final").exists()
    assert "resumed=0" not in (out / "rank1.final").read_text()


def test_shrink_2_to_1_covers_the_stream_once(tmp_path):
    import numpy as np

    from horovod_tpu_torch.data.sharding import shard_indices

    total = 128
    out = tmp_path / "out"
    proc = _cli(["-np", "2", "--elastic", "--max-restarts", "1",
                 "--min-np", "1", "--fault-plan",
                 "resize:rank=0,step=7,n=1"], "resize", out,
                tmp_path / "ckpt", total, 4, 1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resized" in proc.stderr
    assert "resizing world 2 -> 1" in proc.stderr
    # 7 steps at world 2 = 56 samples = step 14 at world 1.
    assert "resumed=14" in (out / "rank0.final").read_text()
    lines = (out / "rank0.samples").read_text().splitlines()
    assert any(line.startswith("Z 2 1 ") for line in lines)
    attempts = {}
    for line in lines:
        parts = line.split()
        if parts[0] != "S":
            continue
        a, size, _, watermark = map(int, parts[1:5])
        attempts.setdefault(a, []).append(
            (watermark, size, [int(x) for x in parts[5:]]))
    consumed = {}
    for a in sorted(attempts):
        w0 = min(w for w, _, _ in attempts[a])
        for i, w in list(consumed.items()):
            if w >= w0:
                del consumed[i]          # a discarded lineage
        for w, size, ids in sorted(attempts[a]):
            assert len(ids) == BATCH * size
            for i in ids:
                assert i not in consumed, f"sample {i} consumed twice"
                consumed[i] = w
    final = attempts[max(attempts)]
    assert max(w + len(ids) for w, _, ids in final) == total
    assert len(consumed) == total
    stream = shard_indices(RESIZE_N, epoch=0, rank=0, size=1, shuffle=True,
                           seed=0)[:total]
    assert set(consumed) == {int(x) for x in np.asarray(stream)}
