"""The port's timeline: per-bucket spans of the gradient exchange.

A 2-rank gloo world (two processes, started once for the module) runs,
with ``HOROVOD_TIMELINE`` naming a file and
``HOROVOD_TIMELINE_MARK_CYCLES=1``: one overlapped ``fused_reduce`` whose
plan has buckets above and below the scatter threshold, then one
``DistributedOptimizer`` step whose buckets start from gradient hooks.
Rank 0 writes the Chrome trace; rank 1 writes nothing.

* The trace parses as Chrome's JSON array format (the writer leaves the
  array open, as the reference's does).
* Each bucket has one track and, per reduction, one ALLREDUCE span with
  MEMCPY_IN_FUSION_BUFFER and MEMCPY_OUT_FUSION_BUFFER inside it, and
  REDUCESCATTER then ALLGATHER between them for a scatter bucket; the
  span's args name the path and the issue index.
* Under overlap every bucket's span opens before the first one closes:
  the trace shows the buckets in flight together. The optimizer step's
  spans open inside the backward pass and a CYCLE_START marks the step.
* Without the knob the timeline is off and nothing is queued.
* ``horovod_tpu_torch.utils.timeline`` is the JAX module's code, copied.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# Bucket sizes in float32 elements at a 400-byte threshold: 101 (404 B,
# oversize), 33 + 35 (272 B), 64 (256 B). A scatter threshold of 300 B
# sends the first bucket through the reduce-scatter + all-gather form.
SHAPES = [(101,), (33,), (7, 5), (64,)]
THRESHOLD = 400
SCATTER = 300


def _worker(rank, port, out):
    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models.train import next_token_loss
    from horovod_tpu_torch.models.transformer import TransformerLM

    os.environ["HOROVOD_TIMELINE"] = os.path.join(out, "trace.json")
    os.environ["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    ts = [torch.ones(s) * (rank + 1) for s in SHAPES]
    hvd.fused_reduce(ts, fusion_threshold=THRESHOLD, overlap="on",
                     scatter_threshold=SCATTER, name="t")
    model = TransformerLM(vocab_size=32, num_layers=1, num_heads=2,
                          embed_dim=16, max_len=16, dtype=torch.float32,
                          device="cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   overlap="on", fusion_threshold=4000)
    toks = torch.arange(16).reshape(2, 8) % 32
    n_plan = len(opt._hvd_exchange.plan)
    marks = {}
    marks["backward_start"] = basics.timeline()._now_us()
    next_token_loss(model(toks), toks).backward()
    marks["backward_end"] = basics.timeline()._now_us()
    opt.step()
    hvd.shutdown()
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"n_plan": n_plan, **marks}, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("timeline"))
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_timeline as m; m._worker({}, {}, {!r})")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_TIMELINE")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(str(REPO / "tests"), str(REPO),
                                           r, port, out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=60)
            logs.append(stdout + stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(os.path.join(out, "trace.json")) as f:
        text = f.read()
    with open(os.path.join(out, "rank0.json")) as f:
        meta = json.load(f)
    return text, meta, sorted(os.listdir(out))


def _events(text):
    assert text.startswith("[\n")
    return json.loads(text.rstrip().rstrip(",") + "]")


def _tracks(events):
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    per = {}
    for e in events:
        if e.get("ph") in ("B", "E"):
            per.setdefault(names[e["tid"]], []).append(e)
    return per


def _spans(evs):
    """Each ALLREDUCE span of a track as (args, open ts, close ts, the
    activity names inside, in order)."""
    out, stack, cur = [], [], None
    for e in evs:
        if e["ph"] == "B":
            if e["name"] == "ALLREDUCE":
                cur = [e.get("args", {}), e["ts"], None, []]
            else:
                cur[3].append(e["name"])
            stack.append(e["name"])
        else:
            name = stack.pop()
            if name == "ALLREDUCE":
                cur[2] = e["ts"]
                out.append(tuple(cur))
    assert not stack
    return out


def test_trace_parses_and_only_rank_zero_writes(traced):
    text, _, files = traced
    events = _events(text)
    assert files == ["rank0.json", "rank1.json", "trace.json"]
    assert all(isinstance(e, dict) and "ph" in e for e in events)


def test_one_allreduce_span_per_bucket_with_its_activities(traced):
    tracks = _tracks(_events(traced[0]))
    fused = {k: v for k, v in tracks.items() if k.startswith("t.")}
    assert sorted(fused) == ["t.float32.b0", "t.float32.b1",
                             "t.float32.b2"]
    for name, evs in fused.items():
        (args, t0, t1, inner), = _spans(evs)
        scatter = name == "t.float32.b0"
        assert args["path"] == ("rs_ag" if scatter else "allreduce")
        assert inner == (["MEMCPY_IN_FUSION_BUFFER", "REDUCESCATTER",
                          "ALLGATHER", "MEMCPY_OUT_FUSION_BUFFER"]
                         if scatter else ["MEMCPY_IN_FUSION_BUFFER",
                                          "MEMCPY_OUT_FUSION_BUFFER"])
        assert t0 <= t1
    # Reverse plan order, every bucket in flight before the first unpack.
    spans = {n: _spans(v)[0] for n, v in fused.items()}
    assert [spans[f"t.float32.b{i}"][0]["issue"] for i in range(3)] == \
        [2, 1, 0]
    assert max(s[1] for s in spans.values()) <= min(
        s[2] for s in spans.values())


def test_optimizer_buckets_open_inside_the_backward_pass(traced):
    text, meta, _ = traced
    events = _events(text)
    tracks = _tracks(events)
    grads = {k: _spans(v) for k, v in tracks.items()
             if k.startswith("grads.")}
    assert len(grads) == meta["n_plan"] >= 2
    for spans in grads.values():
        (args, t0, t1, inner), = spans
        assert meta["backward_start"] <= t0 <= meta["backward_end"] <= t1
        assert inner == ["MEMCPY_IN_FUSION_BUFFER",
                         "MEMCPY_OUT_FUSION_BUFFER"]
    assert sum(e.get("name") == "CYCLE_START" for e in events) == 1


def test_nothing_is_emitted_without_the_knob(monkeypatch):
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics

    monkeypatch.delenv("HOROVOD_TIMELINE", raising=False)
    hvd.init(device="cpu")
    try:
        tl = basics.timeline()
        assert not tl.enabled
        hvd.fused_reduce([torch.ones(s) for s in SHAPES],
                         fusion_threshold=THRESHOLD, overlap="on")
        assert tl._queue.empty()
    finally:
        hvd.shutdown()


def test_the_timeline_is_the_jax_modules_code():
    def body(path):
        text = (REPO / path).read_text()
        return text[text.index("from __future__"):]

    assert body("horovod_tpu_torch/utils/timeline.py") == body(
        "horovod_tpu/utils/timeline.py")
