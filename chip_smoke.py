#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (exit code 1, no result line):

1. device: torch/CUDA versions and the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build: every kernel source of the port, one ``nvcc`` per source;
3. kernels: each kernel against its plain PyTorch version over a sweep
   of head dims and page sizes, then at the serving path's shapes
   (float32 and bfloat16), with its time, the
   plain version's, a library yardstick's and the least time the card
   could take (bytes over the HBM peak or operations over the peak
   rate, whichever is larger);
4. engine: the continuous-batching ``ServeEngine`` at full GPT-2-small
   width (12 layers, d_model 768, 12 heads, vocab 32000, random weights
   from a seed) serving 8 staggered requests, once with
   ``attention="paged"`` and once with ``"gather"``: every request
   finishes, the greedy streams are identical across the modes and
   equal ``lm_decode``'s, and the kernel ran once per layer per step
   with a live decode slot;
5. (``--profile`` only) the engine's workload again under
   ``torch.profiler``: device busy time, idle share, top kernels.

The second-to-last line is the ``{"kernels": [...]}`` record and the last
line ``{"ok": true, "device": {...}}``. The script imports nothing of
JAX and needs the checkout beside it: alone in a directory, or without a
CUDA device, it fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published peaks of an H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W): float32 outside the tensor cores, bfloat16, and HBM3.
# ``bound_ms`` is taken against these; the script also reports the
# device-to-device copy rate it reaches, for comparison.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_PEAK_BYTES_S = 3.35e12

# The serving geometry: tools/serve_bench.py's defaults at GPT-2-small
# width (Lmax 384, page_size 16, 8 decode slots, prefill_chunk 64,
# num_pages = (8 + 1) * 24 + 1).
LAYERS, D_MODEL, HEADS, VOCAB, FFN = 12, 768, 12, 32000, 3072
LMAX, PAGE, SLOTS, CHUNK = 384, 16, 8, 64
PPS = LMAX // PAGE
NUM_PAGES = (SLOTS + 1) * PPS + 1
HEAD_DIM = D_MODEL // HEADS
KERNEL_LENGTHS = [0, 1, 16, 17, 384, 100, 250, 383]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------- phase 1


def device_phase(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")
    return card


# ------------------------------------------------------------- phase 2


def build_phase():
    from horovod_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ------------------------------------------------------------- phase 3


def _kernel_inputs(torch, np, dtype, seed):
    """The serving shapes; ragged lengths incl. 0/1/16/17/384, shuffled
    physical pages, a NaN null page 0, 1e30 in the stale rows past each
    slot's length."""
    rng = np.random.default_rng(seed)
    S, H, D = SLOTS, HEADS, HEAD_DIM
    k = rng.standard_normal((NUM_PAGES, PAGE, H, D), dtype=np.float32)
    v = rng.standard_normal((NUM_PAGES, PAGE, H, D), dtype=np.float32)
    q = rng.standard_normal((S, H, D), dtype=np.float32)
    k[0] = np.nan
    v[0] = np.nan
    ids = rng.permutation(np.arange(1, NUM_PAGES))
    tables = np.zeros((S, PPS), np.int32)
    nxt = 0
    for s, ln in enumerate(KERNEL_LENGTHS):
        for j in range(-(-ln // PAGE)):
            tables[s, j] = ids[nxt]
            nxt += 1
        if ln % PAGE:
            last = tables[s, ln // PAGE]
            k[last, ln % PAGE:] = 1e30
            v[last, ln % PAGE:] = 1e30
    dev = "cuda"
    return (torch.tensor(q, device=dev, dtype=dtype),
            torch.tensor(k, device=dev, dtype=dtype),
            torch.tensor(v, device=dev, dtype=dtype),
            torch.tensor(tables, device=dev),
            torch.tensor(np.asarray(KERNEL_LENGTHS, np.int32), device=dev))


def _kernel_sweep(torch, np):
    """Every template instance of the kernel (head dims up to 32, 64,
    128, 256) at odd page sizes, against the plain version: lengths 0, 1,
    a page, a page + 1 and the full table, NaN null page, 1e30 stale
    rows, shuffled pages."""
    from horovod_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(3)
    cases = 0
    for D in (8, 32, 48, 100, 128, 256):
        for ps in (1, 5, 16):
            for dtype in (torch.float32, torch.bfloat16):
                S, H, pps = 5, 3, 6
                lens = [0, 1, ps, ps + 1, ps * pps]
                need = [-(-x // ps) for x in lens]
                P = 1 + sum(need) + 2
                k = rng.standard_normal((P, ps, H, D), dtype=np.float32)
                v = rng.standard_normal((P, ps, H, D), dtype=np.float32)
                k[0] = v[0] = np.nan
                ids = rng.permutation(np.arange(1, P))
                tab = np.zeros((S, pps), np.int32)
                nxt = 0
                for s, n in enumerate(need):
                    tab[s, :n] = ids[nxt:nxt + n]
                    nxt += n
                    if lens[s] % ps:
                        k[tab[s, n - 1], lens[s] % ps:] = 1e30
                        v[tab[s, n - 1], lens[s] % ps:] = 1e30
                args = [torch.tensor(a, device="cuda", dtype=dtype)
                        for a in (rng.standard_normal((S, H, D)), k, v)]
                args += [torch.tensor(tab, device="cuda"),
                         torch.tensor(np.asarray(lens, np.int32),
                                      device="cuda")]
                out = pa.paged_attention_decode(*args).float()
                ref = pa.paged_attention_decode_reference(*args).float()
                tol = TOL[str(dtype).split(".")[1]]
                check(bool(torch.isfinite(out).all())
                      and bool((out[0] == 0).all())
                      and torch.allclose(out, ref, atol=tol, rtol=tol),
                      f"kernel sweep D={D} ps={ps} {dtype}: max_abs_err "
                      f"{float((out - ref).abs().max())}")
                cases += 1
    torch.cuda.synchronize()
    log(f"kernel sweep: {cases} cases (D 8..256, page sizes 1/5/16, "
        "f32 + bf16) agree with the plain version")


def _time_cold_ms(torch, fn, flush, iters=100, warmup=10):
    """Mean device time of ``fn`` with the L2 cache flushed before every
    call (the engine reads each layer's pages cold: a step's pages and
    weights far exceed the 50 MB L2)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def _copy_rate(torch):
    """Measured device-to-device copy rate in bytes/s (read + write)."""
    n = 1 << 28                                   # 1 GiB of float32
    a = torch.empty(n, device="cuda")
    b = torch.empty_like(a)
    for _ in range(3):
        b.copy_(a)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        b.copy_(a)
    e1.record()
    e1.synchronize()
    rate = 2 * a.numel() * a.element_size() * 10 / (e0.elapsed_time(e1)
                                                    / 1e3)
    del a, b
    return rate


def kernel_phase(torch, np):
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import paged_attention as pa

    _kernel_sweep(torch, np)
    rate = _copy_rate(torch)
    log(f"device copy rate: {rate / 1e9:.1f} GB/s")
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        q, kp, vp, tables, lengths = _kernel_inputs(torch, np, dtype, 7)
        scale = 1.0 / math.sqrt(HEAD_DIM)
        out = pa.paged_attention_decode(q, kp, vp, tables, lengths, scale)
        ref = pa.paged_attention_decode_reference(q, kp, vp, tables,
                                                  lengths, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()),
              f"{dname}: NaN/inf in the kernel's output (null page or "
              "stale rows read)")
        idle = torch.tensor(KERNEL_LENGTHS, device="cuda") == 0
        check(bool((out[idle] == 0).all()), f"{dname}: idle lane not zero")
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dname]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        log(f"kernel paged_attention_decode[{dname}]: max_abs_err "
            f"{err:.3e} (atol=rtol={tol})")
        check(ok, f"{dname}: kernel disagrees with its plain version "
                  f"(max_abs_err {err})")

        # The yardstick: the same function as one gather + one
        # scaled_dot_product_attention call with a length mask.
        P, ps, H, D = kp.shape
        rows = (tables.long()[:, :, None] * ps
                + torch.arange(ps, device="cuda")).reshape(SLOTS, -1)
        mask = (torch.arange(LMAX, device="cuda")[None, :]
                < lengths.long()[:, None])[:, None, None, :]

        def library():
            kg = kp.reshape(P * ps, H, D)[rows].transpose(1, 2)
            vg = vp.reshape(P * ps, H, D)[rows].transpose(1, 2)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale)

        ms = _time_cold_ms(torch, lambda: pa.paged_attention_decode(
            q, kp, vp, tables, lengths, scale), flush)
        plain_ms = _time_cold_ms(
            torch, lambda: pa.paged_attention_decode_reference(
                q, kp, vp, tables, lengths, scale), flush)
        library_ms = _time_cold_ms(torch, library, flush)

        # Least work this run's data needs: the K/V rows below each
        # slot's length read once (the kernel never loads the rows past
        # it), q read and out written once, the live table entries and
        # the lengths read once; 4 flops per live K/V element (q.k and
        # p.v multiply-adds). Bytes over the HBM peak, operations over
        # the peak for the input type.
        elt = kp.element_size()
        live_pages = sum(-(-x // PAGE) for x in KERNEL_LENGTHS)
        nbytes = (sum(KERNEL_LENGTHS) * H * D * 2 * elt
                  + 2 * q.numel() * elt + live_pages * 4
                  + lengths.numel() * 4)
        flops = 4 * H * D * sum(KERNEL_LENGTHS)
        t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        results[dname] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"  ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{library_ms:.4f}  bound_ms {results[dname]['bound_ms']:.4f} "
            f"({nbytes} bytes at {HBM_PEAK_BYTES_S / 1e9:.0f} GB/s peak)")
    del flush
    return results, rate


# ------------------------------------------------------------- phase 4


def _requests(np):
    """8 requests, prompts of 64-256 tokens, 32 new tokens each, in three
    waves so that requests join and leave mid-batch."""
    rng = np.random.default_rng(1)
    lens = rng.integers(64, 257, 8)
    prompts = [rng.integers(0, VOCAB, int(n)).astype(np.int32)
               for n in lens]
    waves = [(prompts[0:3], 6), (prompts[3:6], 10), (prompts[6:8], 0)]
    return prompts, waves


def _top2_gap(torch, params, tokens):
    from horovod_tpu_torch.models.parallel_lm import lm_prefill

    with torch.no_grad():
        _, logits = lm_prefill(params, torch.tensor(
            tokens, dtype=torch.long, device="cuda")[None])
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


NEW_TOKENS = 32


def _warm_engine(torch, params, prompts, mode):
    """An engine in ``mode``, warmed by one short request, metrics reset."""
    from horovod_tpu_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(params, ServeConfig(
        page_size=PAGE, num_pages=NUM_PAGES, decode_slots=SLOTS,
        prefill_chunk=CHUNK, attention=mode), device="cuda")
    eng.submit(prompts[0][:16], 4)
    eng.run()
    torch.cuda.synchronize()
    eng.reset_metrics()
    return eng


def _serve(torch, eng, waves):
    """Submit the waves, drain, synchronise; returns (requests, wall s)."""
    t0 = time.perf_counter()
    reqs = []
    for wave, steps in waves:
        reqs += [eng.submit(p, NEW_TOKENS) for p in wave]
        for _ in range(steps):
            eng.step()
    eng.run(max_steps=2000)
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def engine_phase(torch, np):
    from horovod_tpu_torch.models.parallel_lm import (init_lm_params,
                                                      lm_decode)
    from horovod_tpu_torch.ops.paged_attention import paged_attention_decode

    t0 = time.perf_counter()
    params = init_lm_params(0, VOCAB, LMAX, LAYERS, HEADS, HEAD_DIM, FFN,
                            device="cuda")
    log(f"engine: params {sum(p.numel() for p in _leaves(params))} "
        f"float32 on the card in {time.perf_counter() - t0:.1f} s")
    prompts, waves = _requests(np)
    runs = {}
    for mode in ("paged", "gather"):
        eng = _warm_engine(torch, params, prompts, mode)
        paged_attention_decode.launches = 0
        reqs, wall = _serve(torch, eng, waves)
        launches = paged_attention_decode.launches
        live_steps = sum(1 for s in eng.attn_len_samples if any(s))
        stats = eng.stats()
        runs[mode] = dict(reqs=reqs, launches=launches,
                          live_steps=live_steps, steps=eng.steps,
                          stats=stats, wall=wall)
        check(all(r.state == "finished" and len(r.output) == NEW_TOKENS
                  for r in reqs),
              f"{mode}: not every request finished: "
              f"{[(r.state, len(r.output)) for r in reqs]}")
        log(f"engine[{mode}]: {len(reqs)} requests, {eng.steps} steps "
            f"({live_steps} with a live decode slot), wall {wall:.3f} s, "
            f"tokens/s {stats['tokens_per_sec_per_chip']}, TTFT ms p50 "
            f"{stats['ttft_ms']['p50']} p99 {stats['ttft_ms']['p99']}, "
            f"per-token ms p50 {stats['tbt_ms']['p50']} p99 "
            f"{stats['tbt_ms']['p99']}, kernel launches {launches}")

    paged, gather = runs["paged"], runs["gather"]
    check(paged["launches"] == LAYERS * paged["live_steps"],
          f"paged: {paged['launches']} kernel launches, expected "
          f"{LAYERS} x {paged['live_steps']} live decode steps")
    check(paged["launches"] > 0, "paged: the kernel never ran")
    check(gather["launches"] == 0, "gather mode launched the kernel")
    for i, (a, b) in enumerate(zip(paged["reqs"], gather["reqs"])):
        j = _first_divergence(a.output, b.output)
        if j is not None:
            gap = _top2_gap(torch, params,
                            list(prompts[i]) + list(b.output[:j]))
            raise SmokeFailure(
                f"request {i}: paged and gather streams diverge at "
                f"generated position {j} (top-2 logit gap there {gap:.3e})")
    log(f"engine: {len(prompts)} greedy streams identical across paged "
        "and gather")
    for i in (0, 1):
        ref = lm_decode(params, prompts[i][None], NEW_TOKENS,
                        device="cuda")[0].tolist()
        j = _first_divergence(gather["reqs"][i].output, ref)
        if j is not None:
            gap = _top2_gap(torch, params, list(prompts[i]) + ref[:j])
            raise SmokeFailure(
                f"request {i}: engine and lm_decode diverge at generated "
                f"position {j} (top-2 logit gap there {gap:.3e})")
    log("engine: streams 0 and 1 equal lm_decode's")
    return runs, params, prompts, waves


def profile_phase(torch, params, prompts, waves):
    """``--profile``: the engine phase's workload again, per mode, under
    ``torch.profiler``: device busy time (the sum of kernel and copy
    times; one stream, so they do not overlap), the idle share of the
    profiled wall time, and the kernels that take the most device time.
    The profiler's own host overhead lengthens the wall time, so the
    idle share here is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode in ("paged", "gather"):
        eng = _warm_engine(torch, params, prompts, mode)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _serve(torch, eng, waves)
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in dev)
        check(busy_us > 0, f"profile[{mode}]: no device events traced")
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
        out[mode] = {
            "wall_s": wall, "steps": eng.steps,
            "device_busy_s": busy_us / 1e6,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top],
        }
        log(f"profile[{mode}]: wall {wall:.3f} s, device busy "
            f"{busy_us / 1e6:.3f} s, idle share "
            f"{out[mode]['idle_share']:.3f}")
    print(json.dumps({"profile": out}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- main


def main():
    import numpy as np
    import torch

    card = device_phase(torch)
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script "
                           f"({e}); run from the root of a checkout")
    build_phase()
    kres, rate = kernel_phase(torch, np)
    runs, params, prompts, waves = engine_phase(torch, np)
    if "--profile" in sys.argv[1:]:
        profile_phase(torch, params, prompts, waves)
    f32, bf16 = kres["float32"], kres["bfloat16"]
    record = {"kernels": [{
        "name": "paged_attention_decode",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_attention.cu",
        "replaces": "horovod_tpu/ops/paged_attention.py:55",
        "launches": runs["paged"]["launches"],
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "dtype": "float32",
        "shape": {"S": SLOTS, "H": HEADS, "D": HEAD_DIM, "page_size": PAGE,
                  "pages_per_seq": PPS, "num_pages": NUM_PAGES,
                  "lengths": KERNEL_LENGTHS},
        "copy_GBps": rate / 1e9,
        "bfloat16": {k: bf16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by")},
        "card": card,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
