#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --engine-only [RUNS]

Phases, each fatal on failure (exit code 1, no result line):

1. device: torch/CUDA versions and the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build: every kernel source of the port, one ``nvcc`` per source, all
   started together;
3. kernels: K4 (paged decode, a split-K kernel and a merge kernel)
   against its plain PyTorch version over a sweep of head dims, page
   sizes and lengths on the edges of its row chunks, bit for bit the
   same on a second launch, then at the serving path's shapes and at a
   long-context geometry (32 slots of up to 2048 keys), float32 and
   bfloat16, with its time, its kernels' profiled device time, the
   plain version's time, a library yardstick's and the least time the
   card could take (bytes over the HBM peak or operations over the peak
   rate, whichever is larger);
4. flash: K1-K3 (flash forward, dQ, dK/dV) against their plain versions
   over a sweep (causal and not, square and rectangular, offset causal,
   lengths off the 64- and 128-row tiles, head dims 8-128, f32 and bf16,
   strided views), then at the training slice's shapes (B=8, L=2048,
   H=12, D=64, causal, bf16), with the same four times each;
5. conv_bn: K5 (fused 1x1 conv + BatchNorm statistics) against its
   plain version over a sweep (rows off the tile, K 8-2048, prologue on
   and off with positive shifts, strided NHWC views, f32 and bf16), then
   at ResNet-50's 16 1x1 shapes (batch 64, 224^2, bf16), with the four
   times each and their sums over one training step's 36 launches;
6. training: the bench lane's data-parallel step at GPT-2-small width
   (12 layers, d_model 768, 12 heads, vocab 32000, seq 2048, batch 8,
   bf16 compute, random weights from a seed) on flash attention, Adam
   1e-4 under ``DistributedOptimizer``, an NCCL world of one, a few
   steps on one fixed batch: the losses are finite and fall, K1 ran 12
   times per forward pass and K2/K3 12 times per backward pass, the
   NCCL bucket collectives equal the bucket plan times the steps, and
   one step with dense attention at batch 2 matches flash's loss and
   gradient norm;
7. resnet: the image bench lane's step, ResNet-50 at full width with the
   JAX lane's defaults (224^2 synthetic images, 64 per card, 1000
   classes, bf16, SGD 0.01 momentum 0.9 under ``DistributedOptimizer``)
   with ``fused_bn``, an NCCL world of one, a few steps on one fixed
   batch: the losses are finite and fall, K5 ran 36 times per step (16
   with the prologue), the bucket collectives equal the plan times the
   steps, and one step from the same weights with unfused BatchNorm
   (cuDNN 1x1 convs, statistics as a separate pass) matches the fused
   loss, running means and gradient norm;
8. engine: the continuous-batching ``ServeEngine`` at full GPT-2-small
   width serving 8 staggered requests, once with ``attention="paged"``
   and once with ``"gather"``: every request finishes, the greedy
   streams are identical across the modes and equal ``lm_decode``'s,
   and K4 ran once per layer per step with a live decode slot;
9. (``--profile`` only) two training steps of each lane and the
   engine's workload again under ``torch.profiler``: device busy time,
   idle share, top kernels.

``--engine-only`` runs phases 1 and 8 alone, the engine phase RUNS times
(default 3) with all its checks, and prints one ``{"engine_runs": [...]}``
line of each run's tokens/s, TTFT and per-token p50/p99 per mode, and no
kernels or ok line: copied into another checkout, it serves that
checkout's package with the same script, to compare two commits' serving
on one card.

Each kernel's launch count is set to 0 just before the phase that drives
its path and read just after; launches made to compare or time a kernel
do not count.

The second-to-last line is the ``{"kernels": [...]}`` record (K1-K5) and
the last line ``{"ok": true, "device": {...}}``. The script imports nothing of
JAX and needs the checkout beside it: alone in a directory, or without a
CUDA device, it fails.
"""

from __future__ import annotations

import json
import math
import re
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
# Kernel against plain version, atol = rtol. float32: the same float32
# arithmetic summed in another order (errors of a few 1e-7 relative on
# the sweep's sums). bfloat16: both round their outputs (one bf16 ulp is
# 2^-8 relative) and the softmax weights / dS to bf16 inside, where a
# last-bit difference in the float32 value before the rounding moves one
# term by an ulp.
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


def _kernel_name(line):
    """The kernel of a ptxas "Function properties for <mangled>" line:
    the name whose length prefix fits and ends in "kernel", with its
    template arguments (``flash_bwd_dq_tc_kernelILi64``)."""
    for m in re.finditer(r"\d+(?=[a-z_])", line):
        for i in range(len(m.group())):          # "N_122name": 1 | 22
            end = m.end() + int(m.group()[i:])
            if line[m.end():end].endswith("kernel"):
                rest = line[end:]
                return line[m.end():end] + (rest.split("EE")[0]
                                            if rest.startswith("I") else "")
    return line.split()[-1][:60]


def build_phase():
    from horovod_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, b in built.items():
        fn = ""
        for line in b.log.splitlines():
            if "Function properties for" in line:
                fn = _kernel_name(line)
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower() or "Performance" in line):
                log(f"  ptxas {name} {fn}: {line.strip()}")
                ptxas.setdefault(name, {}).setdefault(fn, []).append(
                    line.strip())
    return ptxas


# ------------------------------------------------------------- phase 3


def _kernel_sweep(torch, np):
    """K4 against its plain version: every template instance (16-byte
    loads by 4, 8, 16 or 32 lanes a row, one load a lane or two; the
    element path at D = 100 in bf16 and at a base off the 16-byte grid)
    at odd page sizes, lengths 0, 1, a page, a page + 1 and
    the full table; then tables of 4 chunks or more with lengths on the
    chunk edges (R - 1, R, R + 1, 2R, 3R + 1). NaN null page, 1e30 stale
    rows, shuffled pages. A second launch must give the same bits."""
    from horovod_tpu_torch.ops import paged_attention as pa

    R = pa.CHUNK_ROWS
    cases = [(D, ps, 6, [0, 1, ps, ps + 1, ps * 6], False)
             for D in (8, 32, 48, 100, 128, 256) for ps in (1, 5, 16)]
    for D in (64, 100, 256):
        for ps in (5, 16):
            pps = -(-(3 * R + 8) // ps)
            cases.append((D, ps, pps, [0, 1, R - 1, R, R + 1, 2 * R,
                                       3 * R + 1, ps * pps], False))
    cases.append((64, 16, 16, [0, 1, R - 1, R + 1, 3 * R + 1], True))
    n = 0
    for i, (D, ps, pps, lens, offset) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            args = list(pa.decode_inputs(lens, 3, D, ps, pps, dtype, seed=i))
            if offset:                # contiguous, 2 or 4 bytes off 16
                for j in (1, 2):
                    buf = torch.empty(args[j].numel() + 1, dtype=dtype,
                                      device="cuda")
                    args[j] = buf[1:].view(args[j].shape).copy_(args[j])
            out = pa.paged_attention_decode(*args)
            again = pa.paged_attention_decode(*args)
            ref = pa.paged_attention_decode_reference(*args).float()
            tol = TOL[str(dtype).split(".")[1]]
            what = (f"kernel sweep D={D} ps={ps} pps={pps} lengths {lens} "
                    f"{dtype}{' off 16 bytes' if offset else ''}")
            check(torch.equal(out, again), f"{what}: a second launch "
                                           "changed an output bit")
            out = out.float()
            check(bool(torch.isfinite(out).all())
                  and bool((out[0] == 0).all())
                  and torch.allclose(out, ref, atol=tol, rtol=tol),
                  f"{what}: max_abs_err {float((out - ref).abs().max())}")
            n += 1
    torch.cuda.synchronize()
    log(f"kernel sweep: {n} cases (D 8..256, page sizes 1/5/16, up to "
        f"{max(-(-c[1] * c[2] // R) for c in cases)} chunks of {R} rows, "
        "f32 + bf16) agree with the plain version and repeat bit for bit")


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
    """K4 at the serving shapes and at the long-context geometry, f32 and
    bf16: agreement with the plain version, then the cold-L2 time of the
    call (``ms``), its two kernels' profiled time (``device_ms``), the
    plain version's and the library yardstick's times, and the bound."""
    import torch.nn.functional as F

    from horovod_tpu_torch._timing import (device_ms, flush_buffer,
                                           time_cold_ms)
    from horovod_tpu_torch.ops import paged_attention as pa

    _kernel_sweep(torch, np)
    rate = _copy_rate(torch)
    log(f"device copy rate: {rate / 1e9:.1f} GB/s")
    flush = flush_buffer()
    results = {}
    for geom in ("serving", "long"):
        g = pa.geometry(geom)
        lens = g["lengths"]
        S, H, D, ps = len(lens), g["H"], g["D"], g["ps"]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, kp, vp, tables, lengths = args = pa.decode_inputs(
                dtype=dtype, seed=7, **g)
            scale = 1.0 / math.sqrt(D)
            out = pa.paged_attention_decode(*args, scale)
            ref = pa.paged_attention_decode_reference(*args, scale)
            torch.cuda.synchronize()
            what = f"{geom} {dname}"
            check(bool(torch.isfinite(out).all()),
                  f"{what}: NaN/inf in the kernel's output (null page or "
                  "stale rows read)")
            check(bool((out[lengths == 0] == 0).all()),
                  f"{what}: idle lane not zero")
            err = float((out.float() - ref.float()).abs().max())
            tol = TOL[dname]
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            log(f"kernel paged_attention_decode[{what}]: max_abs_err "
                f"{err:.3e} (atol=rtol={tol})")
            check(ok, f"{what}: kernel disagrees with its plain version "
                      f"(max_abs_err {err})")

            # The yardstick: the same function as one gather + one
            # scaled_dot_product_attention call with a length mask.
            P = kp.shape[0]
            lmax = g["pps"] * ps
            rows = (tables.long()[:, :, None] * ps
                    + torch.arange(ps, device="cuda")).reshape(S, -1)
            mask = (torch.arange(lmax, device="cuda")[None, :]
                    < lengths.long()[:, None])[:, None, None, :]

            def library():
                kg = kp.reshape(P * ps, H, D)[rows].transpose(1, 2)
                vg = vp.reshape(P * ps, H, D)[rows].transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale)

            call = lambda: pa.paged_attention_decode(*args, scale)  # noqa
            ms = time_cold_ms(call, flush)
            dev_ms = device_ms(call, flush, pa.KERNEL_NAMES)
            plain_ms = time_cold_ms(
                lambda: pa.paged_attention_decode_reference(*args, scale),
                flush, iters=20, warmup=2)
            library_ms = time_cold_ms(library, flush, iters=20, warmup=2)
            # Least work this run's data needs (pa.decode_work): bytes
            # over the HBM peak, operations over the peak for the type.
            nbytes, flops = pa.decode_work(lens, H, D, ps, kp.element_size())
            t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            results.setdefault(geom, {"shape": {
                "S": S, "H": H, "D": D, "page_size": ps,
                "pages_per_seq": g["pps"], "num_pages": P,
                "lengths": lens}})[dname] = {
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
            }
            log(f"  ms {ms:.4f}  device_ms {dev_ms:.4f}  plain_ms "
                f"{plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
                f"{max(t_bytes, t_ops):.6f} ({nbytes} bytes at "
                f"{HBM_PEAK_BYTES_S / 1e9:.0f} GB/s peak)")
            del args, q, kp, vp, tables, lengths, out, ref, rows, mask
        torch.cuda.empty_cache()
    del flush
    return results, rate


# ------------------------------------------------------------- phase 4

# The training slice's attention shapes: bench defaults, batch 8 of seq
# 2048, 12 heads of 64, causal, bfloat16.
FLASH_B, FLASH_L = 8, 2048
# Sweep geometries: (Lq, Lk, causal, q_offset, k_offset). Lengths that
# are not multiples of the 64-row tiles or of the bf16 K1's 128-row query
# tile and K3's 128-row key tile (129, 136, 200, 255, 264, 320),
# rectangular shapes, offset causal masks, and causal keys past every
# query (K3 loops over nothing for them and must write zeros).
FLASH_GEOMS = [(200, 200, True, 0, 0), (128, 128, False, 0, 0),
               (64, 136, False, 0, 0), (72, 200, True, 128, 0),
               (128, 128, True, 40, 8), (64, 192, True, 0, 0),
               (136, 136, True, 0, 0), (320, 320, True, 0, 0),
               (64, 264, True, 200, 0), (192, 320, False, 0, 0),
               (129, 129, True, 0, 0), (255, 300, True, 45, 0)]
FLASH_HEAD_DIMS = (8, 32, 64, 100, 128)


def _strided(torch, x, pad):
    """``x`` [B, L, H, D] as a view with a head stride of ``D + pad``, as
    the model hands q/k/v over (views into one projection)."""
    B, L, H, D = x.shape
    buf = torch.zeros((B, L, H, D + pad), dtype=x.dtype, device=x.device)
    buf[..., :D] = x
    return buf[..., :D]


def _flash_case(torch, np, rng, B, H, D, Lq, Lk, dtype, pad=None):
    """q, k, v, dO: contiguous, or views padded by ``pad`` elements."""
    mk = (lambda *s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                  device="cuda").to(dtype))
    q, do = mk(B, Lq, H, D), mk(B, Lq, H, D)
    k, v = mk(B, Lk, H, D), mk(B, Lk, H, D)
    if pad is not None:
        q, k, v, do = (_strided(torch, t, pad) for t in (q, k, v, do))
    return q, k, v, do


def _flash_check(torch, fa, q, k, v, do, causal, qo, ko, tol, what):
    """Each of K1-K3 against its plain version on the same inputs; the
    backward kernels get the plain forward's lse and D, so each kernel
    is held alone. Returns the largest absolute error."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = fa.flash_forward(q, k, v, causal, scale, qo, ko)
    r_out, r_lse = fa.flash_forward_reference(q, k, v, causal, scale, qo, ko)
    d = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, r_lse, d, causal, scale, qo, ko)
    r_dq = fa.flash_bwd_dq_reference(q, k, v, do, r_lse, d, causal, scale,
                                     qo, ko)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, r_lse, d, causal, scale, qo, ko)
    r_dk, r_dv = fa.flash_bwd_dkv_reference(q, k, v, do, r_lse, d, causal,
                                            scale, qo, ko)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("out", out, r_out), ("lse", lse, r_lse),
                           ("dq", dq, r_dq), ("dk", dk, r_dk),
                           ("dv", dv, r_dv)):
        got, ref = got.float(), ref.float()
        errs[name] = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got, ref, atol=tol, rtol=tol),
              f"flash {what}: {name} disagrees with its plain version "
              f"(max_abs_err {errs[name]:.3e}, atol=rtol={tol})")
    return errs


def _flash_sweep(torch, np):
    from horovod_tpu_torch.ops import attention as fa

    rng = np.random.default_rng(11)
    cases = 0
    worst = {}
    for D in FLASH_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for i, (Lq, Lk, causal, qo, ko) in enumerate(FLASH_GEOMS):
                # Every other geometry pads the head stride to an odd
                # count, which takes the bf16 K2/K3 off their 16-byte
                # copies onto element loads at every head dim.
                q, k, v, do = _flash_case(torch, np, rng, 2, 3, D, Lq, Lk,
                                          dtype, pad=D + i % 2)
                errs = _flash_check(
                    torch, fa, q, k, v, do, causal, qo, ko, TOL[dname],
                    f"sweep D={D} {dname} Lq={Lq} Lk={Lk} causal={causal} "
                    f"offsets=({qo},{ko})")
                worst[dname] = max(worst.get(dname, 0.0), *errs.values())
                cases += 1
    log(f"flash sweep: {cases} cases (D {FLASH_HEAD_DIMS}, "
        f"{len(FLASH_GEOMS)} geometries, f32 + bf16, strided views, even "
        f"and odd head strides) agree with the plain versions; max_abs_err "
        f"{worst}")


def _flash_bounds(B, H, L, D, elt):
    """Least work of K1-K3 at a causal square shape: operations over the
    bf16 tensor-core peak and bytes over the HBM peak, counting only the
    live (query, key) pairs and each input read and output written once.
    K1: q.k and p.v, 4 flops per live pair and head-dim element; K2 adds
    dO.v and dS.k and drops p.v (6); K3 recomputes q.k and dO.v and does
    P^T.dO and dS^T.q (8)."""
    pairs = B * H * L * (L + 1) // 2
    tile = B * L * H * D * elt               # one [B, L, H, D] tensor
    stat = B * H * L * 4                     # one float32 [B, H, L]
    work = {
        "flash_forward": (4 * D * pairs, 3 * tile + tile + stat),
        "flash_bwd_dq": (6 * D * pairs, 4 * tile + 2 * stat + tile),
        "flash_bwd_dkv": (8 * D * pairs, 4 * tile + 2 * stat + 2 * tile),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": ("operations" if t_ops >= t_bytes
                                  else "bytes")}
    return out


def flash_phase(torch, np):
    """K1-K3 over the sweep, then at the slice shapes in bf16: agreement,
    then the cold-L2 time of each kernel, of its plain version and of
    the library yardstick (``scaled_dot_product_attention``; its backward
    through autograd stands for K2 and K3 together)."""
    import torch.nn.functional as F

    from horovod_tpu_torch._timing import flush_buffer, time_cold_ms
    from horovod_tpu_torch.ops import attention as fa

    _flash_sweep(torch, np)
    B, L, H, D = FLASH_B, FLASH_L, HEADS, HEAD_DIM
    rng = np.random.default_rng(12)
    q, k, v, do = _flash_case(torch, np, rng, B, H, D, L, L, torch.bfloat16)
    errs = _flash_check(torch, fa, q, k, v, do, True, 0, 0, TOL["bfloat16"],
                        f"slice B={B} L={L} H={H} D={D} bf16 causal")
    log(f"flash slice shapes: K1-K3 agree with the plain versions in bf16 "
        f"(max_abs_err {errs})")
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_forward(q, k, v, True, scale)
    d = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # No atomics anywhere: a second launch repeats every output bit.
    again = (fa.flash_forward(q, k, v, True, scale),
             (fa.flash_bwd_dq(q, k, v, do, lse, d, True, scale),),
             fa.flash_bwd_dkv(q, k, v, do, lse, d, True, scale))
    first = (fa.flash_forward(q, k, v, True, scale),
             (fa.flash_bwd_dq(q, k, v, do, lse, d, True, scale),),
             fa.flash_bwd_dkv(q, k, v, do, lse, d, True, scale))
    check(all(torch.equal(a, b) for x, y in zip(first, again)
              for a, b in zip(x, y)),
          "flash slice shapes: a second launch changed an output bit")
    log("flash slice shapes: K1-K3 repeat bit for bit")
    flush = flush_buffer()
    runs = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, True, scale),
            lambda: fa.flash_forward_reference(q, k, v, True, scale)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, d, True, scale),
            lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, d, True,
                                              scale)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, d, True, scale),
            lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, d, True,
                                               scale)),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library = {
        "flash_forward": time_cold_ms(
            lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), is_causal=True),
            flush, iters=20, warmup=3),
        "flash_bwd": time_cold_ms(
            lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True),
            flush, iters=20, warmup=3),
    }
    bounds = _flash_bounds(B, H, L, D, q.element_size())
    results = {}
    for name, (kern, plain) in runs.items():
        ms = time_cold_ms(kern, flush, iters=20, warmup=3)
        plain_ms = time_cold_ms(plain, flush, iters=5, warmup=1)
        lib = library["flash_forward" if name == "flash_forward"
                      else "flash_bwd"]
        results[name] = {"max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib, **bounds[name]}
        log(f"  {name}: ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{lib:.4f}  bound_ms {bounds[name]['bound_ms']:.4f} "
            f"({bounds[name]['bound_by']}: {bounds[name]['flops']} flops, "
            f"{bounds[name]['bytes']} bytes)")
    del flush
    return results


# ------------------------------------------------------------- phase 5

# The image lane's defaults (batch 64, 224^2, 1000 classes); its 16 1x1
# ConvBN shapes are horovod_tpu_torch.models.resnet.RESNET50_K5.
IMG_B, IMG_SIZE, CLASSES = 64, 224, 1000
# Sweep: (B, H, W, K, N, stride, prologue). Rows off the 128- and 64-row
# tiles (M = 1, 100, 129, 257, 300, 429, 450, 2000, 39999: more M tiles
# than the card holds blocks at once), K from 8 to 2048 (off the
# 8-channel vector width: 12, 100; off the bf16 kernel's 64-deep slices:
# 72, 100, 136, 1000, 1088 with a ring that wraps), N off the 64/128-column
# tiles and off 256 (3, 72, 130, 136, 200, 300, 520), strided views, odd
# sides, the prologue with positive shifts.
K5_SWEEP = [
    (1, 1, 1, 8, 8, 1, False), (1, 10, 10, 100, 40, 1, True),
    (3, 43, 1, 24, 130, 1, False), (2, 15, 10, 12, 64, 1, True),
    (2, 16, 16, 256, 200, 2, False), (2, 15, 15, 64, 72, 2, True),
    (1, 12, 25, 2048, 96, 1, True), (4, 9, 9, 512, 1024, 2, False),
    (2, 8, 8, 1000, 3, 1, False), (1, 257, 1, 72, 300, 1, True),
    (2, 20, 20, 136, 256, 2, True), (3, 11, 13, 192, 520, 1, False),
    (1, 1, 2000, 1088, 64, 1, True), (2, 30, 30, 64, 136, 2, False),
    (1, 199, 201, 64, 256, 1, True),
]


def _k5_inputs(torch, np, rng, B, H, W, K, N, stride, prologue, dtype):
    """x as the model hands it over (an NHWC view of a channels-last
    activation, subsampled for a strided 1x1), w as the [K, N] view of an
    OIHW 1x1 weight, a/b float32 with positive shifts (so a row off the
    tile that escaped the mask would show in the statistics)."""
    x = torch.tensor(rng.standard_normal((B, H, W, K), dtype=np.float32),
                     device="cuda").to(dtype)
    x = x[:, ::stride, ::stride, :]
    wt = torch.tensor(rng.standard_normal((N, K), dtype=np.float32)
                      / np.sqrt(K), device="cuda").to(dtype)
    a = b = None
    if prologue:
        a = torch.tensor(rng.uniform(0.5, 1.5, K).astype(np.float32),
                         device="cuda")
        b = torch.tensor(rng.uniform(0.1, 0.6, K).astype(np.float32),
                         device="cuda")
    return x, wt.t(), a, b


def _k5_check(torch, cb, x, w, a, b, dname, what):
    """The kernel against its plain version: y elementwise; s1 against the
    column sums of |y| (s1 is a sum of both signs), s2 relatively."""
    y, s1, s2 = cb.bn_stats_forward(x, w, a, b)
    x2 = x.reshape(-1, x.shape[-1])
    if a is None:
        ry, r1, r2 = cb.matmul_bn_stats_reference(x2, w)
    else:
        ry, r1, r2 = cb.matmul_prologue_bn_stats_reference(x2, a, b, w)
    torch.cuda.synchronize()
    tol, stol = TOL[dname], K5_STATS_TOL[dname]
    err = float((y.float() - ry.float()).abs().max())
    scale = ry.float().abs().sum(0)
    e1 = float(((s1 - r1).abs() / scale.clamp_min(1e-30)).max())
    e2 = float(((s2 - r2).abs() / r2.abs().clamp_min(1e-30)).max())
    check(bool(torch.isfinite(y.float()).all())
          and torch.allclose(y.float(), ry.float(), atol=tol, rtol=tol)
          and e1 <= stol and e2 <= stol,
          f"conv_bn {what}: kernel disagrees with its plain version (y "
          f"max_abs_err {err:.3e} tol {tol}; s1 {e1:.3e}, s2 {e2:.3e} "
          f"relative, tol {stol})")
    return err, max(e1, e2)


# Statistics against the plain version, relative (s1 to the column sums
# of |y|, s2 to itself): float32 sums of the same values in another order
# (float32: a few 1e-7 relative); bfloat16: the rare y that rounds one
# bf16 ulp (2^-8) the other way moves a sum by far less than 1e-3.
K5_STATS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _k5_bound(M, K, N, prologue, elt):
    """Least work of one launch: x and w read once, y written once (plus
    a/b and the float32 statistics); 2*M*K*N flops over the bf16 (or f32)
    peak. Bytes over the HBM peak."""
    nbytes = (M * K + K * N + M * N) * elt + 2 * N * 4 \
        + (2 * K * elt if prologue else 0)
    return nbytes, 2 * M * K * N


def conv_bn_phase(torch, np):
    """K5 over the sweep (f32 and bf16), then at the 16 ResNet-50 shapes
    in bf16: agreement, bit-for-bit repetition, and per shape the cold-L2
    time of the kernel, of its plain version and of the library yardstick
    (``torch.matmul`` + the two column reductions, behind the prologue's
    elementwise pass), with the bound; the sums over one training step's
    36 launches."""
    from horovod_tpu_torch._timing import (device_ms, flush_buffer,
                                           time_cold_ms)
    from horovod_tpu_torch.models.resnet import RESNET50_K5
    from horovod_tpu_torch.ops import conv_bn as cb

    rng = np.random.default_rng(21)
    worst = {}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for B, H, W, K, N, s, pro in K5_SWEEP:
            x, w, a, b = _k5_inputs(torch, np, rng, B, H, W, K, N, s, pro,
                                    dtype)
            errs = _k5_check(torch, cb, x, w, a, b, dname,
                             f"sweep {dname} x {tuple(x.shape)} "
                             f"stride {s} N {N} prologue {pro}")
            worst[dname] = max(worst.get(dname, (0, 0)), errs)
            cases += 1
    log(f"conv_bn sweep: {cases} cases (M 1..39999, K 8..2048, N 3..1024, "
        f"prologue on/off, strided views, f32 + bf16) agree with the plain "
        f"version; worst (y abs, stats rel) {worst}")

    flush = flush_buffer()
    shapes = []
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "t_bytes": 0.0, "t_ops": 0.0, "bytes": 0, "flops": 0,
           "launches": 0, "max_abs_err": 0.0}
    for side, K, N, s, pro, count in RESNET50_K5:
        x, w, a, b = _k5_inputs(torch, np, rng, IMG_B, side, side, K, N, s,
                                pro, torch.bfloat16)
        what = f"ResNet-50 M={x.shape[0] * x.shape[1] * x.shape[2]} " \
               f"{K}->{N} stride {s} prologue {pro}"
        err, serr = _k5_check(torch, cb, x, w, a, b, "bfloat16", what)
        first = cb.bn_stats_forward(x, w, a, b)
        again = cb.bn_stats_forward(x, w, a, b)
        check(all(torch.equal(p, q) for p, q in zip(first, again)),
              f"conv_bn {what}: a second launch changed an output bit")
        x2 = x.reshape(-1, K)
        if a is None:
            plain = lambda: cb.matmul_bn_stats_reference(x2, w)  # noqa
        else:
            plain = lambda: cb.matmul_prologue_bn_stats_reference(  # noqa
                x2, a, b, w)

        def library():
            h = x.reshape(-1, K)
            if a is not None:
                h = torch.relu(h * a.to(h.dtype) + b.to(h.dtype))
            y = torch.matmul(h, w)
            yf = y.float()
            return y, yf.sum(0), yf.square().sum(0)

        ms = time_cold_ms(lambda: cb.bn_stats_forward(x, w, a, b),
                          flush, iters=20, warmup=3)
        dev_ms = device_ms(lambda: cb.bn_stats_forward(x, w, a, b), flush,
                           cb.KERNEL_NAMES)
        plain_ms = time_cold_ms(plain, flush, iters=5, warmup=1)
        library_ms = time_cold_ms(library, flush, iters=20, warmup=3)
        M = x.shape[0] * x.shape[1] * x.shape[2]
        nbytes, flops = _k5_bound(M, K, N, pro, 2)
        t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        row = {"M": M, "K": K, "N": N, "stride": s, "prologue": pro,
               "launches_per_step": count, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err, "stats_rel_err": serr}
        shapes.append(row)
        for key, v in (("ms", ms), ("device_ms", dev_ms),
                       ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("t_bytes", t_bytes),
                       ("t_ops", t_ops), ("bytes", nbytes),
                       ("flops", flops), ("launches", 1)):
            tot[key] += count * v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        log(f"  conv_bn {what} x{count}: ms {ms:.4f}  device_ms "
            f"{dev_ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), max_abs_err "
            f"{err:.3e}")
        del x, w, a, b, x2
    del flush
    torch.cuda.empty_cache()
    check(tot["launches"] == 36, f"the ResNet-50 table holds "
                                 f"{tot['launches']} launches, not 36")
    step = {k: tot[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                "bytes", "flops", "max_abs_err")}
    step["bound_ms"] = max(tot["t_bytes"], tot["t_ops"])
    step["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                        else "operations")
    log(f"conv_bn: one ResNet-50 step's 36 launches: ms {step['ms']:.4f}  "
        f"device_ms {step['device_ms']:.4f}  plain_ms "
        f"{step['plain_ms']:.4f}  library_ms "
        f"{step['library_ms']:.4f}  bound_ms {step['bound_ms']:.4f} "
        f"({step['bound_by']}: {step['bytes']} bytes, {step['flops']} "
        f"flops)")
    return {"step": step, "shapes": shapes, "sweep_worst": worst}


# ------------------------------------------------------------- phase 6

TRAIN_STEPS = 5
# The dense-attention cross-check runs one step at this batch (dense
# attention keeps [B, H, L, L] scores per layer for the backward).
PARITY_BATCH = 2
# Flash against dense attention, same weights and tokens, bf16 compute:
# dense rounds the scores to bf16 before its float32 softmax (its
# einsum runs in the input dtype), flash keeps them in float32, so the
# two differ by bf16 rounding of the scores; averaged over 2 x 2047
# next-token losses that moves the loss by far less than 0.5%, and the
# gradients' global norm by less than 5%. A wrong kernel moves both by
# far more (the loss of a broken attention is off by whole units).
PARITY_RTOL = {"loss": 5e-3, "grad_norm": 5e-2}


def _lm(torch, attn_fn):
    from horovod_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(vocab_size=VOCAB, num_layers=LAYERS,
                         num_heads=HEADS, embed_dim=D_MODEL,
                         max_len=FLASH_L, dtype=torch.bfloat16,
                         attn_fn=attn_fn, seed=0, device="cuda")


def _attention_parity(torch, flash, tokens):
    """One forward + backward of the same weights with flash and with the
    port's dense attention: loss and gradient global norm."""
    from horovod_tpu_torch.models.train import next_token_loss

    out = {}
    for name, fn in (("flash", flash), ("dense", None)):
        model = _lm(torch, fn)
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                              for p in model.parameters()))
        out[name] = {"loss": float(loss.detach()),
                     "grad_norm": float(norm)}
        del model, loss
        torch.cuda.empty_cache()
    for key, rtol in PARITY_RTOL.items():
        f, d = out["flash"][key], out["dense"][key]
        rel = abs(f - d) / abs(d)
        out[f"{key}_rel_diff"] = rel
        check(math.isfinite(f) and math.isfinite(d) and rel <= rtol,
              f"training: flash and dense {key} differ by {rel:.3e} "
              f"(flash {f}, dense {d}; rtol {rtol})")
    return out


def training_phase(torch, np, profile):
    """The bench lane's data-parallel step at GPT-2-small width and the
    lane's defaults (seq 2048, batch 8, bf16, flash attention, Adam 1e-4
    under DistributedOptimizer, NCCL world of one) on one fixed batch."""
    import functools

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_train_step)
    from horovod_tpu_torch.ops import attention as fa

    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"training: expected an NCCL world of one, got "
          f"{dist.get_backend()} x {hvd.size()}")
    flash = functools.partial(fa.flash_attention, causal=True)
    rng = np.random.default_rng(5)
    tokens = torch.tensor(rng.integers(0, VOCAB, (FLASH_B, FLASH_L)),
                          device="cuda")
    parity = _attention_parity(torch, flash, tokens[:PARITY_BATCH])
    log(f"training: flash vs dense at batch {PARITY_BATCH}: loss "
        f"{parity['flash']['loss']:.6f} vs {parity['dense']['loss']:.6f} "
        f"(rel {parity['loss_rel_diff']:.2e}), grad norm "
        f"{parity['flash']['grad_norm']:.6f} vs "
        f"{parity['dense']['grad_norm']:.6f} "
        f"(rel {parity['grad_norm_rel_diff']:.2e})")

    model = _lm(torch, flash)
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_train_state(model, torch.optim.Adam(model.parameters(),
                                                     lr=1e-4),
                             device="cuda")
    step = make_train_step(model, opt)
    plan = hvd.plan_buckets(list(model.parameters()),
                            basics.config().fusion_threshold)
    summary = hvd.plan_summary(plan)
    log(f"training: {n_params} parameters, bucket plan {summary}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    fused_reduce.collectives = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    collectives = fused_reduce.collectives
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"training: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"training: the loss did not fall on a fixed batch: {losses}")
    for name, n in launches.items():
        check(n == LAYERS * TRAIN_STEPS,
              f"training: {name} launched {n} times, expected {LAYERS} "
              f"layers x {TRAIN_STEPS} passes")
    check(collectives == len(plan) * TRAIN_STEPS,
          f"training: {collectives} bucket collectives, expected "
          f"{len(plan)} buckets x {TRAIN_STEPS} steps")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    result = {
        "losses": losses, "step_s": times, "median_step_s": step_s,
        "tokens_per_s": FLASH_B * FLASH_L / step_s,
        "peak_memory_bytes": peak, "launches": launches,
        "collectives": collectives, "plan": summary, "parity": parity,
        "params": n_params,
    }
    log(f"training: {TRAIN_STEPS} steps, losses {losses}, step s "
        f"{[round(t, 4) for t in times]}, median (steps 2-{TRAIN_STEPS}) "
        f"{step_s:.4f} s = {result['tokens_per_s']:.1f} tokens/s per card, "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, "
        f"{collectives} NCCL bucket collectives")
    if profile:
        result["profile"] = _profile_steps(torch, step, tokens)
    hvd.shutdown()
    del model, opt, step
    torch.cuda.empty_cache()
    return result


def _device_events(prof):
    """The kernels, copies and memsets of a trace, by name. A user
    annotation (``Optimizer.step#SGD.step``) also shows on the device
    timeline, spanning the kernels it encloses and the gaps between
    them, so it is left out: it would count that time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _profile_steps(torch, step, batch, name="training", steps=2):
    """``--profile``: training steps under ``torch.profiler``: device busy
    time, idle share of the wall, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in dev)
    check(busy_us > 0, f"profile[{name}]: no device events traced")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    out = {"wall_s": wall, "steps": steps, "device_busy_s": busy_us / 1e6,
           "idle_share": 1 - busy_us / 1e6 / wall,
           "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                   for e in top]}
    log(f"profile[{name}]: {json.dumps(out)}")
    return out


# ------------------------------------------------------------- phase 7

RESNET_STEPS = 5
# Fused (K5) against unfused (cuDNN convs, statistics as a separate pass)
# BatchNorm, same weights and batch, one bf16 forward + backward: both
# round every conv output to bf16 from float32 sums taken in another
# order, so a y now and then rounds one bf16 ulp (2^-8) the other way,
# and 53 layers carry that along (the fused backward's products are
# cuBLAS's, the unfused cuDNN's, summed in other orders again). That
# moves the cross-entropy over 64 images and each layer's new running
# mean (0.1 of its batch mean, over 3136-200704 rows) by far less than
# 1e-3 (of the layer's largest), the gradients' global norm by less than
# 1e-2. Wrong statistics or a wrong prologue move a layer's running mean
# by its whole scale.
RESNET_PARITY_TOL = {"loss": 1e-3, "running_mean": 1e-3, "grad_norm": 1e-2}


def _resnet(torch, fused):
    from horovod_tpu_torch.models import resnet

    return resnet.build("resnet50", num_classes=CLASSES, fused_bn=fused,
                        seed=0, device="cuda")


def _resnet_parity(torch, batch):
    """One forward + backward of the same weights with fused and with
    unfused BatchNorm: loss, gradient global norm, new running means."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models.train import cross_entropy_loss

    out = {}
    for fused in (True, False):
        model = _resnet(torch, fused)
        loss = cross_entropy_loss(model(batch["image"]), batch["label"])
        loss.backward()
        norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                              for p in model.parameters()))
        means = [m.mean.clone() for m in model.modules()
                 if isinstance(m, resnet.ConvBN)]
        out[fused] = {"loss": float(loss.detach()), "grad_norm": float(norm),
                      "means": means}
        del model, loss
        torch.cuda.empty_cache()
    res = {}
    for key in ("loss", "grad_norm"):
        f, u = out[True][key], out[False][key]
        rel = abs(f - u) / abs(u)
        res[key] = {"fused": f, "unfused": u, "rel_diff": rel}
        check(math.isfinite(f) and math.isfinite(u)
              and rel <= RESNET_PARITY_TOL[key],
              f"resnet: fused and unfused {key} differ by {rel:.3e} (fused "
              f"{f}, unfused {u}; rtol {RESNET_PARITY_TOL[key]})")
    worst = 0.0
    for f, u in zip(out[True]["means"], out[False]["means"]):
        rel = float((f - u).abs().max() / u.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    res["running_mean"] = {"layers": len(out[True]["means"]),
                           "worst_rel_diff": worst}
    check(worst <= RESNET_PARITY_TOL["running_mean"],
          f"resnet: fused and unfused running means differ by {worst:.3e} "
          f"of a layer's largest (tol {RESNET_PARITY_TOL['running_mean']})")
    return res


def resnet_phase(torch, np, profile):
    """The image bench lane's step: ResNet-50 at full width with the JAX
    lane's defaults (224^2 synthetic images, 64 per card, 1000 classes,
    bf16 compute, SGD 0.01 momentum 0.9 under DistributedOptimizer,
    average_loss=False), ``--fused-bn``, an NCCL world of one, a few
    steps on one fixed batch."""
    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_image_train_step)
    from horovod_tpu_torch.ops import conv_bn as cb

    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"resnet: expected an NCCL world of one, got "
          f"{dist.get_backend()} x {hvd.size()}")
    rng = np.random.default_rng(6)
    batch = {"image": torch.tensor(rng.standard_normal(
                 (IMG_B, IMG_SIZE, IMG_SIZE, 3), dtype=np.float32),
                 device="cuda"),
             "label": torch.tensor(rng.integers(0, CLASSES, IMG_B),
                                   device="cuda")}
    parity = _resnet_parity(torch, batch)
    log(f"resnet: fused vs unfused BatchNorm, one step at batch {IMG_B}: "
        f"{json.dumps(parity)}")

    model = _resnet(torch, True)
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        device="cuda")
    step = make_image_train_step(model, opt, average_loss=False)
    plan = hvd.plan_buckets(list(model.parameters()),
                            basics.config().fusion_threshold)
    summary = hvd.plan_summary(plan)
    log(f"resnet: {n_params} parameters, bucket plan {summary}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.bn_stats_forward.launches = 0
    cb.bn_stats_forward.prologue_launches = 0
    fused_reduce.collectives = 0
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = cb.bn_stats_forward.launches
    prologue = cb.bn_stats_forward.prologue_launches
    collectives = fused_reduce.collectives
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"resnet: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"resnet: the loss did not fall on a fixed batch: {losses}")
    check(launches == 36 * RESNET_STEPS and prologue == 16 * RESNET_STEPS,
          f"resnet: K5 launched {launches} times ({prologue} with the "
          f"prologue), expected 36 x {RESNET_STEPS} (16 x {RESNET_STEPS})")
    check(collectives == len(plan) * RESNET_STEPS,
          f"resnet: {collectives} bucket collectives, expected "
          f"{len(plan)} buckets x {RESNET_STEPS} steps")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    result = {
        "losses": losses, "step_s": times, "median_step_s": step_s,
        "img_per_s": IMG_B / step_s, "peak_memory_bytes": peak,
        "launches": launches, "prologue_launches": prologue,
        "collectives": collectives, "plan": summary, "parity": parity,
        "params": n_params,
    }
    log(f"resnet: {RESNET_STEPS} steps, losses {losses}, step s "
        f"{[round(t, 4) for t in times]}, median (steps 2-{RESNET_STEPS}) "
        f"{step_s:.4f} s = {result['img_per_s']:.1f} img/s per card, peak "
        f"memory {peak / 2**30:.2f} GiB, K5 launches {launches} "
        f"({prologue} with the prologue), {collectives} NCCL bucket "
        "collectives")
    if profile:
        result["profile"] = {"fused": _profile_steps(torch, step, batch,
                                                     "resnet fused")}
        del model, opt, step
        torch.cuda.empty_cache()
        model = _resnet(torch, False)
        opt = create_train_state(
            model, torch.optim.SGD(model.parameters(), lr=0.01,
                                   momentum=0.9), device="cuda")
        step = make_image_train_step(model, opt, average_loss=False)
        for _ in range(3):                       # cuDNN's first calls
            step(batch)
        result["profile"]["unfused"] = _profile_steps(
            torch, step, batch, "resnet unfused")
    hvd.shutdown()
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- phase 8


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
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode in ("paged", "gather"):
        eng = _warm_engine(torch, params, prompts, mode)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _serve(torch, eng, waves)
        dev = _device_events(prof)
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


def _paged_record(kres, rate, launches, ptxas, card):
    """The kernels line's entry of K4: launches from the engine phase, the
    times and errors of the f32 serving shapes at the top level, bf16 and
    the long-context geometry beside them, and ptxas's registers and
    spills of each instance of the two kernels."""
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bytes", "flops")
    serving, long = kres["serving"], kres["long"]
    f32 = serving["float32"]
    return {
        "name": "paged_attention_decode", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_attention.cu",
        "replaces": "horovod_tpu/ops/paged_attention.py:55",
        "launches": launches,
        **{k: f32[k] for k in keys},
        # ms spans the call (host gaps included); device_ms is the split
        # and merge kernels alone, as the profiler traces them.
        "design": "split-K decode: chunks of R key rows a block (one head "
                  "a block), 16-byte loads by lane groups, every row of a "
                  "chunk in flight at once, exp2 online softmax in "
                  "registers; the chunks' float32 partials merged in chunk "
                  "order by a second kernel, no atomics",
        "dtype": "float32", "shape": serving["shape"],
        "copy_GBps": rate / 1e9,
        "bfloat16": {k: serving["bfloat16"][k] for k in keys},
        "long_context": {"shape": long["shape"],
                         "float32": {k: long["float32"][k] for k in keys},
                         "bfloat16": {k: long["bfloat16"][k] for k in keys}},
        "ptxas": ptxas, "card": card,
    }


def _flash_records(fres, tres, card):
    """The kernels line's entries of K1-K3: launches from the training
    phase, times and errors from the flash phase at the slice shapes."""
    rows = [("flash_forward", ":179", ("out", "lse")),
            ("flash_bwd_dq", ":533", ("dq",)),
            ("flash_bwd_dkv", ":599", ("dk", "dv"))]
    out = []
    for name, line, outs in rows:
        # bf16 K1-K3 run the tensor-core designs (float32 the CUDA-core
        # ones).
        design = ("wgmma m64n64k16 tensor-core forward: 128 query rows a "
                  "block, online softmax in registers, cp.async K/V ring"
                  if name == "flash_forward"
                  else "wgmma m64n64k16 + cp.async ring")
        r = fres[name]
        out.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"horovod_tpu/ops/attention.py{line}",
            "launches": tres["launches"][name],
            "max_abs_err": max(r["max_abs_err"][o] for o in outs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"library_covers": "flash_bwd_dq + flash_bwd_dkv"}
               if name != "flash_forward" else {}),
            "design": design, "dtype": "bfloat16",
            "shape": {"B": FLASH_B, "L": FLASH_L, "H": HEADS,
                      "D": HEAD_DIM, "causal": True},
            "flops": r["flops"], "bytes": r["bytes"], "card": card,
        })
    return out


def _conv_bn_record(cres, rres, card):
    """The kernels line's entry of K5: launches from the ResNet phase (36
    a step), the times and the bound summed over one step's 36 launches
    at the ResNet-50 shapes, each shape's own numbers beside them."""
    st = cres["step"]
    return {
        "name": "bn_stats_forward", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/conv_bn.cu",
        "replaces": "horovod_tpu/ops/conv_bn.py:77",
        "launches": rres["launches"],
        "max_abs_err": st["max_abs_err"],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": st["library_ms"],
        # ms spans the calls (host gaps included); device_ms is K5's two
        # kernels alone, as the profiler traces them.
        "device_ms": st["device_ms"],
        "library": "torch.matmul + y.float().sum(0) + "
                   "y.float().square().sum(0), behind the prologue's "
                   "relu(x*a+b)",
        "times_cover": "one ResNet-50 training step's 36 launches "
                       "(batch 64, 224^2, bf16)",
        "prologue_launches": rres["prologue_launches"],
        "design": "wgmma m64nBNk16 tensor-core kernel: 128-row M tiles of "
                  "two warpgroups, 64-deep swizzled K slices through a "
                  "cp.async ring, the prologue applied in shared memory, "
                  "y staged and stored in 16-byte chunks",
        "dtype": "bfloat16", "flops": st["flops"], "bytes": st["bytes"],
        "shapes": cres["shapes"], "card": card,
    }


def engine_only(torch, np):
    """``--engine-only [RUNS]``: the engine phase RUNS times."""
    args = sys.argv[sys.argv.index("--engine-only") + 1:]
    runs = int(args[0]) if args else 3
    out = []
    for _ in range(runs):
        res = engine_phase(torch, np)[0]
        out.append({mode: {
            "tokens_per_sec": r["stats"]["tokens_per_sec_per_chip"],
            "ttft_ms": r["stats"]["ttft_ms"], "tbt_ms": r["stats"]["tbt_ms"],
            "wall_s": r["wall"], "steps": r["steps"],
            "launches": r["launches"]} for mode, r in res.items()})
    print(json.dumps({"engine_runs": out}), flush=True)


def main():
    import numpy as np
    import torch

    card = device_phase(torch)
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script "
                           f"({e}); run from the root of a checkout")
    if "--engine-only" in sys.argv[1:]:
        return engine_only(torch, np)
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    ptxas = build_phase()
    kres, rate = kernel_phase(torch, np)
    fres = flash_phase(torch, np)
    cres = conv_bn_phase(torch, np)
    tres = training_phase(torch, np, profile)
    rres = resnet_phase(torch, np, profile)
    runs, params, prompts, waves = engine_phase(torch, np)
    if profile:
        profile_phase(torch, params, prompts, waves)
    print(json.dumps({"training": {k: v for k, v in tres.items()
                                   if k != "profile"}}), flush=True)
    print(json.dumps({"resnet": {k: v for k, v in rres.items()
                                 if k != "profile"}}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    record = {"kernels": [
        _paged_record(kres, rate, runs["paged"]["launches"],
                      ptxas.get("paged_attention", {}), card),
        *_flash_records(fres, tres, card), _conv_bn_record(cres, rres, card)]}
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
