#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (exit code 1, no result line):

1. device: torch/CUDA versions and the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build: every kernel source of the port, one ``nvcc`` per source, all
   started together;
3. kernels: K4 (paged decode) against its plain PyTorch version over a
   sweep of head dims and page sizes, then at the serving path's shapes
   (float32 and bfloat16), with its time, the plain version's, a
   library yardstick's and the least time the card could take (bytes
   over the HBM peak or operations over the peak rate, whichever is
   larger);
4. flash: K1-K3 (flash forward, dQ, dK/dV) against their plain versions
   over a sweep (causal and not, square and rectangular, offset causal,
   lengths off the 64-row tile, head dims 8-128, f32 and bf16, strided
   views), then at the training slice's shapes (B=8, L=2048, H=12,
   D=64, causal, bf16), with the same four times each;
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
KERNEL_LENGTHS = [0, 1, 16, 17, 384, 100, 250, 383]
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
    for name, b in built.items():
        fn = ""
        for line in b.log.splitlines():
            if "Function properties for" in line:
                fn = _kernel_name(line)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {fn}: {line.strip()}")


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

# The training slice's attention shapes: bench defaults, batch 8 of seq
# 2048, 12 heads of 64, causal, bfloat16.
FLASH_B, FLASH_L = 8, 2048
# Sweep geometries: (Lq, Lk, causal, q_offset, k_offset). Lengths that
# are not multiples of the 64-row tiles or of K3's 128-row bf16 key tile
# (136, 200, 264, 320), rectangular shapes, offset causal masks, and
# causal keys past every query (K3 loops over nothing for them and must
# write zeros).
FLASH_GEOMS = [(200, 200, True, 0, 0), (128, 128, False, 0, 0),
               (64, 136, False, 0, 0), (72, 200, True, 128, 0),
               (128, 128, True, 40, 8), (64, 192, True, 0, 0),
               (136, 136, True, 0, 0), (320, 320, True, 0, 0),
               (64, 264, True, 200, 0), (192, 320, False, 0, 0)]
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
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
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
        "flash_forward": _time_cold_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), is_causal=True),
            flush, iters=20, warmup=3),
        "flash_bwd": _time_cold_ms(
            torch, lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True),
            flush, iters=20, warmup=3),
    }
    bounds = _flash_bounds(B, H, L, D, q.element_size())
    results = {}
    for name, (kern, plain) in runs.items():
        ms = _time_cold_ms(torch, kern, flush, iters=20, warmup=3)
        plain_ms = _time_cold_ms(torch, plain, flush, iters=5, warmup=1)
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

# ResNet-50's 1x1 ConvBN layers at the image lane's defaults (batch 64,
# 224^2, bf16): (input side, K, N, stride, prologue, launches a training
# step). 36 launches, 16 with the prologue; the stride-2 projections read
# the subsampled view of their input in place.
IMG_B, IMG_SIZE, CLASSES = 64, 224, 1000
RESNET50_K5 = [
    (56, 64, 64, 1, False, 1), (56, 64, 256, 1, False, 1),
    (56, 64, 256, 1, True, 3), (56, 256, 64, 1, False, 2),
    (56, 256, 128, 1, False, 1), (56, 256, 512, 2, False, 1),
    (28, 128, 512, 1, True, 4), (28, 512, 128, 1, False, 3),
    (28, 512, 256, 1, False, 1), (28, 512, 1024, 2, False, 1),
    (14, 256, 1024, 1, True, 6), (14, 1024, 256, 1, False, 5),
    (14, 1024, 512, 1, False, 1), (14, 1024, 2048, 2, False, 1),
    (7, 512, 2048, 1, True, 3), (7, 2048, 512, 1, False, 2),
]
# Sweep: (B, H, W, K, N, stride, prologue). Rows off the 128- and 64-row
# tiles (M = 1, 100, 129, 300), K from 8 to 2048 (off the 8-channel
# vector width: 12, 100), N off the 64/128-column tiles, strided views,
# odd sides.
K5_SWEEP = [
    (1, 1, 1, 8, 8, 1, False), (1, 10, 10, 100, 40, 1, True),
    (3, 43, 1, 24, 130, 1, False), (2, 15, 10, 12, 64, 1, True),
    (2, 16, 16, 256, 200, 2, False), (2, 15, 15, 64, 72, 2, True),
    (1, 12, 25, 2048, 96, 1, True), (4, 9, 9, 512, 1024, 2, False),
    (2, 8, 8, 1000, 3, 1, False),
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
    log(f"conv_bn sweep: {cases} cases (M 1..2048, K 8..2048, N 3..1024, "
        f"prologue on/off, strided views, f32 + bf16) agree with the plain "
        f"version; worst (y abs, stats rel) {worst}")

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    shapes = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "t_bytes": 0.0,
           "t_ops": 0.0, "bytes": 0, "flops": 0, "launches": 0,
           "max_abs_err": 0.0}
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

        ms = _time_cold_ms(torch, lambda: cb.bn_stats_forward(x, w, a, b),
                           flush, iters=20, warmup=3)
        plain_ms = _time_cold_ms(torch, plain, flush, iters=5, warmup=1)
        library_ms = _time_cold_ms(torch, library, flush, iters=20, warmup=3)
        M = x.shape[0] * x.shape[1] * x.shape[2]
        nbytes, flops = _k5_bound(M, K, N, pro, 2)
        t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        row = {"M": M, "K": K, "N": N, "stride": s, "prologue": pro,
               "launches_per_step": count, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err, "stats_rel_err": serr}
        shapes.append(row)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("t_bytes", t_bytes),
                       ("t_ops", t_ops), ("bytes", nbytes),
                       ("flops", flops), ("launches", 1)):
            tot[key] += count * v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        log(f"  conv_bn {what} x{count}: ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), max_abs_err "
            f"{err:.3e}")
        del x, w, a, b, x2
    del flush
    torch.cuda.empty_cache()
    check(tot["launches"] == 36, f"the ResNet-50 table holds "
                                 f"{tot['launches']} launches, not 36")
    step = {k: tot[k] for k in ("ms", "plain_ms", "library_ms", "bytes",
                                "flops", "max_abs_err")}
    step["bound_ms"] = max(tot["t_bytes"], tot["t_ops"])
    step["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                        else "operations")
    log(f"conv_bn: one ResNet-50 step's 36 launches: ms {step['ms']:.4f}  "
        f"plain_ms {step['plain_ms']:.4f}  library_ms "
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


def _flash_records(fres, tres, card):
    """The kernels line's entries of K1-K3: launches from the training
    phase, times and errors from the flash phase at the slice shapes."""
    rows = [("flash_forward", ":179", ("out", "lse")),
            ("flash_bwd_dq", ":533", ("dq",)),
            ("flash_bwd_dkv", ":599", ("dk", "dv"))]
    out = []
    for name, line, outs in rows:
        # bf16 K2/K3 run the tensor-core design; K1 (and float32 K2/K3)
        # the CUDA-core one.
        design = ("cuda-core fma" if name == "flash_forward"
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
        "library": "torch.matmul + y.float().sum(0) + "
                   "y.float().square().sum(0), behind the prologue's "
                   "relu(x*a+b)",
        "times_cover": "one ResNet-50 training step's 36 launches "
                       "(batch 64, 224^2, bf16)",
        "prologue_launches": rres["prologue_launches"],
        "dtype": "bfloat16", "flops": st["flops"], "bytes": st["bytes"],
        "shapes": cres["shapes"], "card": card,
    }


def main():
    import numpy as np
    import torch

    card = device_phase(torch)
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script "
                           f"({e}); run from the root of a checkout")
    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    build_phase()
    kres, rate = kernel_phase(torch, np)
    fres = flash_phase(torch, np)
    cres = conv_bn_phase(torch, np)
    tres = training_phase(torch, np, profile)
    rres = resnet_phase(torch, np, profile)
    runs, params, prompts, waves = engine_phase(torch, np)
    if profile:
        profile_phase(torch, params, prompts, waves)
    f32, bf16 = kres["float32"], kres["bfloat16"]
    print(json.dumps({"training": {k: v for k, v in tres.items()
                                   if k != "profile"}}), flush=True)
    print(json.dumps({"resnet": {k: v for k, v in rres.items()
                                 if k != "profile"}}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
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
    }, *_flash_records(fres, tres, card), _conv_bn_record(cres, rres, card)]}
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
