"""Time the bf16 flash-attention kernels (K1, K2, K3) under other tile
constants and schedules.

    python -m horovod_tpu_torch.tune_flash [variant ...]

Each variant is ``csrc/flash_attention.cu`` with some of its bf16
constants replaced (all of :data:`VARIANTS` when none is named). The
variants are built at once by ``nvcc`` (into ``build/tune/``), checked
against the plain versions (bf16 tolerance 2e-2) and timed with the L2
flushed at the LM training slice's shapes (B=8, L=2048, H=12, D=64,
causal, bf16), in two passes of opposite order. Prints one JSON line per
variant and pass; the source ships the constants of the fastest. The
``_diag_`` variants drop one part of a kernel (results wrong, ``ok``
false) to show where the time goes. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys

import numpy as np
import torch

from horovod_tpu_torch._timing import card, flush_buffer, time_cold_ms
from horovod_tpu_torch._tune import build_variants
from horovod_tpu_torch.ops import attention as fa

_S1 = "constexpr int kStages1 = 2;"
_Q1 = "constexpr int kQ1 = 128;"
_S2 = "constexpr int kStages2 = 2;"
_S3 = "constexpr int kStages3 = 2;"
_LB2 = "__launch_bounds__(kT2, kD > 64 ? 2 : 4)"
#: name -> {text in the source: its replacement}.
VARIANTS = {
    "shipped": {},
    # K1: query rows a block (one warpgroup, 4 blocks an SM) and ring
    # depth.
    "k1_q64": {_Q1: _Q1.replace("128", "64")},
    "k1_stages3": {_S1: _S1.replace("2;", "3;")},
    # Timing only, wrong results: where K1's time goes, without its
    # softmax, without the exp2 in it, or without one of its products.
    "k1_diag_no_softmax": {
        "    softmax_tile(s, m2, l, alpha, sl2, edge, lim, tq);\n":
            "    alpha[0] = alpha[1] = 1.f;\n"},
    "k1_diag_no_exp": {
        "s[n][e] = exp2_approx(fmaf(s[n][e], sl2, -m2[e >> 1]));":
            "s[n][e] = fmaf(s[n][e], sl2, -m2[e >> 1]);"},
    "k1_diag_no_s": {
        "    score_tile<kD, kQ1>(s, wq, sk);\n":
            "    s[0][0] = __bfloat162float(wq[threadIdx.x]);\n"},
    "k1_diag_no_pv": {
        "    acc_tile<kD>(acc, pa, sv);\n":
            "    acc[0][0] += __uint_as_float(pa[0][0] ^ pa[3][3]);\n"},
    # K2 and K3: ring depth, blocks an SM, K3's key rows.
    "k2_stages3": {_S2: _S2.replace("2;", "3;")},
    "k2_2blocks": {_LB2: "__launch_bounds__(kT2, 2)"},
    "k2_3blocks": {_LB2: "__launch_bounds__(kT2, kD > 64 ? 2 : 3)"},
    "k3_stages3": {_S3: _S3.replace("2;", "3;")},
    "k3_64rows": {"constexpr int kK3 = 128;": "constexpr int kK3 = 64;",
                  "constexpr int kT3 = 256;": "constexpr int kT3 = 128;",
                  "__launch_bounds__(kT3, 1)": "__launch_bounds__(kT3, 2)"},
}
B, L, H, D = 8, 2048, 12, 64
TOL = 2e-2
_SYMBOLS = ("hvd_flash_fwd", "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv")


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash: no CUDA device")
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"tune_flash: unknown variants {unknown}; choose "
                         f"from {list(VARIANTS)}")
    libs = build_variants("flash_attention", VARIANTS, names)
    for lib in libs.values():
        for sym in _SYMBOLS:
            fn = getattr(lib, sym)
            fn.argtypes = fa._ARGTYPES[sym]
            fn.restype = ctypes.c_int
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, L, H, D),
                                                    dtype=np.float32),
                                device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    ref = {}
    ref["out"], ref["lse"] = fa.flash_forward_reference(q, k, v, True, scale)
    lse = ref["lse"]
    d = (do.float() * ref["out"].float()).sum(-1).transpose(1, 2)
    d = d.contiguous()
    ref["dq"] = fa.flash_bwd_dq_reference(q, k, v, do, lse, d, True, scale)
    ref["dk"], ref["dv"] = fa.flash_bwd_dkv_reference(q, k, v, do, lse, d,
                                                      True, scale)
    qkv = [1, q.data_ptr(), k.data_ptr(), v.data_ptr()]
    strides = [x for t in (q, k, v) for x in fa._strides("tune", "t", t)]
    tail = [scale, 1, 0, torch.cuda.current_stream().cuda_stream]
    flush = flush_buffer()
    smi = card()
    for order in (names, names[::-1]):
        for name in order:
            lib = libs[name]
            got = {"out": torch.empty_like(q),
                   "lse": torch.empty_like(lse),
                   "dq": torch.empty_like(q), "dk": torch.empty_like(k),
                   "dv": torch.empty_like(v)}

            def call(sym, *ptrs, bwd=False):
                geom = [B, H, L, L, D, *strides,
                        *(fa._strides("tune", "dO", do) if bwd else ())]
                head = qkv + ([do.data_ptr(), lse.data_ptr(), d.data_ptr()]
                              if bwd else [])
                rc = getattr(lib, sym)(*head, *ptrs, *geom, *tail)
                if rc:
                    raise RuntimeError(f"{name}: {sym} failed ({rc})")

            runs = {
                "fwd": lambda: call("hvd_flash_fwd", got["out"].data_ptr(),
                                    got["lse"].data_ptr()),
                "dq": lambda: call("hvd_flash_bwd_dq", got["dq"].data_ptr(),
                                   bwd=True),
                "dkv": lambda: call("hvd_flash_bwd_dkv",
                                    got["dk"].data_ptr(),
                                    got["dv"].data_ptr(), bwd=True),
            }
            for fn in runs.values():
                fn()
            torch.cuda.synchronize()
            errs = {n: float((t.float() - ref[n].float()).abs().max())
                    for n, t in got.items()}
            ok = all(torch.allclose(t.float(), ref[n].float(), atol=TOL,
                                    rtol=TOL) for n, t in got.items())
            print(json.dumps({
                "variant": name, "ok": ok,
                **{f"{n}_ms": time_cold_ms(fn, flush, iters=20, warmup=3)
                   for n, fn in runs.items()},
                "max_abs_err": errs, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
