"""Time the bf16 flash-backward kernels (K2, K3) under other tile constants.

    python -m horovod_tpu_torch.tune_flash_bwd

Each variant is ``csrc/flash_attention.cu`` with some of the bf16 K2/K3
constants replaced. All variants are built at once by ``nvcc`` (into
``build/tune/``), checked against the plain versions (bf16 tolerance
2e-2) and timed with the L2 flushed at the LM training slice's shapes
(B=8, L=2048, H=12, D=64, causal, bf16), in two passes of opposite
order. Prints one JSON line per variant and pass; the source ships the
constants of the fastest. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import numpy as np
import torch

from horovod_tpu_torch import _build
from horovod_tpu_torch.ops import attention as fa

_S2 = "constexpr int kStages2 = 2;"
_S3 = "constexpr int kStages3 = 2;"
_LB2 = "__launch_bounds__(kT2, kD > 64 ? 2 : 4)"
#: name -> {text in the source: its replacement}.
VARIANTS = {
    "shipped": {},
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


def _build_variants():
    out = _build.BUILD_DIR.parent / "tune"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   "exactly once")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        lib = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for sym in ("hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"):
            fn = getattr(libs[name], sym)
            fn.argtypes = fa._ARGTYPES[sym]
            fn.restype = ctypes.c_int
    return libs


def _time_ms(fn, flush, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_bwd: no CUDA device")
    libs = _build_variants()
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, L, H, D),
                                                    dtype=np.float32),
                                device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_forward_reference(q, k, v, True, scale)
    d = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = {"dq": fa.flash_bwd_dq_reference(q, k, v, do, lse, d, True, scale)}
    ref["dk"], ref["dv"] = fa.flash_bwd_dkv_reference(q, k, v, do, lse, d,
                                                      True, scale)
    strides = [x for t in (q, k, v, do) for x in fa._strides("tune", "t", t)]
    head = [1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), d.data_ptr()]
    geom = [B, H, L, L, D, *strides, scale, 1, 0]
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    names = list(VARIANTS)
    for order in (names, names[::-1]):
        for name in order:
            lib = libs[name]
            dq = torch.empty_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def run_dq():
                rc = lib.hvd_flash_bwd_dq(*head, dq.data_ptr(), *geom, stream)
                if rc:
                    raise RuntimeError(f"{name}: K2 launch failed ({rc})")

            def run_dkv():
                rc = lib.hvd_flash_bwd_dkv(*head, dk.data_ptr(),
                                           dv.data_ptr(), *geom, stream)
                if rc:
                    raise RuntimeError(f"{name}: K3 launch failed ({rc})")

            run_dq()
            run_dkv()
            torch.cuda.synchronize()
            errs = {n: float((t.float() - ref[n].float()).abs().max())
                    for n, t in (("dq", dq), ("dk", dk), ("dv", dv))}
            ok = all(torch.allclose(t.float(), ref[n].float(), atol=TOL,
                                    rtol=TOL)
                     for n, t in (("dq", dq), ("dk", dk), ("dv", dv)))
            print(json.dumps({
                "variant": name, "ok": ok, "dq_ms": _time_ms(run_dq, flush),
                "dkv_ms": _time_ms(run_dkv, flush), "max_abs_err": errs,
                "card": smi}), flush=True)


if __name__ == "__main__":
    main()
