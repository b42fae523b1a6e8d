"""Time the paged-attention decode kernels (K4) under other constants.

    python -m horovod_tpu_torch.tune_paged [variant ...]

Each variant is ``csrc/paged_attention.cu`` with some of its source
replaced, and a chunk size ``R`` that replaces the source's
``kChunkRows`` and the host's ``CHUNK_ROWS`` together (all of
:data:`VARIANTS` when none is named). A variant named by the path of a
``.cu`` file builds that file as it stands: an older checkout's source,
to time the parent in the same call (a source without the split plan's
scratch argument is called through the single-kernel interface it had
before). The variants are built at once by ``nvcc`` into
``build/tune/``, checked against the plain version (f32 1e-5, bf16
2e-2) and timed with the L2 flushed at the serving shapes and the
long-context geometry of ``ops/paged_attention.py`` (the ones
``chip_smoke.py`` times), f32 and bf16, in two passes of opposite order:
``ms`` spans the call (host gaps included), ``device_ms`` is the
variant's kernels alone as the profiler traces them, and each kernel's
own share beside it. Prints one JSON
line per variant and pass. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

import torch

from horovod_tpu_torch._timing import (card, device_ms, flush_buffer,
                                       time_cold_ms)
from horovod_tpu_torch._tune import build_variants
from horovod_tpu_torch.ops import paged_attention as pa

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

_KV = "constexpr int kKVRegs = 32;"
_ROWS = "constexpr int kChunkRows = 64;"
# All heads a block, one warp a head at H = 12, so that a page row's
# [H, D] is read as one stretch; grid (splits, 1, S). For H <= 16 only.
_ALL = {
    "  const int h = blockIdx.y;\n  const int nw = blockDim.x / 32;\n"
    "  const int wh = warp;\n":
        "  const int h = warp % a.H;\n  const int nw = blockDim.x / 32 / a.H;"
        "\n  const int wh = warp / a.H;\n",
    "  float* const red = sm; ": "  float* const red = sm + h * nw * W; ",
    "kMaxThreads / 32));": "kMaxThreads / (32 * a.H)));",
    "const int threads = nw * 32;": "const int threads = a.H * nw * 32;",
    "((size_t)nw * (a.D + 2)": "((size_t)a.H * nw * (a.D + 2)",
    "const dim3 grid(a.splits, a.H, S);": "const dim3 grid(a.splits, 1, S);",
}
#: name -> ({text in the source: its replacement}, rows a chunk or None
#: for the shipped ``CHUNK_ROWS``).
VARIANTS = {
    "shipped": ({}, None),
    "rows32": ({}, 32),
    "rows128": ({}, 128),
    "rows256": ({}, 256),
    # Rows in flight a lane group: 2 (twice the warps a block at the same
    # R) or 8 (half the warps).
    "kv16": ({_KV: _KV.replace("32;", "16;")}, None),
    "kv64": ({_KV: _KV.replace("32;", "64;")}, None),
    "all_heads": (_ALL, None),
    "all_heads_rows128": (_ALL, 128),
    "all_heads_rows256": (_ALL, 256),
    # Timing only, wrong results: every split block returns at once (the
    # launch alone), after loading its length, q and page ids (the
    # prologue), or runs without its K/V loads.
    "diag_launch": ({"  const int c = blockIdx.x;\n":
                     "  if (a.D > 0) return;\n  const int c = blockIdx.x;\n"},
                    None),
    "diag_prologue": ({"  if (row0 >= len) return;":
                       "  if (row0 >= len || D > 0) return;"}, None),
    "diag_no_kv": ({
        "kp[u][i] = in ? PK::load(kb + off + d0) : PK::zero();":
            "kp[u][i] = PK::zero();",
        "vp[u][i] = in ? PK::load(vb + off + d0) : PK::zero();":
            "vp[u][i] = PK::zero();"}, None),
}


def _legacy(lib):
    """The single-kernel interface of the sources before the split plan:
    (dtype, q, k, v, tables, lengths, out, S, H, D, ps, pps, scale,
    stream)."""
    fn = lib.hvd_paged_attention_decode
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                   ctypes.c_float, vp]
    fn.restype = ci

    def call(q, kp, vp_, tables, lengths, scale):
        out = torch.empty_like(q)
        S, H, D = q.shape
        rc = fn(pa._KERNEL_DTYPES[q.dtype], q.data_ptr(), kp.data_ptr(),
                vp_.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), S, H, D, kp.shape[1], tables.shape[1],
                float(scale), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"legacy paged kernel failed ({rc})")
        return out

    return call, ("paged_decode_kernel",)


class _CleanFlush:
    """Evicts the L2 by reading the flush buffer instead of zeroing it, so
    that the lines it leaves are clean: the dirty lines of the zeroing
    are written back to HBM while the next call reads. A diagnostic of
    this script only (``device_ms_clean_l2``); ``ms`` and ``device_ms``
    keep ``_timing``'s flush."""

    def __init__(self, buf):
        self.words = buf.view(torch.int32)

    def zero_(self):
        self.words.sum()


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("tune_paged: no CUDA device")
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names
               if n not in VARIANTS and not n.endswith(".cu")]
    if unknown:
        raise SystemExit(f"tune_paged: unknown variants {unknown}; choose "
                         f"from {list(VARIANTS)} or a .cu path")
    patches = {n: {**v[0], **({_ROWS: _ROWS.replace("64", str(v[1]))}
                                 if v[1] else {})}
               for n, v in VARIANTS.items()}
    libs = build_variants("paged_attention", patches, names)
    shipped_rows = pa.CHUNK_ROWS
    calls = {}
    for name, lib in libs.items():
        if (name.endswith(".cu")
                and "void* scratch" not in Path(name).read_text()):
            calls[name] = (*_legacy(lib), None)
        else:
            fn = pa.bind(lib)
            calls[name] = (lambda *a, fn=fn: pa._launch(fn, *a),
                           pa.KERNEL_NAMES,
                           None if name.endswith(".cu") else VARIANTS[name][1])
    cases = {}
    for geom in ("serving", "long"):
        g = pa.geometry(geom)
        for dtype in (torch.float32, torch.bfloat16):
            args = pa.decode_inputs(dtype=dtype, seed=7, **g)
            scale = 1.0 / math.sqrt(g["D"])
            ref = pa.paged_attention_decode_reference(*args, scale).float()
            cases[(geom, dtype)] = (args, scale, ref)
    flush = flush_buffer()
    clean = _CleanFlush(flush)
    smi = card()
    # A read yardstick: PyTorch's sum over the K and V pools, about the
    # bytes a call must read, streamed in order.
    print(json.dumps({"pool_read_ms": {
        f"{geom}_{str(dtype).split('.')[1]}": time_cold_ms(
            lambda: (args[1].sum(), args[2].sum()), flush)
        for (geom, dtype), (args, _, _) in cases.items()}, "card": smi}),
        flush=True)
    for order in (names, names[::-1]):
        for name in order:
            call, knames, rows = calls[name]
            # The host's plan for the variant's chunk size.
            pa.CHUNK_ROWS = rows or shipped_rows
            rec = {"variant": name, "rows": pa.CHUNK_ROWS, "card": smi}
            ok = True
            for (geom, dtype), (args, scale, ref) in cases.items():
                run = lambda: call(*args, scale)  # noqa: E731
                out = run().float()
                tol = TOL[dtype]
                ok = ok and bool(torch.isfinite(out).all()) and \
                    torch.allclose(out, ref, atol=tol, rtol=tol)
                key = f"{geom}_{str(dtype).split('.')[1]}"
                rec[key] = {"ms": time_cold_ms(run, flush),
                            "device_ms": device_ms(run, flush, knames)}
                if len(knames) > 1:       # each kernel's share
                    rec[key].update({n: device_ms(run, flush, (n,))
                                     for n in knames})
                if name == "shipped" or name.endswith(".cu"):
                    rec[key]["device_ms_clean_l2"] = device_ms(
                        run, clean, knames)
            pa.CHUNK_ROWS = shipped_rows
            rec["ok"] = ok
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
