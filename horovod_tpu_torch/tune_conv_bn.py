"""Time the bf16 fused 1x1-conv + BatchNorm-statistics kernel (K5) under
other tile constants.

    python -m horovod_tpu_torch.tune_conv_bn [variant ...]

Each variant is ``csrc/conv_bn.cu`` with some of its bf16 constants
replaced (all of :data:`VARIANTS` when none is named), built at once by
``nvcc`` into ``build/tune/``, checked against the plain version at every
shape (y to 2e-2, the statistics to 1e-3 relative) and timed with the L2
flushed at ResNet-50's 16 training-mode 1x1 shapes (batch 64, 224^2,
bf16, ``models.resnet.RESNET50_K5``), summed over one training step's 36
launches, in two passes of opposite order: ``step_ms`` spans the calls
(host gaps included), ``step_device_ms`` is K5's kernels alone as the
profiler traces them. A variant named by the path of a ``.cu`` file (an
older checkout's ``csrc/conv_bn.cu``) builds that file as it stands.
Prints one JSON line per variant and pass; the source ships the
constants of the fastest. The ``diag_`` variants drop one part of the
kernel (results wrong, ``ok`` false) to show where the time goes. Needs
a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from horovod_tpu_torch._timing import (card, device_ms, flush_buffer,
                                       time_cold_ms)
from horovod_tpu_torch._tune import build_variants
from horovod_tpu_torch.models.resnet import RESNET50_K5
from horovod_tpu_torch.ops import conv_bn as cb

BATCH = 64

_S = "constexpr int kStages = 3;"
_WN = "constexpr int kWideN = 128;"
#: name -> {text in the source: its replacement}.
VARIANTS = {
    "shipped": {},
    # 64-column tiles at every N: three blocks an SM, x read more often.
    "narrow": {_WN: _WN.replace("128", "64")},
    # Ring depth: 4 stages of 128-column slices leave one block an SM.
    "stages2": {_S: _S.replace("3;", "2;")},
    "stages4": {_S: _S.replace("3;", "4;")},
    # Timing only, wrong results: where the time goes, without the
    # reduction kernel, the y stores, the x/w loads (zero-filled slices),
    # the products, or anything of the main kernel but its launch.
    "diag_no_reduce": {
        "  reduce_partials_kernel<<<(N + kRC - 1) / kRC, kRC * kRGroups, 0, "
        "st>>>(\n      g.p1, g.p2, static_cast<float*>(s1), "
        "static_cast<float*>(s2), tiles,\n      N);\n": ""},
    "diag_no_store": {
        "      *reinterpret_cast<uint4*>(dst) = v.u;":
            "      if (g.M < 0) *reinterpret_cast<uint4*>(dst) = v.u;"},
    "diag_no_load": {
        "    cp_async16(dst, in ? src : base, in ? 16 : 0);":
            "    cp_async16(dst, base, 0);"},
    "diag_no_mma": {
        "      wgmma_ss_n<BN>(acc, sw128_desc(xs + wg * 64 * 64 + kk * 16, 0),"
        "\n                     sw128_desc(xs + kXS + kk * 16, 0));":
            "      acc[kk][0] += __bfloat162float(xs[tid + kk]);"},
    "diag_empty": {"conv_bn_bf16_kernel(Args g) {\n":
                   "conv_bn_bf16_kernel(Args g) {\n  if (g.M > 0) return;\n"},
}


def _inputs(rng, side, K, N, stride, prologue):
    x = torch.tensor(rng.standard_normal((BATCH, side, side, K),
                                         dtype=np.float32),
                     device="cuda").to(torch.bfloat16)[:, ::stride, ::stride]
    w = torch.tensor(rng.standard_normal((K, N), dtype=np.float32)
                     / np.sqrt(K), device="cuda").to(torch.bfloat16)
    a = b = None
    if prologue:
        a = torch.tensor(rng.uniform(0.5, 1.5, K).astype(np.float32),
                         device="cuda")
        b = torch.tensor(rng.uniform(0.1, 0.6, K).astype(np.float32),
                         device="cuda")
    return x, w, a, b


def _agrees(got, ref):
    y, s1, s2 = got
    ry, r1, r2 = ref
    scale = ry.float().abs().sum(0).clamp_min(1e-30)
    return (torch.allclose(y.float(), ry.float(), atol=2e-2, rtol=2e-2)
            and float(((s1 - r1).abs() / scale).max()) <= 1e-3
            and float(((s2 - r2).abs()
                       / r2.abs().clamp_min(1e-30)).max()) <= 1e-3)


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("tune_conv_bn: no CUDA device")
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names
               if n not in VARIANTS and not n.endswith(".cu")]
    if unknown:
        raise SystemExit(f"tune_conv_bn: unknown variants {unknown}; "
                         f"choose from {list(VARIANTS)}")
    libs = {n: cb.bind(lib) for n, lib in
            build_variants("conv_bn", VARIANTS, names).items()}
    rng = np.random.default_rng(21)
    shapes = [(_inputs(rng, *row[:5]), row) for row in RESNET50_K5]
    flush = flush_buffer()
    smi = card()
    for order in (names, names[::-1]):
        for name in order:
            lib = libs[name]
            ok, step_ms, step_dev, per_shape, per_dev = True, 0, 0, [], []
            for (x, w, a, b), (_, K, N, s, pro, count) in shapes:
                ref = cb._plain(x, w, a, b)
                ok = ok and _agrees(cb._launch(lib, x, w, a, b), ref)
                call = lambda: cb._launch(lib, x, w, a, b)  # noqa: E731
                ms = time_cold_ms(call, flush, iters=20, warmup=3)
                dev = device_ms(call, flush, cb.KERNEL_NAMES)
                per_shape.append(round(ms, 4))
                per_dev.append(round(dev, 4))
                step_ms += count * ms
                step_dev += count * dev
            print(json.dumps({"variant": name, "ok": ok, "step_ms": step_ms,
                              "step_device_ms": step_dev, "ms": per_shape,
                              "device_ms": per_dev, "card": smi}),
                  flush=True)


if __name__ == "__main__":
    main()
