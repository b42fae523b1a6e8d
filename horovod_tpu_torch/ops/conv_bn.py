"""Fused 1x1-conv (matmul) + BatchNorm statistics: the port of
``horovod_tpu.ops.conv_bn``.

ResNet-50 makes 36 of its 53 convolutions 1x1, that is plain matrix
products over the ``[B*H*W, C]`` activation. In training mode every conv
output is read again just to take its channel mean and variance; the
fused op computes ``y = h @ w`` and the per-channel ``s1 = sum(y)``,
``s2 = sum(y^2)`` of the rounded ``y`` in one pass, so that read never
happens. With the prologue, ``h = relu(x*a + b)`` is the producing
layer's BatchNorm apply and ReLU, run on the raw input while it is
loaded, so the normalised activation is never stored either.

* :func:`matmul_bn_stats` ``(x, w)`` and :func:`matmul_prologue_bn_stats`
  ``(x, a, b, w)`` return ``(y, s1, s2)`` and are differentiable
  (``torch.autograd.Function``), with the JAX names and argument orders;
* :func:`conv1x1_bn_stats` and :func:`conv1x1_prologue_bn_stats` are their
  NHWC wrappers: ``w`` is ``[1, 1, Cin, Cout]`` or ``[Cin, Cout]``, and a
  stride reads the subsampled input ``x[:, ::sh, ::sw, :]`` in place;
* :func:`bn_stats_forward` is the kernel wrapper (K5,
  ``csrc/conv_bn.cu``, built by ``nvcc`` for ``sm_90a`` at first use and
  bound through a plain C interface and ``ctypes``). On a CPU tensor it
  runs the plain versions :func:`matmul_bn_stats_reference` /
  :func:`matmul_prologue_bn_stats_reference` (float32, bfloat16 and
  float64); on a CUDA tensor it launches the kernel (float32 or bfloat16)
  or raises. Each launch adds one to ``bn_stats_forward.launches``, and
  one with the prologue also to ``bn_stats_forward.prologue_launches``.

The backward is plain torch, as the JAX ``custom_vjp`` computes it with
``jnp.dot`` outside any Pallas kernel: the three cotangents collapse into
``dy_total = dy + ds1 + 2*y*ds2`` in float32 (float64 for float64), cast
to x's type before the products, then the matrix products (accumulated in
float32) and, for the prologue, ``h = relu(x*a + b)`` recomputed from the
raw input with the ``da``/``db`` sums.

The JAX module's ``fits_fused`` / ``_pick_block_m`` are a TPU VMEM policy
(the whole ``[K, N]`` weight resident in 13 MB): the CUDA kernel streams
the weight in tiles and masks ragged rows itself, so every training-mode
1x1 conv is fused here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 accumulation for <= 32-bit inputs; float64 only for the
    float64 exactness probes on the CPU."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# --------------------------------------------------------------------------
# The plain versions


def matmul_bn_stats_reference(x, w):
    """``(y, s1, s2)`` of ``y = x @ w`` with float32 accumulation, ``y`` in
    x's type, and the statistics over the rounded ``y``: x ``[M, K]``, w
    ``[K, N]``."""
    acc = _acc_dtype(x.dtype)
    y = torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)
    yr = y.to(acc)
    return y, yr.sum(0), (yr * yr).sum(0)


def matmul_prologue_bn_stats_reference(x, a, b, w):
    """:func:`matmul_bn_stats_reference` of ``h = relu(x*a + b)``, the
    affine in x's type with ``a``/``b`` cast to it first."""
    h = torch.relu(x * a.to(x.dtype) + b.to(x.dtype))
    return matmul_bn_stats_reference(h, w)


# --------------------------------------------------------------------------
# The kernel wrapper


def _rows(x):
    """``x`` as ``[B, H, W, K]`` (a ``[M, K]`` matrix is ``[M, 1, 1, K]``)."""
    if x.dim() == 2:
        return x[:, None, None, :]
    if x.dim() != 4:
        raise ValueError(f"bn_stats_forward: x {tuple(x.shape)} must be "
                         "[M, K] or [B, H, W, K]")
    return x


def _plain(x4, w, a, b):
    x = x4.reshape(-1, x4.shape[-1])
    if a is None:
        return matmul_bn_stats_reference(x, w)
    return matmul_prologue_bn_stats_reference(x, a, b, w)


def _check_cuda(x, w, a, b):
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"bn_stats_forward: dtype {x.dtype} not in "
                         f"{list(_KERNEL_DTYPES)}")
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"bn_stats_forward: {name} on {t.device}, x on "
                             f"{x.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"bn_stats_forward: w is {w.dtype}, x {x.dtype}")


def bn_stats_forward(x, w, a=None, b=None):
    """K5: ``(y [M, N] in x's type, s1 [N], s2 [N])`` of ``y = h @ w`` with
    ``h = x`` or, given ``a``/``b`` ``[K]``, ``h = relu(x*a + b)``.

    ``x`` is ``[M, K]`` or an NHWC ``[B, H, W, K]`` view (rows taken in
    (b, h, w) order, any batch/row/column strides, read in place when the
    channel stride is 1); ``w`` is ``[K, N]``. The statistics are float32
    (float64 for float64 inputs) sums over the rounded ``y``. A CPU ``x``
    runs the plain version; a CUDA ``x`` launches the kernel (float32 or
    bfloat16) or raises."""
    x4 = _rows(x)
    K = x4.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"bn_stats_forward: w {tuple(w.shape)} must be "
                         f"[K={K}, N]")
    if (a is None) != (b is None) or (
            a is not None and (tuple(a.shape) != (K,)
                               or tuple(b.shape) != (K,))):
        raise ValueError(f"bn_stats_forward: a and b must both be [K={K}] "
                         "or both None")
    if x4.device.type == "cpu":
        return _plain(x4, w, a, b)
    if x4.device.type != "cuda":
        raise ValueError(f"bn_stats_forward: unsupported device {x4.device}")
    _check_cuda(x4, w, a, b)
    if x4.stride(3) != 1:
        x4 = x4.contiguous()
    Bn, H, W, _ = x4.shape
    M, N = Bn * H * W, w.shape[1]
    wt = w.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    if a is not None:
        a = a.to(x4.dtype).contiguous()
        b = b.to(x4.dtype).contiguous()
    dt = _KERNEL_DTYPES[x4.dtype]
    lib = _lib()
    tiles = -(-M // lib.hvd_conv_bn_tile_rows(dt))
    dev = x4.device
    y = torch.empty((M, N), dtype=x4.dtype, device=dev)
    part = torch.empty((2, tiles, N), dtype=torch.float32, device=dev)
    s1 = torch.empty((N,), dtype=torch.float32, device=dev)
    s2 = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hvd_conv_bn_stats(
            dt, x4.data_ptr(), None if a is None else a.data_ptr(),
            None if b is None else b.data_ptr(), wt.data_ptr(), y.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), s1.data_ptr(),
            s2.data_ptr(), M, K, N, H, W, x4.stride(0), x4.stride(1),
            x4.stride(2), int(a is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_stats_forward: kernel launch failed (cuda "
                           f"error {rc})")
    bn_stats_forward.launches += 1
    if a is not None:
        bn_stats_forward.prologue_launches += 1
    return y, s1, s2


bn_stats_forward.launches = 0
bn_stats_forward.prologue_launches = 0

_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    from horovod_tpu_torch import _build

    lib = _build.load("conv_bn")
    if lib.hvd_conv_bn_stats.argtypes is None:
        lib.hvd_conv_bn_tile_rows.argtypes = [_CI]
        lib.hvd_conv_bn_tile_rows.restype = _CI
        lib.hvd_conv_bn_stats.argtypes = ([_CI] + [_VP] * 9 + [_CI] * 5
                                          + [_CL] * 3 + [_CI, _VP])
        lib.hvd_conv_bn_stats.restype = _CI
    return lib


# --------------------------------------------------------------------------
# The differentiable ops


def _stats_cotangent_total(y, dy, ds1, ds2, acc):
    """The three cotangent paths as one elementwise total (the JAX
    module's docstring): ``dy + ds1 + 2*y*ds2`` in ``acc``."""
    return (dy.to(acc) + ds1[None, :].to(acc)
            + 2.0 * y.to(acc) * ds2[None, :].to(acc))


class _BNStats(torch.autograd.Function):
    """``(x4 [B, H, W, K], w [K, N], a, b) -> (y [M, N], s1, s2)``: the
    forward through :func:`bn_stats_forward`, the backward the JAX
    ``custom_vjp`` in plain torch."""

    @staticmethod
    def forward(ctx, x4, w, a, b):
        y, s1, s2 = bn_stats_forward(x4, w, a, b)
        ctx.save_for_backward(x4, w, y, a, b)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x4, w, y, a, b = ctx.saved_tensors
        x = x4.reshape(-1, x4.shape[-1])
        acc = _acc_dtype(x.dtype)
        dyt = _stats_cotangent_total(y, dy, ds1, ds2, acc).to(x.dtype)
        if a is None:
            dx = torch.matmul(dyt, w.t())
            dw = torch.matmul(x.t(), dyt)
            return dx.reshape(x4.shape), dw.to(w.dtype), None, None
        # Recompute h from the raw input: the same bytes the unfused
        # backward reads from the stored h.
        pre = x * a.to(x.dtype)[None, :] + b.to(x.dtype)[None, :]
        h = torch.relu(pre)
        mask = (pre > 0).to(x.dtype)
        dw = torch.matmul(h.t(), dyt)
        dh = torch.matmul(dyt, w.t()) * mask
        dx = dh * a.to(x.dtype)[None, :]
        da = (dh.to(acc) * x.to(acc)).sum(0)
        db = dh.to(acc).sum(0)
        return (dx.reshape(x4.shape), dw.to(w.dtype), da.to(a.dtype),
                db.to(b.dtype))


def matmul_bn_stats(x, w):
    """Fused ``y = x @ w`` plus the channel statistics ``(sum y, sum
    y^2)`` of the rounded ``y``: x ``[M, K]``, w ``[K, N]``."""
    return _BNStats.apply(_rows(x), w, None, None)


def matmul_prologue_bn_stats(x, a, b, w):
    """Fused ``y = relu(x*a + b) @ w`` plus the channel statistics of
    ``y``: ``x`` is the producing conv's raw output, ``a``/``b`` its folded
    BatchNorm scale and shift."""
    return _BNStats.apply(_rows(x), w, a, b)


def _nhwc(x, w, strides: Sequence[int]):
    if w.dim() == 4:
        if tuple(w.shape[:2]) != (1, 1):
            raise ValueError(f"conv1x1: kernel {tuple(w.shape)} is not 1x1")
        w = w[0, 0]
    sh, sw = strides
    if (sh, sw) != (1, 1):
        # A strided 1x1 conv reads only the subsampled input; the kernel
        # takes the view's strides, so nothing is copied.
        x = x[:, ::sh, ::sw, :]
    return x, w


def conv1x1_bn_stats(x, w, strides: Tuple[int, int] = (1, 1)):
    """1x1 NHWC convolution with fused BN statistics: x ``[B, H, W, Cin]``,
    w ``[1, 1, Cin, Cout]`` or ``[Cin, Cout]`` -> ``(y [B, H', W', Cout],
    s1 [Cout], s2 [Cout])``."""
    x, w = _nhwc(x, w, strides)
    y, s1, s2 = _BNStats.apply(x, w, None, None)
    return y.reshape(*x.shape[:3], -1), s1, s2


def conv1x1_prologue_bn_stats(x, a, b, w,
                              strides: Tuple[int, int] = (1, 1)):
    """NHWC wrapper of :func:`matmul_prologue_bn_stats`: ``x`` is the raw
    producing-conv output, ``a``/``b`` its folded BN scale/shift."""
    x, w = _nhwc(x, w, strides)
    y, s1, s2 = _BNStats.apply(x, w, a, b)
    return y.reshape(*x.shape[:3], -1), s1, s2

