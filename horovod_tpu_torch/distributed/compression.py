"""Gradient compression for the collectives: the port of
``horovod_tpu.jax.compression``.

A ``Compressor`` has ``compress(tensor) -> (tensor, ctx)`` and
``decompress(tensor, ctx)``. ``Compression.none`` and ``.fp16`` are the
reference's; ``.bf16`` casts to bfloat16 on the wire.

The low-bit codecs ``.int8`` and ``.fp8`` quantize only the inter-host
leg of the hierarchical bucket ladder
(:mod:`horovod_tpu_torch.distributed.fusion`), with one absmax scale per
bucket shard and an error-feedback residual carried in the optimizer's
state (the 1-bit-SGD / Deep-Gradient-Compression lineage). Their
``compress``/``decompress`` are identity: nothing is cast before
bucketing, the intra-host legs stay at the gradients' dtype, and without
an engaged ladder they are lossless. ``quantize``/``dequantize`` are the
wire codec the ladder calls on each shard. The fp8 payload crosses the
wire as its ``uint8`` view (:meth:`_ScaledQuantCompressor.wire_view`).
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @classmethod
    def plan_dtype(cls, dtype):
        """The dtype a tensor of ``dtype`` enters the bucket plan with."""
        return dtype


class NoneCompressor(Compressor):
    """No-op."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if cls.plan_dtype(dtype) != dtype:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def plan_dtype(cls, dtype):
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            return cls.wire_dtype
        return dtype

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to float16 before the collective, back after."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast floating tensors to bfloat16 on the wire."""

    wire_dtype = torch.bfloat16


class _ScaledQuantCompressor(Compressor):
    """Base of the low-bit inter-host wire codecs: per-shard absmax
    scaling. ``quantize(v) -> (payload, scale)`` maps a float tensor onto
    the wire dtype with one float32 scale (``absmax / cap``; 1 for an
    all-zero shard); ``dequantize(payload, scale)`` returns float32."""

    dcn_wire = True
    wire_dtype: torch.dtype
    #: Largest representable magnitude of the wire dtype; absmax maps
    #: onto it.
    cap: float

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor

    @classmethod
    def quantize(cls, v):
        v = v.float()
        absmax = v.abs().max()
        scale = torch.where(absmax > 0, absmax / cls.cap,
                            torch.ones((), device=v.device))
        return cls._encode(v / scale), scale

    @classmethod
    def dequantize(cls, payload, scale):
        return payload.float() * scale

    @staticmethod
    def wire_view(payload):
        """The payload as bytes: a one-byte view the collectives carry
        whatever dtypes the backend knows (gloo has no float8)."""
        return payload.view(torch.uint8)


class Int8Compressor(_ScaledQuantCompressor):
    """int8 wire: symmetric linear quantization to [-127, 127] (4x fewer
    wire bytes than float32)."""

    wire_dtype = torch.int8
    cap = 127.0

    @staticmethod
    def _encode(scaled):
        return torch.clamp(torch.round(scaled), -127.0,
                           127.0).to(torch.int8)


class FP8Compressor(_ScaledQuantCompressor):
    """float8_e4m3fn wire: absmax-scaled into the format's finite range,
    clipped before the cast (torch's cast does not saturate)."""

    wire_dtype = torch.float8_e4m3fn
    cap = 448.0  # float8_e4m3fn finite max

    @staticmethod
    def _encode(scaled):
        return torch.clamp(scaled, -448.0, 448.0).to(torch.float8_e4m3fn)


def is_dcn_wire(compression) -> bool:
    """True for the low-bit codecs that compress only the hierarchical
    inter-host leg (int8/fp8)."""
    return bool(getattr(compression, "dcn_wire", False))


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor
