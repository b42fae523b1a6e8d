"""Gradient compression for the collectives: the port of
``horovod_tpu.jax.compression``.

A ``Compressor`` has ``compress(tensor) -> (tensor, ctx)`` and
``decompress(tensor, ctx)``. ``Compression.none`` and ``.fp16`` are the
reference's; ``.bf16`` casts to bfloat16 on the wire. The low-bit codecs
``.int8`` and ``.fp8`` quantize only the inter-node leg of the
hierarchical ladder, which the port does not have yet: they raise
``NotImplementedError`` (ROADMAP.md Queue 1, parallelism).
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


class _NotPortedCompressor(Compressor):
    """A low-bit wire codec of the hierarchical ladder, not ported yet."""

    @classmethod
    def compress(cls, tensor):
        raise NotImplementedError(
            f"{cls.__name__} quantizes the hierarchical ladder's "
            "inter-node leg, which the port does not have yet "
            "(ROADMAP.md Queue 1, parallelism)")

    decompress = compress


class Int8Compressor(_NotPortedCompressor):
    pass


class FP8Compressor(_NotPortedCompressor):
    pass


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor
