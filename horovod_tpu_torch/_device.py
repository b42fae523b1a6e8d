"""Device resolution and the float32 policy of the port.

Every entry point of the port (``ServeEngine``, ``lm_decode``,
``init_lm_params``, ``TransformerLM``, ``ResNet``, ``hvd.init``,
``create_train_state``, ``bench.run``) takes an explicit ``device=``. ``None`` means the
card (``"cuda"``); a caller that wants the CPU says so. Without a CUDA
device a ``None``/``"cuda"`` request raises :class:`RuntimeError`: the
port never falls back to the CPU on its own.

**Float32 policy.** The JAX package computes float32 matrix products
in full float32 on its reference backends, and the parity tests hold
the port to it. PyTorch on the card may route a float32 product
through TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is set, so :func:`resolve_device`
clears both whenever it hands out a CUDA device, and pins
``torch.set_float32_matmul_precision("highest")``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def pin_fp32_policy() -> None:
    """Full-float32 matrix products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on the card by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        pin_fp32_policy()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
