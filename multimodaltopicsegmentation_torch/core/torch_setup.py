"""Process-level PyTorch configuration: the counterpart of core/jax_setup.py.

- Float32 throughout, as on the JAX path: cuDNN convolutions default to TF32
  on the card (about three decimal digits), so TF32 is switched off for
  matmuls and for cuDNN.
- Device pick: entry points run on `cuda` unless the caller asks for `cpu`.
  A CUDA request without a card raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch


def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device, after `setup()`; raises if CUDA is asked for and absent."""
    setup()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass --device cpu to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
