"""Fused masked instance norm + exact GELU: kernel K1 of the port.

Counterpart of `ops/pallas_norm.py:pallas_instance_norm_gelu` in the JAX
package. wav2vec2's conv layer 0 is followed by a GroupNorm with
groups == channels (a per-channel instance norm over time) and an exact
GELU. The JAX engine always passes unit lengths, so the function its path
computes is the MASKED group norm of `encoders/wav2vec2.py:_group_norm`
(statistics over each row's valid frames only), which without lengths
reduces to the Pallas kernel's function. Both this module's plain version
and its CUDA kernel compute that masked function:

- per (row, channel): mean and two-pass variance over the first
  `lengths[b]` frames, count max(valid, 1), eps 1e-5;
- normalisation, affine and exact GELU over ALL T frames (padded frames are
  not zeroed), so a zero-length row of zeros gives gelu(bias).

The kernel (`csrc/instance_norm_gelu.cu`) is memory-bound: one 256-row
main-path chunk [256, 512, 3199] f32 is 1.68 GB, read once and written once
3.35 GB, about 1.0 ms at the H100 data-sheet rate of 3.35 TB/s. One block
holds one whole series on chip, so it makes one read and one write.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core import cuda_build

EPS = 1e-5
KERNEL = "instance_norm_gelu"


def instance_norm_gelu_reference(x, scale, bias, lengths=None):
    """Plain PyTorch version. x: [B, C, T]; scale, bias: [C]; lengths: [B]."""
    T = x.shape[-1]
    if lengths is None:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, correction=0, keepdim=True)
    else:
        m = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None]).to(x.dtype)[:, None, :]
        cnt = m.sum(-1, keepdim=True).clamp_min(1.0)
        mu = (x * m).sum(-1, keepdim=True) / cnt
        var = (m * (x - mu) ** 2).sum(-1, keepdim=True) / cnt
    y = (x - mu) * torch.rsqrt(var + EPS) * scale[:, None] + bias[:, None]
    return F.gelu(y, approximate="none")


def _library():
    lib = cuda_build.load(KERNEL)
    fn = lib.mts_instance_norm_gelu_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def instance_norm_gelu(x, scale, bias, lengths=None):
    """gelu(masked instance_norm(x)) for x [B, C, T] f32.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    or raises: it must be contiguous float32, with scale/bias float32 [C]
    and lengths int32 [B] (or None) on the same device."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, T], got shape {tuple(x.shape)}")
    B, C, T = x.shape
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be [{C}], got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if lengths is not None and lengths.shape != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    if x.device.type == "cpu":
        return instance_norm_gelu_reference(x, scale, bias, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_gelu runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {x.device}")
    if lengths is not None and (lengths.dtype != torch.int32 or lengths.device != x.device
                                or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be contiguous int32 on {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                None if lengths is None else lengths.data_ptr(), out.data_ptr(),
                B, C, T, stream)
    if rc != 0:
        raise RuntimeError(f"instance_norm_gelu kernel launch failed: cudaError {rc}")
    instance_norm_gelu.launches += 1
    return out


instance_norm_gelu.launches = 0
