"""Banded flash attention forward (kernel K2) and the fused forward-only
local attention (kernel K6): counterpart of the JAX package's
ops/pallas_attention.py, inference side.

Both compute softmax attention over the keys p with |p - i| <= window/2 and
0 <= p < length, for q, k, v [B, H, L, Dh] float32 and prefix masks. K2
(`_flash_fwd`, behind `flash_local_attention` and
`flash_local_attention_biased`) also takes an optional 1/sqrt(Dh) scale, an
additive bias tile and a post-softmax 0/1 tile, and returns the per-row
logsumexp; K6 (`fused_local_attention`) is always scaled and returns O only.
One CUDA source, `csrc/flash_local_attention.cu`, holds both entry points.

The TPU kernels work on [block, 3*block] score tiles with
`block, nb, pad = _flash_geometry(L, window // 2)`. That geometry stays part
of the function: the bias and 0/1 tiles are laid out in it, and a query row
that sees no valid key (padding) averages V over its three clamped blocks.
The plain versions below compute exactly that, blocked as the TPU kernels
are; the CUDA kernel tiles the band its own way and reproduces those rows.

The differentiable entries, the dropped variants and the backward kernels
(K3, K4, K5) come with the port of training.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import cuda_build
from .attention import _blocked_attention

KERNEL = "flash_local_attention"
MAX_HEAD_DIM = 128


def _flash_geometry(L: int, half: int):
    """Query-block size (window/2 rounded up to 8, at least 8), number of
    blocks and tail padding of the flash tile layout."""
    block = max(-(-half // 8) * 8, 8)
    nb = -(-L // block)
    return block, nb, nb * block - L


def _lengths(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.int32).sum(dim=1, dtype=torch.int32)


def flash_local_attention_reference(q, k, v, mask, window: int, bias=None, scale: bool = True,
                                    drop_mask=None, keep: float = 1.0):
    """Plain PyTorch version of K2 -> (out [B, H, L, Dh], lse [B, H, L])."""
    half = window // 2
    block = _flash_geometry(q.shape[2], half)[0]
    return _blocked_attention(q, k, v, half, block, lengths=_lengths(mask), bias=bias,
                              scale=scale, drop_mask=drop_mask, keep=keep)


def fused_local_attention_reference(q, k, v, window: int, mask=None):
    """Plain PyTorch version of K6 -> out [B, H, L, Dh]."""
    B, _, L, _ = q.shape
    if mask is None:
        mask = torch.ones(B, L, dtype=q.dtype, device=q.device)
    return flash_local_attention_reference(q, k, v, mask, window)[0]


def _check_qkv(q, k, v, mask, window):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, L, Dh] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window % 2 != 0 or window < 0:
        raise ValueError("attention window must be even")
    if mask.shape != (q.shape[0], q.shape[2]):
        raise ValueError(f"mask must be [B, L] = {(q.shape[0], q.shape[2])}, "
                         f"got {tuple(mask.shape)}")


def _check_cuda(tensors, device):
    for name, t in tensors:
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {device}")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_head_dim(Dh):
    if Dh % 4 != 0 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims that are multiples of 4 up to "
                         f"{MAX_HEAD_DIM}, got {Dh}")


def _library():
    lib = cuda_build.load(KERNEL)
    k2 = lib.mts_flash_local_attention_f32
    k2.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    k2.restype = ctypes.c_int
    k6 = lib.mts_fused_local_attention_f32
    k6.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    k6.restype = ctypes.c_int
    return k2, k6


def _flash_fwd(q, k, v, mask, window: int, bias=None, scale: bool = True, drop_mask=None,
               keep: float = 1.0):
    """K2 -> (out [B, H, L, Dh], lse [B, H, L]).

    mask: [B, L] prefix mask (1 = valid). bias: [H, block, 3*block] with
    block = _flash_geometry(L, window // 2)[0]; column c of row r is the key
    offset c - block - r. drop_mask: [B*H, nb*block, 3*block] of 0/1, applied
    to the softmaxed weights and scaled by 1/keep (lse stays undropped).

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: contiguous float32 on one device, Dh a multiple of 4 up to 128."""
    _check_qkv(q, k, v, mask, window)
    B, H, L, Dh = q.shape
    half = window // 2
    block, nb, _ = _flash_geometry(L, half)
    if bias is not None and bias.shape != (H, block, 3 * block):
        raise ValueError(f"bias must be [H, block, 3*block] = {(H, block, 3 * block)}, "
                         f"got {tuple(bias.shape)}")
    if drop_mask is not None and drop_mask.shape != (B * H, nb * block, 3 * block):
        raise ValueError(f"drop_mask must be {(B * H, nb * block, 3 * block)}, "
                         f"got {tuple(drop_mask.shape)}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")
    if q.device.type == "cpu":
        return flash_local_attention_reference(q, k, v, mask, window, bias, scale, drop_mask, keep)
    if q.device.type != "cuda":
        raise ValueError(f"flash local attention runs on cpu or cuda, not {q.device}")
    _check_head_dim(Dh)
    named = [("q", q), ("k", k), ("v", v)]
    named += [("bias", bias)] if bias is not None else []
    named += [("drop_mask", drop_mask)] if drop_mask is not None else []
    _check_cuda(named, q.device)
    lengths = _lengths(mask.to(q.device)).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn, _ = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if drop_mask is None else drop_mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), B, H, L, Dh, half, block,
                1.0 / math.sqrt(Dh) if scale else 1.0, keep, stream)
    if rc != 0:
        raise RuntimeError(f"flash_local_attention kernel launch failed: cudaError {rc}")
    _flash_fwd.launches += 1
    return out, lse


_flash_fwd.launches = 0


def flash_local_attention(q, k, v, mask, window: int):
    """Scaled, unbiased banded attention (the Longformer-family call).
    q, k, v: [B, H, L, Dh]; mask: [B, L] prefix mask; window even."""
    return _flash_fwd(q, k, v, mask, window)[0]


def flash_local_attention_biased(q, k, v, mask, bias, window: int, scale: bool = False):
    """Banded attention with a translation-invariant additive bias tile
    [H, block, 3*block] (the T5-family call, unscaled by default)."""
    return _flash_fwd(q, k, v, mask, window, bias=bias, scale=scale)[0]


def fused_local_attention(q, k, v, window: int, mask=None):
    """K6: forward-only banded attention, always scaled by 1/sqrt(Dh).
    q, k, v: [B, H, L, Dh]; window even; mask: [B, L] prefix mask or None.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (contiguous float32 on one device, Dh a multiple of 4 up to 128)."""
    B, H, L, Dh = q.shape
    if mask is None:
        mask = torch.ones(B, L, dtype=q.dtype, device=q.device)
    _check_qkv(q, k, v, mask, window)
    if q.device.type == "cpu":
        return fused_local_attention_reference(q, k, v, window, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused local attention runs on cpu or cuda, not {q.device}")
    _check_head_dim(Dh)
    _check_cuda([("q", q), ("k", k), ("v", v)], q.device)
    half = window // 2
    block = _flash_geometry(L, half)[0]
    lengths = _lengths(mask.to(q.device)).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _, fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, H, L, Dh, half, block, stream)
    if rc != 0:
        raise RuntimeError(f"fused_local_attention kernel launch failed: cudaError {rc}")
    fused_local_attention.launches += 1
    return out


fused_local_attention.launches = 0
