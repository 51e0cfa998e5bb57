"""Dense layers in float32 on Hopper's tensor cores: y = x W^T + b, optionally
followed by the exact GELU (`csrc/linear_tf32x3.cu`).

Replaces no TPU kernel: the JAX package leaves its dense layers to XLA. The
port's wav2vec2 and WavLM encoders (encoders/wav2vec2.py) spend most of
their device time in these products, which cuBLAS runs on the CUDA cores
because TF32 is off (core/torch_setup.py: the configurations state
float32). The kernel keeps float32's accuracy on the tensor cores with the
3xTF32 split of csrc/tf32x3.cuh: each operand is a TF32 "big" part plus a
"small" remainder, and each product is a_small b_big + a_big b_small + a_big
b_big. Its floor is 2 M N K operations at 165 TFLOP/s (495 TFLOP/s dense
TF32 over three passes).

- `split_tf32(w)` -> (big, small), big + small == w exactly;
- `linear_tf32x3(x, w, b, gelu=False)`: a CPU tensor takes the plain path
  the encoder always took, `F.linear` (then `F.gelu`); a CUDA tensor
  launches the kernel or raises;
- `linear_tf32x3_reference`: the kernel's arithmetic in plain PyTorch (three
  float32 products of the rounded and truncated parts), for the tests and
  chip_smoke.py;
- `FusedLinear`: the kernel's operands of one or more `nn.Linear`s that read
  the same input (Q, K and V as one [3D, D] weight), split once and kept
  beside the parameters.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from ..core import cuda_build

KERNEL = "linear_tf32x3"
_LOW_BITS = -0x2000  # 0xffffe000 as int32: the 13 mantissa bits TF32 drops


def split_tf32(w: torch.Tensor):
    """float32 w -> (big, small): big = w rounded to TF32 on its bits, half a
    TF32 ulp added to the magnitude and the low 13 bits cleared (`to_tf32`
    of csrc/tf32x3.cuh), small = w - big, exact in float32."""
    bits = w.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & _LOW_BITS).view(torch.float32)
    return big, w - big


def _tf32_truncated(t: torch.Tensor) -> torch.Tensor:
    """t as the tensor core reads it: the low 13 mantissa bits dropped."""
    return (t.contiguous().view(torch.int32) & _LOW_BITS).view(torch.float32)


def _plain(x, w, b, gelu):
    y = F.linear(x, w, b)
    return F.gelu(y) if gelu else y


def linear_tf32x3_reference(x, w, b=None, gelu=False):
    """The kernel's arithmetic in plain PyTorch: the small products first,
    each a float32 product of TF32 values, then the bias and the GELU."""
    xb, xs = split_tf32(x)
    wb, ws = split_tf32(w)
    y = F.linear(_tf32_truncated(xs), wb) + F.linear(xb, _tf32_truncated(ws)) + F.linear(xb, wb)
    if b is not None:
        y = y + b
    return F.gelu(y) if gelu else y


def _operands(w):
    """The kernel's weight operands: split_tf32(w), K zero-padded to a multiple
    of 4 (TMA's 16-byte row stride)."""
    pad = -w.shape[1] % 4
    return split_tf32(F.pad(w, (0, pad)) if pad else w)


def _library():
    lib = cuda_build.load(KERNEL)
    fn = lib.mts_linear_tf32x3_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def linear_tf32x3(x, w, b=None, gelu=False):
    """x [..., K] float32 -> x w^T + b [..., N], then the exact GELU if `gelu`.

    `w` is the weight [N, K] or its pair (big, small) from `FusedLinear` (K
    padded to a multiple of 4); `b` is [N] or None. A CPU tensor takes
    `F.linear`. A CUDA tensor launches the kernel or raises: everything
    float32 on one device, no gradient (the encoder runs under inference
    mode)."""
    K = x.shape[-1]
    if x.device.type == "cpu":
        if isinstance(w, tuple):
            w = (w[0] + w[1])[:, :K]  # big + small == w exactly
        return _plain(x, w, b, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"linear_tf32x3 runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("linear_tf32x3 has no backward: call it under no_grad or inference_mode")
    big, small = w if isinstance(w, tuple) else _operands(w)
    N, Kp = big.shape
    if K == 0 or Kp != K + (-K % 4) or small.shape != big.shape:
        raise ValueError(f"x [..., {K}] against weight operands {tuple(big.shape)}")
    if b is not None and b.shape != (N,):
        raise ValueError(f"bias must be [{N}], got {tuple(b.shape)}")
    for name, t in (("x", x), ("weight", big), ("weight", small), ("bias", b)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be float32 on {x.device}")
    if not (big.is_contiguous() and small.is_contiguous() and (b is None or b.is_contiguous())):
        raise ValueError("weight operands and bias must be contiguous")
    x2 = x.reshape(-1, K)
    if Kp != K:
        x2 = F.pad(x2, (0, Kp - K))
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    M = x2.shape[0]
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    if M > 0:
        fn = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x2.data_ptr(), big.data_ptr(), small.data_ptr(),
                    None if b is None else b.data_ptr(), y.data_ptr(), M, N, Kp, int(gelu), stream)
        if rc != 0:
            raise RuntimeError(f"linear_tf32x3 kernel launch failed: cudaError {rc}")
        linear_tf32x3.launches += 1
    return y.view(*x.shape[:-1], N)


linear_tf32x3.launches = 0


def _version(p: torch.Tensor) -> int:
    return -1 if p.is_inference() else p._version


def param_key(params) -> tuple:
    """What a cache of operands made from `params` is keyed on: each one's
    storage, version, shape and device."""
    return tuple((p.data_ptr(), _version(p), tuple(p.shape), p.device) for p in params)


class FusedLinear:
    """The kernel's operands of `nn.Linear`s that read the same input: their
    weights concatenated along the outputs and split once (`split_tf32`),
    their biases concatenated. Rebuilt when a parameter's storage, version or
    shape changes (`load_state_dict`, `.to()`, an in-place update). Kept as a
    plain attribute of the module that owns the linears, so the state_dict
    and its names stay as they are; it holds 2 copies of the weights on the
    device where they ran.

    Called on x [..., K], it returns one output per linear (a view of one
    [..., sum of N] output on the card); a CPU tensor takes each `F.linear` as
    it is."""

    def __init__(self, *linears: nn.Linear):
        self.linears = linears
        self._key = None
        self._operands = None

    def operands(self):
        params = [p for lin in self.linears for p in (lin.weight, lin.bias) if p is not None]
        key = param_key(params)
        if key != self._key:
            self._operands = None  # the old split goes before the new one is made
            with torch.no_grad():
                w = torch.cat([lin.weight for lin in self.linears])
                bias = torch.cat([lin.bias if lin.bias is not None
                                  else lin.weight.new_zeros(lin.out_features)
                                  for lin in self.linears])
                self._operands = (_operands(w.float()), bias.float().contiguous())
            self._key = key
        return self._operands

    def __call__(self, x, gelu=False):
        if x.device.type == "cpu":
            out = tuple(_plain(x, lin.weight, lin.bias, gelu) for lin in self.linears)
        else:
            pair, bias = self.operands()
            y = linear_tf32x3(x, pair, bias, gelu)
            out = y.split([lin.out_features for lin in self.linears], dim=-1)
        return out[0] if len(out) == 1 else out
