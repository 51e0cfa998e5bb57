"""The strided convolutions of the wav2vec2 / WavLM feature stack, channels-
last, in float32 on the card (`csrc/conv_tf32x3.cu`).

Replaces no TPU kernel: the JAX package leaves its convolutions to XLA. The
port's encoders (encoders/wav2vec2.py) ran their conv stack as cuDNN float32
FFMA convolutions on [B, C, T] (TF32 is off: the configurations state
float32), with two transposes around each of WavLM's per-frame LayerNorms.
On the card the stack now stays [B, frames, C] from conv layer 0's output to
the feature projection, each layer's frame count padded so that its input
holds exactly `stride` times its output's frames:

- `conv_tf32x3(x, w, b, stride, gelu=False)`: conv layers 1.. as an implicit
  GEMM with the 3xTF32 `wgmma` body of the dense layer (ops/linear_tf32x3),
  K = k C_in in (tap, channel) order; its floor is 2 k C_in C_out T_out
  operations at 165 TFLOP/s;
- `first_conv(audio, w, b, stride, frames)`: conv layer 0 (one input
  channel) on the CUDA cores, channels-last; memory-bound;
- `channels_last(x, frames)`: [B, C, T] -> [B, frames, C], frames past T
  zero: the one pass that brings K1's output (ops/instance_norm_gelu) into
  the layout;
- `layer_norm_gelu(x, weight, bias, eps)`: WavLM's per-frame LayerNorm and
  the exact GELU over the rows of a channels-last activation, one read and
  one write;
- `conv_tf32x3_reference`: the GEMM's arithmetic in plain PyTorch (three
  float32 products of the rounded and truncated parts), for the tests and
  chip_smoke.py;
- `FusedConv`: the GEMM's weight operands of one `nn.Conv1d`, [C_out, k C_in]
  in (tap, channel) order, split once and kept beside the parameters.

A CPU tensor takes the plain versions (`F.conv1d`, a transpose); a CUDA
tensor launches the kernel or raises. The encoder's CPU path does not come
here: it keeps its [B, C, T] stack as it was.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from ..core import cuda_build
from .linear_tf32x3 import linear_tf32x3_reference, param_key, split_tf32

KERNEL = "conv_tf32x3"
FIRST_MAX_TAPS = 16  # conv layer 0's taps a thread holds in registers


def _tail(k, stride):
    """Frames of zeros the plain versions append so that output frame P - 1
    of a [B, stride P, C] input exists (the card reads the next row there)."""
    return max(k - stride, 0)


def _plain(x, w, b, stride, gelu):
    y = F.conv1d(F.pad(x.transpose(1, 2), (0, _tail(w.shape[2], stride))), w, b, stride=stride)
    y = y.transpose(1, 2).contiguous()
    return F.gelu(y) if gelu else y


def _first_conv_plain(audio, w, b, stride, frames):
    need = stride * (frames - 1) + w.shape[2]
    S = audio.shape[1]
    a = F.pad(audio, (0, need - S)) if need > S else audio[:, :need]
    return F.conv1d(a[:, None], w, b, stride=stride).transpose(1, 2).contiguous()


def _channels_last_plain(x, frames):
    return F.pad(x, (0, frames - x.shape[2])).transpose(1, 2).contiguous()


def _layer_norm_gelu_plain(x, weight, bias, eps):
    return F.gelu(F.layer_norm(x, (x.shape[-1],), weight, bias, eps))


def _columns(x, k, stride):
    """x [B, stride P, C] -> the GEMM's A [B P, k C], (tap, channel) order."""
    B, _, C = x.shape
    xp = F.pad(x, (0, 0, 0, _tail(k, stride)))
    return xp.unfold(1, k, stride).transpose(2, 3).reshape(-1, k * C)


def gemm_weight(w):
    """[C_out, C_in, k] -> [C_out, k C_in] in (tap, channel) order."""
    return w.permute(0, 2, 1).reshape(w.shape[0], -1)


def conv_tf32x3_reference(x, w, b=None, stride=1, gelu=False):
    """The kernel's arithmetic in plain PyTorch on x [B, stride P, C_in]: the
    columns of each output frame times the (tap, channel) weight, three TF32
    products a float32 one (linear_tf32x3_reference). -> [B, P, C_out]."""
    B, Tin, _ = x.shape
    y = linear_tf32x3_reference(_columns(x, w.shape[2], stride), gemm_weight(w), b, gelu)
    return y.view(B, Tin // stride, -1)


def _library():
    lib = cuda_build.load(KERNEL)
    fns = (lib.mts_conv_tf32x3_f32, lib.mts_first_conv_f32, lib.mts_channels_last_f32,
           lib.mts_layer_norm_gelu_f32)
    fns[0].argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fns[1].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fns[2].argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fns[3].argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p])
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _on_card(name, x, *tensors):
    """Raises unless x is a float32 CUDA tensor and the others (None allowed)
    contiguous float32 on its device; no gradient."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{name} has no backward: call it under no_grad or inference_mode")
    for t in (x, *tensors):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every operand must be contiguous float32 on {x.device}")


def conv_tf32x3(x, w, b=None, stride=1, gelu=False):
    """x [B, stride P, C_in] float32, channels-last -> [B, P, C_out]: output
    frame t is sum_j W[:, :, j] x[:, stride t + j] + b, then the exact GELU if
    `gelu`.

    `w` is the conv weight [C_out, C_in, k] on the CPU and `FusedConv`'s
    (pair, k) on the card: the split [C_out, k C_in] operands
    (`split_tf32(gemm_weight(w))`) and the taps. An output frame that reaches
    past the input's stride P frames (the last one when k > stride) is
    undefined on the card, which reads the next batch row there; the CPU's
    plain version reads zeros. A CPU tensor takes `F.conv1d`; a CUDA tensor
    launches the kernel or raises (C_in a multiple of 4, no gradient)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, frames, C], got shape {tuple(x.shape)}")
    B, Tin, C = x.shape
    if Tin % stride:
        raise ValueError(f"frames {Tin} are not a multiple of the stride {stride}")
    if x.device.type == "cpu":
        return _plain(x, w, b, stride, gelu)
    if not isinstance(w, tuple):
        raise ValueError("on the card conv_tf32x3 takes the split operands (pair, k) "
                         "of FusedConv, not a conv weight")
    (big, small), k = w
    N = big.shape[0]
    if C % 4 or big.shape != (N, k * C) or small.shape != big.shape:
        raise ValueError(f"x [.., {C}] against weight operands {tuple(big.shape)}, k {k} "
                         "(C_in must be a multiple of 4)")
    if b is not None and b.shape != (N,):
        raise ValueError(f"bias must be [{N}], got {tuple(b.shape)}")
    _on_card("conv_tf32x3", x, big, small, b)
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty(B, Tin // stride, N, device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    fn = _library()[0]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), big.data_ptr(), small.data_ptr(), None if b is None else b.data_ptr(),
                y.data_ptr(), B * (Tin // stride), C, N, k, stride, int(gelu), _stream(x))
    _check("conv_tf32x3", rc)
    conv_tf32x3.launches += 1
    return y


conv_tf32x3.launches = 0


def first_conv(audio, w, b=None, stride=1, frames=None):
    """audio [B, S] float32 -> [B, frames, C] channels-last: frame t is
    sum_j w[:, 0, j] audio[:, stride t + j] + b, samples at or past S read as
    zero. `w` is [C, 1, k] (k <= 16 on the card). A CPU tensor takes
    `F.conv1d`; a CUDA tensor launches the kernel or raises."""
    B, S = audio.shape
    C, c_in, k = w.shape
    if c_in != 1:
        raise ValueError(f"first_conv takes one input channel, the weight has {c_in}")
    if b is not None and b.shape != (C,):
        raise ValueError(f"bias must be [{C}], got {tuple(b.shape)}")
    if audio.device.type == "cpu":
        return _first_conv_plain(audio, w, b, stride, frames)
    if k > FIRST_MAX_TAPS:
        raise ValueError(f"first_conv takes at most {FIRST_MAX_TAPS} taps on the card, not {k}")
    _on_card("first_conv", audio, w, b)
    y = torch.empty(B, frames, C, device=audio.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    fn = _library()[1]
    with torch.cuda.device(audio.device):
        rc = fn(audio.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                B, S, C, k, stride, frames, _stream(audio))
    _check("first_conv", rc)
    first_conv.launches += 1
    return y


first_conv.launches = 0


def channels_last(x, frames):
    """x [B, C, T] -> [B, frames, C] (frames >= T), frames past T zero. A CPU
    tensor takes a transpose; a CUDA tensor launches the kernel or raises."""
    B, C, T = x.shape
    if frames < T:
        raise ValueError(f"frames {frames} < the input's {T}")
    if x.device.type == "cpu":
        return _channels_last_plain(x, frames)
    _on_card("channels_last", x)
    y = torch.empty(B, frames, C, device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    fn = _library()[2]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), B, C, T, frames, _stream(x))
    _check("channels_last", rc)
    channels_last.launches += 1
    return y


channels_last.launches = 0


def layer_norm_gelu(x, weight, bias, eps=1e-5):
    """gelu(layer_norm(x)) over the last dimension of x [..., C] float32. A
    CPU tensor takes `F.layer_norm` then `F.gelu`; a CUDA tensor launches the
    kernel or raises (C a multiple of 4)."""
    C = x.shape[-1]
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"weight/bias must be [{C}], got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.device.type == "cpu":
        return _layer_norm_gelu_plain(x, weight, bias, eps)
    if C % 4:
        raise ValueError(f"layer_norm_gelu takes rows of a multiple of 4 floats on the card, not {C}")
    _on_card("layer_norm_gelu", x, weight, bias)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = _library()[3]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // C,
                C, eps, _stream(x))
    _check("layer_norm_gelu", rc)
    layer_norm_gelu.launches += 1
    return y


layer_norm_gelu.launches = 0


class FusedConv:
    """The GEMM's operands of one `nn.Conv1d`: its weight as [C_out, k C_in]
    in (tap, channel) order, split once (`split_tf32`), and its bias (or
    None). Rebuilt when a parameter's storage, version or shape changes, as
    ops/linear_tf32x3.FusedLinear is; kept as a plain attribute, so the
    state_dict stays as it is.

    Called on x [B, stride P, C_in] channels-last, it returns [B, P, C_out];
    a CPU tensor takes `F.conv1d` on the parameters as they are."""

    def __init__(self, conv: nn.Conv1d):
        self.conv = conv
        self._key = None
        self._operands = None

    def operands(self):
        conv = self.conv
        key = param_key([p for p in (conv.weight, conv.bias) if p is not None])
        if key != self._key:
            self._operands = None  # the old split goes before the new one is made
            with torch.no_grad():
                w = gemm_weight(conv.weight.float()).contiguous()
                bias = None if conv.bias is None else conv.bias.float().contiguous()
                self._operands = ((split_tf32(w), conv.weight.shape[2]), bias)
            self._key = key
        return self._operands

    def __call__(self, x, stride, gelu=False):
        if x.device.type == "cpu":
            return _plain(x, self.conv.weight, self.conv.bias, stride, gelu)
        w, bias = self.operands()
        return conv_tf32x3(x, w, bias, stride, gelu)
