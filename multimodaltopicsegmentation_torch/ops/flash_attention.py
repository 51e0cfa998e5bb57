"""Banded flash attention: forward (kernel K2), backward (kernels K4, K5 and
K3), the four differentiable entries over them, and the fused forward-only
local attention (kernel K6): counterpart of the JAX package's
ops/pallas_attention.py.

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

The backward (`_flash_bwd`, counterpart of `_flash_bwd_impl`) recomputes the
weights from q, k and the saved logsumexp, tile by tile, so nothing
score-shaped reaches device memory: K4 (`_flash_dq`) gives dq, K5
(`_flash_dq_dbias`) dq and the bias tile's gradient, K3 (`_flash_dkv`) dk and
dv; `csrc/flash_local_attention_bwd.cu` holds them. As in the TPU kernels a
query row at or past its length gets ZERO gradient, whatever its cotangent
(autograd through the blocked path would send the padded rows' weights
back); the plain versions below are explicit blocked formulas that do the
same. D = rowsum(dO * O) is plain torch outside the kernels, as in JAX.

`flash_local_attention`, `flash_local_attention_biased`,
`flash_local_attention_dropped` and `flash_local_attention_biased_dropped`
are differentiable in q, k, v (and the bias tile). The dropped entries draw
the post-softmax 0/1 tile with `_drop_mask` from the caller's generator and
keep only that generator's state before the draw: the backward draws the
tile again from a fresh generator in that state, so the banded-size tile is
never saved. A parity test injects a tile by replacing `_drop_mask`.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..core import cuda_build
from .attention import _blocked_attention

KERNEL = "flash_local_attention"
BWD_KERNEL = "flash_local_attention_bwd"
BWD_TILE = 64  # query rows per thread block of the dq kernels (kBQ in the source)
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


# ---------------------------------------------------------------------------
# Backward: plain versions of K4, K5 and K3, the kernels' wrappers, _flash_bwd
# ---------------------------------------------------------------------------


def _bwd_slots(q, k, v, do, lse, dd, lengths, half, block, bias, scale, drop_mask, keep):
    """The recomputed tiles of the backward, blocked as the TPU kernels are:
    for each of the three key slots (previous, own, next block; edge blocks
    clamped) yields (columns, dS, dropped P, K block, Q blocks, dO blocks),
    the tiles [B, H, nb, block, block].

    P = exp(s - lse) where the key is valid (0 <= p < length), in band AND
    the query row is below its length, else 0; dP = dO V^T (times M / keep
    under a 0/1 tile); dS = P * (dP - D)."""
    B, H, L, Dh = q.shape
    nb = -(-L // block)
    pad = nb * block - L
    dev = q.device
    blocks = lambda x: F.pad(x, (0, 0, 0, pad)).reshape(B, H, nb, block, Dh)  # noqa: E731
    rows = lambda x: F.pad(x, (0, pad)).reshape(B, H, nb, block, 1)  # noqa: E731
    qb, kb, vb, dob = blocks(q), blocks(k), blocks(v), blocks(do)
    lse_b, dd_b = rows(lse), rows(dd)
    j = torch.arange(nb, device=dev)
    neigh = [(j - 1).clamp_min(0), j, (j + 1).clamp_max(nb - 1)]
    qpos = torch.arange(nb * block, device=dev).reshape(nb, block, 1)
    cols = torch.arange(block, device=dev)[None, None, :]
    length = lengths.to(dev).reshape(B, 1, 1, 1, 1)
    sc = 1.0 / math.sqrt(Dh) if scale else 1.0
    tile = None if drop_mask is None else drop_mask.reshape(B, H, nb, block, 3 * block)
    for s in range(3):
        sl = slice(s * block, (s + 1) * block)
        k_s, v_s = kb[:, :, neigh[s]], vb[:, :, neigh[s]]
        kpos = (j * block)[:, None, None] + (s - 1) * block + cols  # [nb, 1, block]
        ok = ((kpos - qpos).abs() <= half) & (kpos >= 0)
        ok = ok[None, None] & (kpos[None, None] < length) & (qpos[None, None] < length)
        scores = sc * torch.einsum("bhnqd,bhnkd->bhnqk", qb, k_s)
        if bias is not None:
            scores = scores + bias[None, :, None, :, sl]
        p = torch.where(ok, torch.exp(scores - lse_b), 0.0)
        dp = torch.einsum("bhnqd,bhnkd->bhnqk", dob, v_s)
        pd = p
        if tile is not None:
            m = tile[..., sl]
            dp = (dp * m) / keep
            pd = (p * m) / keep
        yield sl, p * (dp - dd_b), pd, k_s, qb, dob


def flash_dq_reference(q, k, v, mask, lse, do, dd, window: int, bias=None, scale: bool = True,
                       drop_mask=None, keep: float = 1.0):
    """Plain PyTorch version of K4 and K5 -> (dq [B, H, L, Dh], dbias
    [H, block, 3*block] or None): dq = scale * sum over the three slots of
    dS K; dbias = dS summed over batch and query blocks."""
    B, H, L, Dh = q.shape
    half = window // 2
    block = _flash_geometry(L, half)[0]
    sc = 1.0 / math.sqrt(Dh) if scale else 1.0
    dq = 0.0
    dbias = None if bias is None else torch.zeros_like(bias)
    for sl, ds, _, k_s, _, _ in _bwd_slots(q, k, v, do, lse, dd, _lengths(mask), half, block,
                                           bias, scale, drop_mask, keep):
        dq = dq + torch.einsum("bhnqk,bhnkd->bhnqd", ds, k_s)
        if dbias is not None:
            dbias[:, :, sl] = ds.sum(dim=(0, 2))
    return (sc * dq).reshape(B, H, -1, Dh)[:, :, :L], dbias


def flash_dkv_reference(q, k, v, mask, lse, do, dd, window: int, bias=None, scale: bool = True,
                        drop_mask=None, keep: float = 1.0):
    """Plain PyTorch version of K3 -> (dk, dv) [B, H, L, Dh]: for a key
    block, over its three neighbouring query blocks, dv += (P M / keep)^T dO
    and dk += scale * dS^T Q. Slot s of query block j is key block j - 1 + s;
    a clamped edge slot holds only masked columns and adds nothing."""
    B, H, L, Dh = q.shape
    half = window // 2
    block = _flash_geometry(L, half)[0]
    nb = -(-L // block)
    sc = 1.0 / math.sqrt(Dh) if scale else 1.0
    dk = torch.zeros(B, H, nb, block, Dh, dtype=q.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    for s, (_, ds, pd, _, qb, dob) in enumerate(
            _bwd_slots(q, k, v, do, lse, dd, _lengths(mask), half, block, bias, scale,
                       drop_mask, keep)):
        dk_c = torch.einsum("bhnqk,bhnqd->bhnkd", ds, qb)
        dv_c = torch.einsum("bhnqk,bhnqd->bhnkd", pd, dob)
        src = slice(max(1 - s, 0), nb - max(s - 1, 0))  # query blocks whose slot s exists
        dst = slice(src.start + s - 1, src.stop + s - 1)
        dk[:, :, dst] += dk_c[:, :, src]
        dv[:, :, dst] += dv_c[:, :, src]
    unflat = lambda x: x.reshape(B, H, nb * block, Dh)[:, :, :L]  # noqa: E731
    return sc * unflat(dk), unflat(dv)


def _bwd_library():
    lib = cuda_build.load(BWD_KERNEL)
    dq = lib.mts_flash_local_dq_f32
    dq.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    dqb = lib.mts_flash_local_dq_dbias_f32
    dqb.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p])
    dkv = lib.mts_flash_local_dkv_f32
    dkv.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p])
    for fn in (dq, dqb, dkv):
        fn.restype = ctypes.c_int
    return dq, dqb, dkv


def _bwd_args(q, k, v, mask, lse, do, dd, window, bias, drop_mask, keep):
    """Checks shared by the three backward wrappers -> (half, block, nb)."""
    _check_qkv(q, k, v, mask, window)
    B, H, L, Dh = q.shape
    half = window // 2
    block, nb, _ = _flash_geometry(L, half)
    if do.shape != q.shape or lse.shape != (B, H, L) or dd.shape != (B, H, L):
        raise ValueError(f"dO must be {tuple(q.shape)} and lse, D {(B, H, L)}, got "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}, {tuple(dd.shape)}")
    if bias is not None and bias.shape != (H, block, 3 * block):
        raise ValueError(f"bias must be {(H, block, 3 * block)}, got {tuple(bias.shape)}")
    if drop_mask is not None and drop_mask.shape != (B * H, nb * block, 3 * block):
        raise ValueError(f"drop_mask must be {(B * H, nb * block, 3 * block)}, "
                         f"got {tuple(drop_mask.shape)}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash local attention runs on cpu or cuda, not {q.device}")
    if q.device.type == "cuda":
        _check_head_dim(Dh)
        named = [("q", q), ("k", k), ("v", v), ("dO", do), ("lse", lse), ("D", dd)]
        named += [("bias", bias)] if bias is not None else []
        named += [("drop_mask", drop_mask)] if drop_mask is not None else []
        _check_cuda(named, q.device)
    return half, block, nb


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_dq(q, k, v, mask, lse, do, dd, window: int, scale: bool = True, drop_mask=None,
              keep: float = 1.0):
    """K4 -> dq [B, H, L, Dh]. lse, dd: [B, H, L] (the forward's logsumexp,
    rowsum(dO * O)). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    half, block, _ = _bwd_args(q, k, v, mask, lse, do, dd, window, None, drop_mask, keep)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, mask, lse, do, dd, window, None, scale, drop_mask,
                                  keep)[0]
    B, H, L, Dh = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    lengths = _lengths(mask.to(q.device)).contiguous()
    fn = _bwd_library()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dd.data_ptr(), lengths.data_ptr(), _ptr(drop_mask), dq.data_ptr(),
                B, H, L, Dh, half, block, 1.0 / math.sqrt(Dh) if scale else 1.0, keep, stream)
    if rc != 0:
        raise RuntimeError(f"flash_local_attention dq kernel launch failed: cudaError {rc}")
    _flash_dq.launches += 1
    return dq


_flash_dq.launches = 0


def _flash_dq_dbias(q, k, v, mask, lse, do, dd, window: int, bias, scale: bool = False,
                    drop_mask=None, keep: float = 1.0):
    """K5 -> (dq [B, H, L, Dh], dbias [H, block, 3*block]). Each thread
    block of the dq kernel (one per batch row, head and 64-row query tile)
    stores the dS of its valid pairs once into a slab of its own in a scratch
    [B, H, tiles, 64, 2*half + 1] (column = key - query + half), and a
    second kernel sums, for each (head, row, offset), the batch rows and
    query positions in a fixed order: the result does not depend on
    scheduling. The reduce reads only entries that were stored, so the
    scratch is not zeroed."""
    half, block, _ = _bwd_args(q, k, v, mask, lse, do, dd, window, bias, drop_mask, keep)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, mask, lse, do, dd, window, bias, scale, drop_mask, keep)
    B, H, L, Dh = q.shape
    dq = torch.empty_like(q)
    dbias = torch.empty_like(bias)
    if dq.numel() == 0:
        return dq, dbias.zero_()
    lengths = _lengths(mask.to(q.device)).contiguous()
    tiles = -(-L // BWD_TILE)
    partial = torch.empty(B, H, tiles, BWD_TILE, 2 * half + 1, dtype=torch.float32,
                          device=q.device)
    fn = _bwd_library()[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dd.data_ptr(), lengths.data_ptr(), bias.data_ptr(), _ptr(drop_mask),
                dq.data_ptr(), partial.data_ptr(), dbias.data_ptr(),
                B, H, L, Dh, half, block, 1.0 / math.sqrt(Dh) if scale else 1.0, keep, stream)
    if rc != 0:
        raise RuntimeError(f"flash_local_attention dq+dbias kernel launch failed: cudaError {rc}")
    _flash_dq_dbias.launches += 1
    _flash_dq_dbias.scratch_bytes = partial.nbytes
    _flash_dq_dbias.scratch_ptr = partial.data_ptr()
    return dq, dbias


_flash_dq_dbias.launches = 0
_flash_dq_dbias.scratch_bytes = 0  # size and address of the last launch's scratch
_flash_dq_dbias.scratch_ptr = None


def _flash_dkv(q, k, v, mask, lse, do, dd, window: int, bias=None, scale: bool = True,
               drop_mask=None, keep: float = 1.0):
    """K3 -> (dk, dv) [B, H, L, Dh]; optional bias and 0/1 tiles as in K2."""
    half, block, _ = _bwd_args(q, k, v, mask, lse, do, dd, window, bias, drop_mask, keep)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, mask, lse, do, dd, window, bias, scale, drop_mask,
                                   keep)
    B, H, L, Dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lengths = _lengths(mask.to(q.device)).contiguous()
    fn = _bwd_library()[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dd.data_ptr(), lengths.data_ptr(), _ptr(bias), _ptr(drop_mask),
                dk.data_ptr(), dv.data_ptr(), B, H, L, Dh, half, block,
                1.0 / math.sqrt(Dh) if scale else 1.0, keep, stream)
    if rc != 0:
        raise RuntimeError(f"flash_local_attention dk/dv kernel launch failed: cudaError {rc}")
    _flash_dkv.launches += 1
    return dk, dv


_flash_dkv.launches = 0


def _flash_bwd(q, k, v, mask, out, lse, do, window: int, bias=None, scale: bool = True,
               drop_mask=None, keep: float = 1.0):
    """-> (dq, dk, dv, dbias or None) from the forward's inputs, its O and
    lse and the cotangent dO: K4 (or K5 with a bias tile) and K3."""
    dd = (do * out).sum(dim=-1)  # D_i = rowsum(dO * O); under a 0/1 tile O is the dropped sum
    if bias is None:
        dq, dbias = _flash_dq(q, k, v, mask, lse, do, dd, window, scale, drop_mask, keep), None
    else:
        dq, dbias = _flash_dq_dbias(q, k, v, mask, lse, do, dd, window, bias, scale, drop_mask,
                                    keep)
    dk, dv = _flash_dkv(q, k, v, mask, lse, do, dd, window, bias, scale, drop_mask, keep)
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# The four differentiable entries
# ---------------------------------------------------------------------------


def _drop_mask(generator: torch.Generator, rate: float, B, H, nb, block, device):
    """0/1 float32 attention-probs dropout tile [B*H, nb*block, 3*block] at
    the flash geometry: keep with probability 1 - rate. Drawn as
    `ops.attention._drop_probs` draws over [B, H, nb, block, 3*block], so that
    where the blocked path's geometry coincides (window/2 a multiple of 8)
    one generator state gives both paths the same tile."""
    u = torch.rand(B, H, nb, block, 3 * block, generator=generator, device=device)
    return (u < 1.0 - rate).to(torch.float32).reshape(B * H, nb * block, 3 * block)


class _FlashLocalAttention(torch.autograd.Function):
    """One function behind the four entries: bias and generator are optional.
    Saved for the backward: q, k, v, mask, bias, O, lse and, when dropping,
    the generator's state before the draw (a few bytes), never the tile."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, generator, window, rate, scale):
        B, H, L, _ = q.shape
        block, nb, _ = _flash_geometry(L, window // 2)
        ctx.geometry = (B, H, nb, block)
        ctx.window, ctx.rate, ctx.scale = window, rate, scale
        ctx.state = ctx.gen_device = None
        tile = None
        if generator is not None and rate > 0.0:
            ctx.state, ctx.gen_device = generator.get_state(), generator.device
            tile = _drop_mask(generator, rate, *ctx.geometry, q.device)
        keep = 1.0 if tile is None else 1.0 - rate
        out, lse = _flash_fwd(q, k, v, mask, window, bias, scale, tile, keep)
        ctx.save_for_backward(q, k, v, mask, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, bias, out, lse = ctx.saved_tensors
        tile, keep = None, 1.0
        if ctx.state is not None:
            again = torch.Generator(device=ctx.gen_device)
            again.set_state(ctx.state)
            tile, keep = _drop_mask(again, ctx.rate, *ctx.geometry, q.device), 1.0 - ctx.rate
        dq, dk, dv, dbias = _flash_bwd(q, k, v, mask, out, lse, do.contiguous(), ctx.window, bias,
                                       ctx.scale, tile, keep)
        return dq, dk, dv, None, dbias, None, None, None, None


def flash_local_attention(q, k, v, mask, window: int):
    """Scaled, unbiased banded attention (the Longformer-family call).
    q, k, v: [B, H, L, Dh]; mask: [B, L] prefix mask; window even.
    Differentiable in q, k, v."""
    return _FlashLocalAttention.apply(q, k, v, mask, None, None, window, 0.0, True)


def flash_local_attention_biased(q, k, v, mask, bias, window: int, scale: bool = False):
    """Banded attention with a translation-invariant additive bias tile
    [H, block, 3*block] (the T5-family call, unscaled by default).
    Differentiable in q, k, v and the tile, whose gradient flows on into the
    bucket table outside."""
    return _FlashLocalAttention.apply(q, k, v, mask, bias, None, window, 0.0, scale)


def flash_local_attention_dropped(q, k, v, mask, generator, window: int, rate: float):
    """`flash_local_attention` + attention-probs dropout at `rate` on the
    softmaxed weights, drawn from `generator` (on q's device). Training only."""
    return _FlashLocalAttention.apply(q, k, v, mask, None, generator, window, rate, True)


def flash_local_attention_biased_dropped(q, k, v, mask, bias, generator, window: int,
                                         rate: float, scale: bool = False):
    """`flash_local_attention_biased` + attention-probs dropout at `rate`."""
    return _FlashLocalAttention.apply(q, k, v, mask, bias, generator, window, rate, scale)


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
