"""Attention ops: dense MHA and sliding-window (local) attention
(counterpart of the JAX package's ops/attention.py).

`dense_attention` stays plain torch with an additive NEG_INF mask, as in JAX.
A boolean-masked scaled_dot_product_attention would give NaN for the
zero-length padded rows that `bucket_rows` adds (all keys masked), where the
additive mask gives them uniform weights; the port matches JAX row for row.

`local_attention` is the banded attention |i - j| <= window/2 of the
long-document taggers. Three routes, picked as in JAX:

- the blocked plain-torch path (queries in blocks of window/2, each block
  against its previous, own and next key block): CPU tensors, and
  `use_pallas=False`;
- the flash kernel (`ops/flash_attention.py`, K2): `"flash"`, and `"auto"` on
  a CUDA tensor, unbiased-and-scaled or biased;
- the older fused forward-only kernel (K6): `use_pallas=True`.

Attention-probs dropout (`probs_drop`, `generator`; HF semantics, on the
softmaxed weights) is active only with a generator and a rate above 0: the
flash route then takes the dropped entries, the blocked path draws its own
tile. Also here: T5 relative-position bucketing for the LongT5-style encoder.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def flash_attention_active(where) -> bool:
    """Whether `local_attention`'s "auto" dispatch takes the flash kernels for
    the library's calls on `where` (a tensor or a device): true on CUDA."""
    device = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    return device.type == "cuda"


def _drop_active(probs_drop: float, generator) -> bool:
    return generator is not None and probs_drop > 0.0


def _drop_probs(w, rate: float, generator):
    """Attention-probs dropout, HF semantics: zero softmaxed weights and
    rescale the survivors by 1/keep. Inactive without a generator (eval) or
    at rate 0. The generator lives on w's device."""
    if not _drop_active(rate, generator):
        return w
    keep = 1.0 - rate
    m = torch.rand(w.shape, generator=generator, device=w.device) < keep
    return torch.where(m, w / keep, 0.0)


def dense_attention(q, k, v, mask=None, probs_drop: float = 0.0, generator=None, bias=None):
    """q, k, v: [B, H, L, Dh]; mask: [B, L] float (1 = valid key);
    probs_drop/generator: train-time attention-probs dropout; bias: an
    additive score bias broadcast to [B, H, L, L] (WavLM's gated relative
    position bias), added before the mask."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = scores + (1.0 - mask[:, None, None, :]) * NEG_INF
    w = _drop_probs(torch.softmax(scores, dim=-1), probs_drop, generator)
    return torch.matmul(w, v)


def _band_mask(block: int, half: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[block, 3*block] additive mask allowing |global offset| <= half."""
    qpos = torch.arange(block, device=device)[:, None]
    kpos = torch.arange(3 * block, device=device)[None, :] - block
    ok = (kpos - qpos).abs() <= half
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def band_offsets(block: int) -> torch.Tensor:
    """[block, 3*block] int64 on the CPU: key offset of column c from query
    row r in the 3-block neighbourhood, c - block - r."""
    return torch.arange(3 * block)[None, :] - block - torch.arange(block)[:, None]


def _blocked_attention(q, k, v, half: int, block: int, mask=None, lengths=None, bias=None,
                       scale: bool = True, drop_mask=None, keep: float = 1.0):
    """Banded attention over the 3-block neighbourhood -> (out [B, H, L, Dh],
    lse [B, H, L]). `block >= max(half, 1)`; bias: [H, block, 3*block].

    Two sets of edge rules, which agree on every query row that sees a valid
    key and differ on the all-masked (padding) rows:

    - `mask` ([B, L] float, any pattern): the JAX blocked path. Neighbour
      blocks past either end are zeros, and band, bias and key mask are
      ADDED to the scores.
    - `lengths` ([B] int, prefix masks): what the TPU flash kernels compute.
      Neighbour blocks past either end are the CLAMPED edge blocks, a key is
      valid iff its assumed position p satisfies 0 <= p < length, masked
      scores are SET to NEG_INF and the bias is added after that. An
      all-masked row so averages V over its three (clamped) blocks.
      drop_mask: [B*H, nb*block, 3*block] 0/1 tile applied to the softmaxed
      weights, scaled by 1/keep; lse stays undropped.
    """
    B, H, L, Dh = q.shape
    nb = -(-L // block)
    pad = nb * block - L
    qb = F.pad(q, (0, 0, 0, pad)).reshape(B, H, nb, block, Dh)
    kp, vp = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    dev = q.device
    if lengths is not None:
        j = torch.arange(nb, device=dev)
        neigh = [(j - 1).clamp_min(0), j, (j + 1).clamp_max(nb - 1)]
        kp, vp = kp.reshape(B, H, nb, block, Dh), vp.reshape(B, H, nb, block, Dh)
        shifted = lambda x, s: x[:, :, neigh[s]]  # noqa: E731
        qpos = torch.arange(nb * block, device=dev).reshape(nb, block, 1)
        base = (j * block)[:, None, None]
        cols = torch.arange(block, device=dev)[None, None, :]
        length = lengths.to(dev).reshape(B, 1, 1, 1, 1)
    else:
        kp, vp = F.pad(kp, (0, 0, block, block)), F.pad(vp, (0, 0, block, block))
        shifted = lambda x, s: x[:, :, s * block : s * block + nb * block].reshape(  # noqa: E731
            B, H, nb, block, Dh)
        if mask is None:
            mask = torch.ones(B, L, dtype=q.dtype, device=dev)
        mp_k = F.pad(mask, (block, block + pad))
        band = _band_mask(block, half, q.dtype, dev)

    parts = []
    for s in range(3):
        part = torch.einsum("bhnqd,bhnkd->bhnqk", qb, shifted(kp, s))
        if scale:
            part = part / math.sqrt(Dh)
        sl = slice(s * block, (s + 1) * block)
        if lengths is not None:
            kpos = base + (s - 1) * block + cols  # [nb, 1, block]
            ok = ((kpos - qpos).abs() <= half) & (kpos >= 0)
            part = torch.where(ok[None, None] & (kpos[None, None] < length), part, NEG_INF)
            if bias is not None:
                part = part + bias[None, :, None, :, sl]
        else:
            part = part + band[:, sl]
            if bias is not None:
                part = part + bias[None, :, None, :, sl]
            key_mask = mp_k[:, s * block : s * block + nb * block].reshape(B, 1, nb, 1, block)
            part = part + (1.0 - key_mask) * NEG_INF
        parts.append(part)

    scores = torch.cat(parts, dim=-1)  # [B, H, nb, block, 3*block]
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    w = e / l
    if drop_mask is not None:
        w = (w * drop_mask.reshape(B, H, nb, block, 3 * block)) / keep
    out = sum(
        torch.einsum("bhnqk,bhnkd->bhnqd", w[..., s * block : (s + 1) * block],
                     shifted(vp, s))
        for s in range(3)
    )
    lse = (m + torch.log(l)).reshape(B, H, nb * block)
    return out.reshape(B, H, nb * block, Dh)[:, :, :L], lse[:, :, :L]


def local_attention(q, k, v, window: int, mask=None, bias_fn=None, use_pallas="auto",
                    scale: bool = True, probs_drop: float = 0.0, generator=None):
    """Sliding-window attention. q, k, v: [B, H, L, Dh]; window = total span
    (window/2 on each side, must be even); mask: [B, L] float, 1 = valid.

    bias_fn: optional fn(offsets [block, 3*block] int64, CPU) ->
    [H, block, 3*block] additive bias (the T5 relative-position buckets).
    scale: divide the scores by sqrt(Dh); T5-family attention does not.

    use_pallas keeps the JAX argument's name and values: "auto" takes the
    flash kernel for a CUDA tensor (scaled, or biased) and the blocked
    plain-torch path otherwise; "flash" forces the flash kernel's wrapper
    and False the blocked path; True forces the fused forward-only kernel,
    which takes neither a bias, an unscaled call nor dropout. The kernels
    need prefix masks: every caller's come from `length_mask`.

    probs_drop/generator: train-time attention-probs dropout; the flash
    route takes the dropped entries (the tile is drawn again in the backward,
    never kept), the blocked path a tile of its own geometry.
    """
    if window % 2 != 0:
        raise ValueError("attention window must be even")
    B, H, L, Dh = q.shape
    half = window // 2
    drop_active = _drop_active(probs_drop, generator)

    if use_pallas == "auto":
        flash_ok = bias_fn is not None or scale
        use_pallas = "flash" if flash_attention_active(q) and flash_ok else False
    if use_pallas == "flash":
        from . import flash_attention as FA

        if mask is None:
            mask = torch.ones(B, L, dtype=q.dtype, device=q.device)
        # split_heads hands out transposed views; the kernel takes [B, H, L, Dh] rows
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if bias_fn is None:
            if not scale:
                raise ValueError("unbiased flash local attention is always scaled")
            if drop_active:
                return FA.flash_local_attention_dropped(q, k, v, mask, generator, window,
                                                        probs_drop)
            return FA.flash_local_attention(q, k, v, mask, window)
        # the bias tile is built at the FLASH block geometry, which differs
        # from the blocked path's whenever window/2 is no multiple of 8
        fblock = FA._flash_geometry(L, half)[0]
        tile = bias_fn(band_offsets(fblock)).contiguous()
        if drop_active:
            return FA.flash_local_attention_biased_dropped(q, k, v, mask, tile, generator, window,
                                                           probs_drop, scale)
        return FA.flash_local_attention_biased(q, k, v, mask, tile, window, scale)
    if use_pallas is True:
        # the fused kernel takes no additive bias and always scales by
        # 1/sqrt(Dh); dropping either silently would change the logits
        if bias_fn is not None:
            raise ValueError("fused local attention does not support bias_fn")
        if not scale:
            raise ValueError("fused local attention always scales by 1/sqrt(Dh)")
        if drop_active:
            raise ValueError("fused local attention has no probs dropout")
        from . import flash_attention as FA

        return FA.fused_local_attention(q.contiguous(), k.contiguous(), v.contiguous(), window, mask)

    block = max(half, 1)
    bias = bias_fn(band_offsets(block)) if bias_fn is not None else None
    drop_mask, keep = None, 1.0
    if drop_active:
        keep = 1.0 - probs_drop
        nb = -(-L // block)
        # the draw of `_drop_probs` over the banded weights [B, H, nb, block, 3*block]
        drop_mask = (torch.rand(B, H, nb, block, 3 * block, generator=generator, device=q.device)
                     < keep).to(q.dtype)
    return _blocked_attention(q, k, v, half, block, mask=mask, bias=bias, scale=scale,
                              drop_mask=drop_mask, keep=keep)[0]


# ---------------------------------------------------------------------------
# T5 relative position buckets (for the LongT5-style local attention)
# ---------------------------------------------------------------------------


def t5_relative_bucket(relative_position: torch.Tensor, num_buckets: int, max_distance: int):
    """Bidirectional T5 bucketing, the JAX function's arithmetic step for
    step (float32 log, clamped inside the small branch only). Computed on the
    CPU whatever the input's device: a CUDA division by a scalar multiplies
    by the reciprocal, which can move a bucket at a boundary."""
    rp = relative_position.cpu().to(torch.int64)
    num_buckets //= 2
    ret = (rp > 0).to(torch.int64) * num_buckets
    rp = rp.abs()
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    val_if_large = max_exact + (
        torch.log(rp.clamp_min(max_exact).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32).to(torch.int64)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, rp, val_if_large)


def relative_bias_fn(bias_table: torch.Tensor, num_buckets: int, max_distance: int):
    """bias_table: [num_buckets, H] -> fn(rel [q, k] int64) -> [H, q, k].

    `local_attention` always passes the band offsets of one block size, so
    the bucket indices are computed once per (shape, device) and kept."""
    buckets = {}

    def fn(rel):
        key = (tuple(rel.shape), bias_table.device)
        if key not in buckets:
            buckets[key] = t5_relative_bucket(rel, num_buckets, max_distance).to(bias_table.device)
        return bias_table[buckets[key]].permute(2, 0, 1)

    return fn


def split_heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, nheads, D // nheads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)
