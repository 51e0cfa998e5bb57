"""The yardstick's arithmetic: peaks of the card, the operations and bytes of
the kernels K1 (instance norm + GELU), K2 (banded flash forward), K4 and K3
(its backward), and the model FLOPs of the paths the cells run.

Frozen copies of the formulas the repository's chip smoke test uses
(`banded_work`, `banded_bytes`, `banded_pairs`, the K1, K4 and K3 byte
counts), kept here so that no later change of the program moves the
yardstick.

Floors. A kernel's floor is the larger of its operations at the
float32-accurate tensor-core rate (three TF32 passes a product: 495 / 3 =
165 TFLOP/s, the route the flash kernels take) and its bytes at the HBM
rate. Model FLOPs count the forward work over valid units, and in training
the backward's twice that (attention: the 8 * Dh a (query, key) pair of dq,
dk and dv); recomputed work is not counted.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

# NVIDIA H100 SXM data sheet (dense rates), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
F32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3  # 3xTF32: three TF32 products per float32 one


def floor_s(ops: float, nbytes: float) -> float:
    return max(ops / F32_ACCURATE_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


# -- K1 ---------------------------------------------------------------------------

def k1_bytes(B: int, C: int, T: int) -> int:
    """x read, out written, scale and bias, lengths (chip_smoke.py's count)."""
    return 2 * B * C * T * 4 + 2 * C * 4 + B * 4


# -- banded attention: K2, K4, K3 -------------------------------------------------

def flash_block(L: int, half: int) -> int:
    """Query-block size of the flash tile layout: half rounded up to 8, at least 8."""
    return max(-(-half // 8) * 8, 8)


def banded_work(lengths, L, half, block, H, Dh):
    """Float32 operations the banded attention needs for THESE lengths: 4*Dh
    per (query, valid key in band) pair, queries in the padding included, and
    one sum of V over 3*block rows for each block that holds a query with no
    valid key."""
    i = np.arange(L)
    ops = 0
    for n in lengths:
        keys = np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1
        pairs = int(np.clip(keys, 0, None).sum())
        first_uniform = 0 if n == 0 else n + half
        blocks = 0 if first_uniform >= L else -(-L // block) - first_uniform // block
        ops += H * (4 * Dh * pairs + blocks * 3 * block * Dh)
    return ops


def banded_bytes(lengths, L, half, block, H, Dh, lse, bias_numel, dropped):
    """Bytes the banded attention forward must move for THESE lengths: q of
    the rows that see a key (below length + half), k and v of the rows below
    the length, O (and lse) written on every row, the lengths and the bias
    tile once, one 0/1 entry per (query, valid key) pair and 3*block for each
    row that sees no key, and the rows of V at or past the length that the
    three clamped blocks of such rows cover, each once."""
    i = np.arange(L)
    total = len(lengths) * 4 + bias_numel * 4
    for n in lengths:
        seen = 0 if n == 0 else min(n + half, L)  # rows that see a key
        keys = np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1
        pairs = int(np.clip(keys, 0, None).sum())
        first_v = L if seen >= L else max(seen // block - 1, 0) * block
        total += H * 4 * (seen * Dh + 2 * n * Dh + L * Dh + (L if lse else 0)
                          + max(0, L - max(n, first_v)) * Dh)
        if dropped:
            total += H * 4 * (pairs + (L - seen) * 3 * block)
    return total


def banded_pairs(lengths, L, half):
    """(query, key) pairs that carry a gradient for THESE lengths: both below
    the length and within `half` of each other."""
    total = 0
    for n in lengths:
        i = np.arange(min(n, L))
        total += int((np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1).sum())
    return total


def k2_work(lengths, L, half, H, Dh):
    """(operations, bytes) of one K2 launch (it writes the logsumexp)."""
    block = flash_block(L, half)
    return (banded_work(lengths, L, half, block, H, Dh),
            banded_bytes(lengths, L, half, block, H, Dh, True, 0, False))


def _bwd_reads(lengths, L, half, H, Dh):
    valid = H * sum(min(n, L) for n in lengths)
    return (4 * Dh + 2) * valid * 4 + len(lengths) * 4, H * banded_pairs(lengths, L, half)


def k4_work(lengths, L, half, H, Dh):
    """(operations, bytes) of one K4 launch (dq): q, k, v, dO, lse and D of the
    rows below the length and the lengths read, dq written on every row; 6 *
    Dh a (query, key) pair."""
    reads, pairs = _bwd_reads(lengths, L, half, H, Dh)
    return 6 * Dh * pairs, reads + len(lengths) * H * L * Dh * 4


def k3_work(lengths, L, half, H, Dh):
    """(operations, bytes) of one K3 launch (dk and dv): the same reads, dk and
    dv written on every row; 8 * Dh a pair."""
    reads, pairs = _bwd_reads(lengths, L, half, H, Dh)
    return 8 * Dh * pairs, reads + 2 * len(lengths) * H * L * Dh * 4


# -- model FLOPs ------------------------------------------------------------------

def wav2vec2_unit_flops(cfg: dict, samples: int) -> float:
    """Forward FLOPs of one unit of `samples` samples through wav2vec2: the
    convolution stack, the feature projection, the positional convolution and
    the transformer layers (projections, FFN, attention over the unit's frames)."""
    flops, c_in, t = 0, 1, samples
    for c, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
        flops += 2 * c * c_in * k * t
        c_in = c
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    flops += 2 * c_in * D * t
    flops += 2 * D * (D // cfg["num_conv_pos_embedding_groups"]) * cfg["num_conv_pos_embeddings"] * t
    per_layer = 4 * 2 * D * D * t + 2 * 2 * D * F * t + 2 * 2 * t * t * D
    return float(flops + cfg["num_hidden_layers"] * per_layer)


def lstm_flops(units: int, in_dim: int, hidden: int, layers: int, bidirectional: bool = True,
               head: int = 1) -> float:
    """Forward FLOPs of the recurrent stack and its linear head over `units`."""
    dirs = 2 if bidirectional else 1
    flops, d = 0, in_dim
    for _ in range(layers):
        flops += dirs * 2 * 4 * hidden * (d + hidden) * units
        d = dirs * hidden
    return float(flops + 2 * d * head * units)


def transformer_flops(lengths: Sequence[int], d_model: int, d_ff: int, heads: int,
                      windows: Sequence[int], head: int = 1) -> float:
    """Forward FLOPs of the windowed post-LN encoder and its head over the valid
    units of `lengths`: per layer the four projections, the FFN and 4 * Dh a
    (query, key) pair of the band."""
    units = sum(lengths)
    Dh = d_model // heads
    flops = 0.0
    for w in windows:
        flops += (4 * 2 * d_model * d_model + 2 * 2 * d_model * d_ff) * units
        flops += 4 * Dh * heads * banded_pairs(lengths, max(lengths), w // 2)
    return flops + 2 * d_model * head * units


def transformer_train_flops(lengths, d_model, d_ff, heads, windows, head=1) -> float:
    """Forward and backward: three times the forward's dense work; 4 + 8 * Dh a pair."""
    units = sum(lengths)
    Dh = d_model // heads
    flops = 0.0
    for w in windows:
        flops += 3 * (4 * 2 * d_model * d_model + 2 * 2 * d_model * d_ff) * units
        flops += 12 * Dh * heads * banded_pairs(lengths, max(lengths), w // 2)
    return flops + 3 * 2 * d_model * head * units
