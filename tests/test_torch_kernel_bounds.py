"""The work counts behind the kernel floors of the benchmark
(benchmark/mtsbench/roofline.py), which `chip_smoke.py` imports, held to a
count made pair by pair and row by row at small sizes: the (query, key)
pairs of the band, the bytes the banded attention forward must move for
given lengths, and the 3xTF32 tensor-core floor; and `chip_smoke.bound`, the
float32 CUDA-core floor."""
import itertools
import os
import sys

import pytest

import chip_smoke as C
from multimodaltopicsegmentation_torch.ops import flash_attention as FA

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmark"))
from mtsbench import roofline as R  # noqa: E402


def _keys(i, n, half):
    """The valid keys of query i: within `half` and below the length n."""
    return [p for p in range(max(0, i - half), min(n, i + half + 1))]


def _forward_bytes(lengths, L, half, H, Dh, lse, bias_numel, dropped):
    block, nb, _ = FA._flash_geometry(L, half)
    total = 4 * len(lengths) + 4 * bias_numel
    for n in lengths:
        seen = [i for i in range(L) if _keys(i, n, half)]  # rows that see a key
        unseen = [i for i in range(L) if not _keys(i, n, half)]
        # the V rows at or past the length that the three clamped blocks of a
        # row without a key average (rows below the length are read as v)
        averaged = set()
        for i in unseen:
            j = i // block
            for b in range(max(j - 1, 0), min(j + 1, nb - 1) + 1):
                averaged.update(p for p in range(b * block, min((b + 1) * block, L)) if p >= n)
        rows = len(seen) + 2 * n + L + len(averaged)
        total += H * 4 * (rows * Dh + (L if lse else 0))
        if dropped:
            pairs = sum(len(_keys(i, n, half)) for i in range(L))
            total += H * 4 * (pairs + len(unseen) * 3 * block)
    return total


CASES = [(40, 8, (40, 0, 13)), (70, 16, (70, 30, 1)), (130, 120, (130, 64, 0)), (64, 0, (64, 20))]


@pytest.mark.parametrize("L,window,lengths", CASES)
@pytest.mark.parametrize("lse,biased,dropped", [(True, False, False), (False, False, False),
                                                (True, True, True)])
def test_forward_bytes_count_what_the_lengths_need(L, window, lengths, lse, biased, dropped):
    half = window // 2
    block, _, _ = FA._flash_geometry(L, half)
    H, Dh = 2, 12
    bias_numel = H * block * 3 * block if biased else 0
    want = _forward_bytes(lengths, L, half, H, Dh, lse, bias_numel, dropped)
    assert R.banded_bytes(lengths, L, half, block, H, Dh, lse, bias_numel, dropped) == want


@pytest.mark.parametrize("L,window,lengths", CASES)
def test_pairs_of_the_band(L, window, lengths):
    half = window // 2
    block, _, _ = FA._flash_geometry(L, half)
    grad_pairs = sum(1 for n in lengths for i, p in itertools.product(range(n), range(n))
                     if abs(i - p) <= half)
    assert R.banded_pairs(lengths, L, half) == grad_pairs
    # the forward's operations: 4*Dh per (query, valid key) pair, queries in
    # the padding included, and one sum of V over 3*block rows per geometry
    # block that holds a row without a key
    H, Dh = 2, 12
    pairs = sum(len(_keys(i, n, half)) for n in lengths for i in range(L))
    blocks = sum(len({i // block for i in range(L) if not _keys(i, n, half)}) for n in lengths)
    assert R.banded_work(lengths, L, half, block, H, Dh) == H * (4 * Dh * pairs
                                                                 + blocks * 3 * block * Dh)


def test_tensor_core_floor_is_the_larger_of_bytes_and_three_passes():
    s = R.floor_s(1e9, 3.35e9)  # 1 ms of bytes, 3 GFLOP of TF32 work: 6.06 us
    assert s == pytest.approx(1e-3)
    assert R.floor_s(165e9, 1.0) == pytest.approx(1e-3)  # 3 * 165 GFLOP at 495 TFLOP/s
    assert C.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
