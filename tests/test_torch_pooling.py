"""Port pooling (ops/pooling.py) and masks (ops/masks.py) against the JAX package."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.ops import masks as JM
from multimodaltopicsegmentation_tpu.ops.pooling import POOLING_VARIANTS, pool as jax_pool
from multimodaltopicsegmentation_torch.ops import masks as TM
from multimodaltopicsegmentation_torch.ops.pooling import pool


@pytest.mark.parametrize("variant", POOLING_VARIANTS)
def test_pool_matches_jax_with_empty_unit(variant):
    """Four units, the second one empty (its rows are zero in every variant
    but _delta_gap, whose rule reads the neighbours)."""
    rng = np.random.default_rng(0)
    counts = [4, 0, 7, 3]
    frames = rng.standard_normal((sum(counts), 6)).astype(np.float32)
    seg = np.repeat(np.arange(len(counts)), counts)
    want = np.asarray(jax_pool(jnp.asarray(frames), jnp.asarray(seg), len(counts), variant))
    got = pool(torch.from_numpy(frames), torch.from_numpy(seg), len(counts), variant).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pool_rejects_unknown_variant():
    with pytest.raises(ValueError):
        pool(torch.zeros(2, 3), torch.tensor([0, 1]), 2, "_median")


def test_masks_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 2)).astype(np.float32)
    lengths = np.array([6, 2, 0], np.int32)
    np.testing.assert_array_equal(
        TM.length_mask(torch.from_numpy(lengths), 6).numpy(),
        np.asarray(JM.length_mask(jnp.asarray(lengths), 6)))
    np.testing.assert_array_equal(
        TM.reverse_in_length(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        np.asarray(JM.reverse_in_length(jnp.asarray(x), jnp.asarray(lengths))))
