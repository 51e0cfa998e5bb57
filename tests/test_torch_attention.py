"""Port attention ops (ops/attention.py, ops/flash_attention.py) against the
JAX package: the same numpy-seeded arrays go through both, TF32 off.

- `local_attention(use_pallas=False)` and `dense_attention` against their JAX
  counterparts on EVERY row, padded and zero-length ones included, 1e-5
  (summation order);
- the plain versions of kernels K2 and K6 against the Pallas kernels in
  interpret mode (as tests/test_attention.py runs them on the CPU), O and
  lse, every row, 1e-5;
- `t5_relative_bucket` equal to JAX's, bucket for bucket;
- the CUDA kernels against their plain versions on the card (marked `cuda`;
  skipped without one).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.ops import attention as JA
from multimodaltopicsegmentation_tpu.ops import pallas_attention as JP
from multimodaltopicsegmentation_torch.ops import attention as TA
from multimodaltopicsegmentation_torch.ops import flash_attention as FA

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GEOMETRIES = [(4, 16), (8, 37), (120, 200)]  # (window, L)
ATOL = 1e-5


def _inputs(window, L, seed=0, B=3, H=2, Dh=8, num_buckets=8):
    """q, k, v, a ragged prefix mask with a full and a zero-length row, and a
    T5-style bucket table, as numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32) for _ in range(3))
    lengths = np.array([L, max(L - 5, 1), 0][:B])
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    table = (rng.standard_normal((num_buckets, H)) * 0.1).astype(np.float32)
    return q, k, v, mask, table


def _both(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def _flash_tile(fn, L, window):
    block = JP._flash_geometry(L, window // 2)[0]
    rel = np.arange(3 * block)[None, :] - block - np.arange(block)[:, None]
    return np.asarray(fn(jnp.asarray(rel)))


@pytest.mark.parametrize("window,L", GEOMETRIES + [(6, 7)])
@pytest.mark.parametrize("biased,scale", [(False, True), (True, False), (True, True)])
def test_blocked_local_attention_matches_jax(window, L, biased, scale):
    q, k, v, mask, table = _inputs(window, L)
    (tq, tk, tv, tm, tt), (jq, jk, jv, jm, jt) = _both(q, k, v, mask, table)
    jfn = JA.relative_bias_fn(jt, 8, window + 1) if biased else None
    tfn = TA.relative_bias_fn(tt, 8, window + 1) if biased else None
    want = JA.local_attention(jq, jk, jv, window, jm, bias_fn=jfn, scale=scale, use_pallas=False)
    got = TA.local_attention(tq, tk, tv, window, tm, bias_fn=tfn, scale=scale, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_local_attention_without_mask_matches_jax():
    q, k, v, _, _ = _inputs(8, 37, seed=1)
    (tq, tk, tv), (jq, jk, jv) = _both(q, k, v)
    want = JA.local_attention(jq, jk, jv, 8, use_pallas=False)
    np.testing.assert_allclose(TA.local_attention(tq, tk, tv, 8).numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("masked", [True, False])
def test_dense_attention_matches_jax(masked):
    q, k, v, mask, _ = _inputs(8, 37, seed=2)
    (tq, tk, tv, tm), (jq, jk, jv, jm) = _both(q, k, v, mask)
    want = JA.dense_attention(jq, jk, jv, jm if masked else None)
    got = TA.dense_attention(tq, tk, tv, tm if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window,L", GEOMETRIES)
@pytest.mark.parametrize("variant", ["unbiased", "biased_unscaled", "biased_scaled", "dropped"])
def test_flash_reference_matches_pallas_kernel(window, L, variant):
    """K2's plain version against `_flash_fwd_impl(..., interpret=True)`: O and
    lse on every row. The 0/1 tile is the one `_drop_mask` draws, pulled to
    numpy and injected."""
    q, k, v, mask, table = _inputs(window, L, seed=3)
    (tq, tk, tv, tm), (jq, jk, jv, jm) = _both(q, k, v, mask)
    B, H = q.shape[:2]
    block, nb, _ = JP._flash_geometry(L, window // 2)
    assert FA._flash_geometry(L, window // 2) == (block, nb, nb * block - L)
    bias = drop = None
    kw, jkw = {}, {}
    if variant.startswith("biased"):
        bias = _flash_tile(JA.relative_bias_fn(jnp.asarray(table), 8, window + 1), L, window)
        scale = variant == "biased_scaled"
        kw = dict(bias=torch.from_numpy(bias.copy()), scale=scale)
        jkw = dict(bias=jnp.asarray(bias), scale=scale)
    if variant == "dropped":
        key = jax.random.PRNGKey(7)
        drop = np.asarray(JP._drop_mask(key, 0.25, B, H, nb, block))
        kw = dict(drop_mask=torch.from_numpy(drop.copy()), keep=0.75)
        jkw = dict(dropkey=key, rate=0.25)
    want_o, want_lse = JP._flash_fwd_impl(jq, jk, jv, jm, window, True, **jkw)
    got_o, got_lse = FA.flash_local_attention_reference(tq, tk, tv, tm, window, **kw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse).reshape(B, H, nb * block)[:, :, :L],
                               atol=ATOL, rtol=0)
    assert np.isfinite(got_o.numpy()).all()


@pytest.mark.parametrize("window,L", GEOMETRIES)
@pytest.mark.parametrize("masked", [True, False])
def test_fused_reference_matches_pallas_kernel(window, L, masked):
    """K6's plain version against `pallas_local_attention(..., interpret=True)`."""
    q, k, v, mask, _ = _inputs(window, L, seed=4)
    (tq, tk, tv, tm), (jq, jk, jv, jm) = _both(q, k, v, mask)
    want = JP.pallas_local_attention(jq, jk, jv, window, jm if masked else None, interpret=True)
    got = FA.fused_local_attention_reference(tq, tk, tv, window, tm if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("num_buckets", [4, 32, 120, 127])
def test_t5_relative_bucket_equals_jax(num_buckets):
    """Every offset in [-4096, 4096], at the LongT5 encoder's settings
    (num_buckets = max(4, radius), max_distance = radius + 1)."""
    rel = np.arange(-4096, 4097)
    want = np.asarray(JA.t5_relative_bucket(jnp.asarray(rel), num_buckets, num_buckets + 1))
    got = TA.t5_relative_bucket(torch.from_numpy(rel), num_buckets, num_buckets + 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_relative_bias_fn_matches_jax():
    table = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    rel = TA.band_offsets(8)
    want = JA.relative_bias_fn(jnp.asarray(table), 32, 16)(jnp.asarray(rel.numpy()))
    fn = TA.relative_bias_fn(torch.from_numpy(table), 32, 16)
    assert fn(rel).shape == (4, 8, 24)
    np.testing.assert_array_equal(fn(rel).numpy(), np.asarray(want))
    np.testing.assert_array_equal(fn(rel).numpy(), np.asarray(want))  # from the kept buckets


def test_heads_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 12)).astype(np.float32))
    h = TA.split_heads(x, 3)
    assert h.shape == (2, 3, 9, 4)
    assert torch.equal(TA.merge_heads(h), x)


@pytest.mark.parametrize("route", ["auto", "flash", True])
def test_wrappers_on_cpu_take_plain_versions(route):
    """On CPU tensors every route computes through a plain version, agrees with
    the blocked path on valid rows, and counts no kernel launch."""
    window, L = 8, 37
    q, k, v, mask, _ = _inputs(window, L, seed=5)
    (tq, tk, tv, tm), _ = _both(q, k, v, mask)
    before = FA._flash_fwd.launches, FA.fused_local_attention.launches
    got = TA.local_attention(tq, tk, tv, window, tm, use_pallas=route)
    want = TA.local_attention(tq, tk, tv, window, tm, use_pallas=False)
    for b, n in enumerate(mask.sum(1).astype(int)):
        np.testing.assert_allclose(got[b, :, :n].numpy(), want[b, :, :n].numpy(), atol=ATOL)
    assert (FA._flash_fwd.launches, FA.fused_local_attention.launches) == before
    if route == "auto":
        assert torch.equal(got, want)  # auto on the CPU is the blocked path itself


def test_flash_route_builds_the_bias_tile_at_the_flash_geometry():
    """window 120 -> half 60: the blocked path's tile has block 60, the flash
    path's 64; both give the same attention on valid rows."""
    window, L = 120, 200
    q, k, v, mask, table = _inputs(window, L, seed=6)
    (tq, tk, tv, tm, tt), _ = _both(q, k, v, mask, table)
    seen = []
    inner = TA.relative_bias_fn(tt, 8, window + 1)

    def fn(rel):
        seen.append(tuple(rel.shape))
        return inner(rel)

    flash = TA.local_attention(tq, tk, tv, window, tm, bias_fn=fn, scale=False, use_pallas="flash")
    blocked = TA.local_attention(tq, tk, tv, window, tm, bias_fn=fn, scale=False, use_pallas=False)
    assert seen == [(64, 192), (60, 180)]
    for b, n in enumerate(mask.sum(1).astype(int)):
        np.testing.assert_allclose(flash[b, :, :n].numpy(), blocked[b, :, :n].numpy(), atol=ATOL)


@pytest.mark.parametrize("bad", ["odd_window", "fused_bias", "fused_unscaled", "flash_unscaled",
                                 "bias_shape", "drop_shape", "mask_shape", "kv_shape"])
def test_wrappers_reject_bad_arguments(bad):
    q, k, v, mask, table = _inputs(8, 37)
    (tq, tk, tv, tm, tt), _ = _both(q, k, v, mask, table)
    fn = TA.relative_bias_fn(tt, 8, 9)
    with pytest.raises(ValueError):
        if bad == "odd_window":
            TA.local_attention(tq, tk, tv, 7, tm)
        elif bad == "fused_bias":
            TA.local_attention(tq, tk, tv, 8, tm, bias_fn=fn, use_pallas=True)
        elif bad == "fused_unscaled":
            TA.local_attention(tq, tk, tv, 8, tm, scale=False, use_pallas=True)
        elif bad == "flash_unscaled":
            TA.local_attention(tq, tk, tv, 8, tm, scale=False, use_pallas="flash")
        elif bad == "bias_shape":
            FA.flash_local_attention_biased(tq, tk, tv, tm, torch.zeros(2, 4, 12), 8)
        elif bad == "drop_shape":
            FA._flash_fwd(tq, tk, tv, tm, 8, drop_mask=torch.ones(6, 37, 24), keep=0.5)
        elif bad == "mask_shape":
            FA.flash_local_attention(tq, tk, tv, tm[:, :-1], 8)
        else:
            FA.fused_local_attention(tq, tk[:, :, :-1], tv, 8, tm)


def test_kernel_is_registered_and_not_built_on_import():
    from multimodaltopicsegmentation_torch.core import cuda_build

    assert FA.KERNEL in cuda_build.KERNELS and FA.KERNEL not in cuda_build._loaded
    assert cuda_build.library_path(FA.KERNEL).name.startswith("flash_local_attention-")


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(dev, B, H, L, Dh, lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, Dh, generator=g).to(dev) for _ in range(3))
    mask = (torch.arange(L)[None, :] < torch.tensor(lengths)[:, None]).float().to(dev)
    return q, k, v, mask, g


# (L, Dh, window, all rows of length 0): head dims that are no multiple of 8
# (4, 12) or 16, L at and past the 64-row tile edge (64, 65, 130), windows 0
# and 2, half 60 under a block of 64 (window 120)
CARD_SHAPES = [(37, 8, 8, False), (200, 24, 120, False), (300, 128, 240, False),
               (65, 4, 2, False), (130, 12, 0, False), (64, 32, 120, False), (200, 32, 120, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["unbiased", "biased_unscaled", "large_bias", "dropped"])
@pytest.mark.parametrize("L,Dh,window,empty", CARD_SHAPES)
def test_flash_kernel_matches_plain_on_card(cuda_device, variant, L, Dh, window, empty):
    """K2 against its plain version: rows of a few units, a zero-length row, a
    head dim that is no multiple of 16, L no multiple of the block. A bias
    of magnitude above 32 survives next to NEG_INF in float32, so padded rows
    then weigh their columns unequally."""
    B, H = 4, 2
    lengths = [0] * B if empty else [L, 0, 3, L // 2]
    q, k, v, mask, g = _card_inputs(cuda_device, B, H, L, Dh, lengths)
    block, nb, _ = FA._flash_geometry(L, window // 2)
    kw = {}
    if variant in ("biased_unscaled", "large_bias"):
        amp = 100.0 if variant == "large_bias" else 0.1
        kw = dict(bias=(amp * torch.randn(H, block, 3 * block, generator=g)).to(cuda_device),
                  scale=False)
    if variant == "dropped":
        tile = (torch.rand(B * H, nb * block, 3 * block, generator=g) < 0.75).float()
        kw = dict(drop_mask=tile.to(cuda_device), keep=0.75)
    before = FA._flash_fwd.launches
    out, lse = FA._flash_fwd(q, k, v, mask, window, **kw)
    torch.cuda.synchronize()
    assert FA._flash_fwd.launches == before + 1
    want_out, want_lse = FA.flash_local_attention_reference(q, k, v, mask, window, **kw)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L,Dh,window,empty", CARD_SHAPES)
def test_fused_kernel_matches_plain_on_card(cuda_device, L, Dh, window, empty):
    lengths = [0] * 4 if empty else [L, 0, 3, L // 2]
    q, k, v, mask, _ = _card_inputs(cuda_device, 4, 2, L, Dh, lengths, seed=1)
    before = FA.fused_local_attention.launches
    out = TA.local_attention(q, k, v, window, mask, use_pallas=True)
    torch.cuda.synchronize()
    assert FA.fused_local_attention.launches == before + 1
    torch.testing.assert_close(out, FA.fused_local_attention_reference(q, k, v, window, mask),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_card(cuda_device):
    """A CUDA tensor launches the kernel or raises: no fall-back."""
    q, k, v, mask, _ = _card_inputs(cuda_device, 1, 2, 16, 8, [16])
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_local_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask, 8)
    with pytest.raises(ValueError, match="float32"):
        FA.fused_local_attention(q.double(), k.double(), v.double(), 8, mask)
    with pytest.raises(ValueError, match="multiples of 4"):
        FA.flash_local_attention(q[..., :6].contiguous(), k[..., :6].contiguous(),
                                 v[..., :6].contiguous(), mask, 8)
