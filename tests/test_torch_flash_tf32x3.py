"""The arithmetic of the flash kernels K2 (forward), K4 and K5 (dq, dbias)
and K3 (dk/dv) on the tensor cores, emulated on the CPU: every float32 product in three TF32
passes ("3xTF32"), held against the JAX package's Pallas kernels in
interpret mode.

The CUDA kernels split each float32 operand x into big = tf32(x), where
tf32 is `cvt.rna.tf32.f32` (round the low 13 bits of the mantissa to
nearest, ties away from zero), and small = x - big, which the tensor core
reads with its low 13 bits cut (round toward zero), and compute a product as
a_small*b_big + a_big*b_small + a_big*b_big with float32 sums. Here
`torch.einsum`, through which the kernels' plain versions compute all their
products, is replaced by that three-pass product on rounded bits, and the
plain versions then run as they are. So this shows on the CPU, before any
run on the card, that the route keeps a margin under the card's 1e-4 gates
(kernel against plain version) where one TF32 pass would not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.ops import pallas_attention as JP
from multimodaltopicsegmentation_torch.ops import flash_attention as FA

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The products' error in three passes is some 2^-20 of their terms' size,
# against 2^-24 in float32: the emulated route stays within 1e-5 (absolute
# and relative) of the float32 Pallas kernels, the tolerance the plain
# versions are held to, on every row. One TF32 pass (2^-11) misses it.
ATOL = 1e-5
RATE = 0.25
_einsum = torch.einsum

# (Dh, window, biased, scale, dropped): the Transformer's heads, RecurrentLongT5's
# (biased, unscaled, q and k halved as projections of RMS-normed activations
# are), BiLSTMRestrictedMHA's (a 0/1 tile, half 60 under a block of 64)
CASES = [(96, 240, False, True, False), (64, 240, True, False, False),
         (32, 120, False, True, True)]
LENGTHS = (200, 70, 0)  # a full row, rows that see no key, a zero-length row


def tf32(x: np.ndarray) -> np.ndarray:
    """`cvt.rna.tf32.f32` on float32 bits: the low 13 mantissa bits rounded
    to nearest, ties away from zero (adding half an ulp to the magnitude)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = ((bits.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return np.where(finite, rounded, bits).view(np.float32)


def truncated(x: np.ndarray) -> np.ndarray:
    """A float32 operand as the tensor core reads it: the low 13 bits cut."""
    return (np.ascontiguousarray(x, dtype=np.float32).view(np.uint32) & 0xFFFFE000).view(np.float32)


def split(t: torch.Tensor):
    x = t.detach().contiguous().numpy()
    big = tf32(x)
    return torch.from_numpy(big), torch.from_numpy(truncated(x - big))


def einsum_3xtf32(eq, a, b):
    (ab, asm), (bb, bsm) = split(a), split(b)
    return (_einsum(eq, asm, bb) + _einsum(eq, ab, bsm)) + _einsum(eq, ab, bb)


def einsum_1xtf32(eq, a, b):
    return _einsum(eq, split(a)[0], split(b)[0])


def _inputs(Dh, window, biased, scale, dropped, L=200, H=2, seed=0):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    q, k, v, do = (rng.standard_normal((B, H, L, Dh)).astype(np.float32) for _ in range(4))
    if not scale:
        q, k = 0.5 * q, 0.5 * k
    mask = (np.arange(L)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)
    block, nb, _ = JP._flash_geometry(L, window // 2)
    bias = (0.3 * rng.standard_normal((H, block, 3 * block))).astype(np.float32) if biased else None
    key = jax.random.PRNGKey(5) if dropped else None
    tile = np.asarray(JP._drop_mask(key, RATE, B, H, nb, block)) if dropped else None
    return q, k, v, do, mask, bias, key, tile


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _jax_forward(q, k, v, mask, window, bias, scale, key):
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    return JP._flash_fwd_impl(jq, jk, jv, jm, window, True,
                              bias=None if bias is None else jnp.asarray(bias), scale=scale,
                              dropkey=key, rate=RATE if key is not None else 0.0)


def test_tf32_rounding_on_bits():
    """Nearest with ties away from zero, 10 mantissa bits kept; big plus the
    truncated remainder within 2^-21 of x (relative)."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp * 0.49, one + ulp * 1.5],
                 dtype=np.float32)
    np.testing.assert_array_equal(tf32(x), [one + ulp, -(one + ulp), one, one + 2 * ulp])
    y = np.random.default_rng(1).standard_normal(10000).astype(np.float32) * 100
    big = tf32(y)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    small = truncated(y - big)
    assert (np.abs(big + small - y) <= 2.0 ** -21 * np.abs(y)).all()
    assert (np.abs(big - y) > 2.0 ** -20 * np.abs(y)).any()  # one pass alone is coarse


@pytest.mark.parametrize("Dh,window,biased,scale,dropped", CASES)
def test_forward_in_three_tf32_passes_matches_pallas(monkeypatch, Dh, window, biased, scale,
                                                     dropped):
    """K2's arithmetic: O and lse on every row, padded and zero-length ones
    included, within 1e-5 of `_flash_fwd_impl` in interpret mode."""
    q, k, v, _, mask, bias, key, tile = _inputs(Dh, window, biased, scale, dropped)
    B, H, L, _ = q.shape
    want_o, want_lse = _jax_forward(q, k, v, mask, window, bias, scale, key)
    tq, tk, tv, tm, tb, tt = _torch(q, k, v, mask, bias, tile)
    monkeypatch.setattr(torch, "einsum", einsum_3xtf32)
    got_o, got_lse = FA.flash_local_attention_reference(tq, tk, tv, tm, window, tb, scale, tt,
                                                        1.0 - RATE if dropped else 1.0)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL, rtol=ATOL)
    nbb = np.asarray(want_lse).size // (B * H)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(B, H, nbb)[:, :, :L],
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("Dh,window,biased,scale,dropped", CASES)
def test_dkv_in_three_tf32_passes_matches_pallas(monkeypatch, Dh, window, biased, scale, dropped):
    """K3's arithmetic: dk and dv on every row, from the emulated forward's O
    and lse, within 1e-5 of `_flash_bwd_impl` in interpret mode."""
    q, k, v, do, mask, bias, key, tile = _inputs(Dh, window, biased, scale, dropped, seed=1)
    out, lse = _jax_forward(q, k, v, mask, window, bias, scale, key)
    want = JP._flash_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, mask)), out, lse,
                              jnp.asarray(do), window, True,
                              bias=None if bias is None else jnp.asarray(bias), scale=scale,
                              dropkey=key, rate=RATE if dropped else 0.0)
    tq, tk, tv, tdo, tm, tb, tt = _torch(q, k, v, do, mask, bias, tile)
    keep = 1.0 - RATE if dropped else 1.0
    monkeypatch.setattr(torch, "einsum", einsum_3xtf32)
    tout, tlse = FA.flash_local_attention_reference(tq, tk, tv, tm, window, tb, scale, tt, keep)
    dd = (tdo * tout).sum(dim=-1)
    dk, dv = FA.flash_dkv_reference(tq, tk, tv, tm, tlse, tdo, dd, window, tb, scale, tt, keep)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want[1]), atol=ATOL, rtol=ATOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), np.asarray(want[2]), atol=ATOL, rtol=ATOL, err_msg="dv")


@pytest.mark.parametrize("Dh,window,biased,scale,dropped", CASES)
def test_dq_in_three_tf32_passes_matches_pallas(monkeypatch, Dh, window, biased, scale, dropped):
    """K4's and K5's arithmetic: dq on every row and, with a bias tile, dbias,
    from the emulated forward's O and lse, within 1e-5 of `_flash_bwd_impl`
    in interpret mode (the biased, unscaled Dh 64 case is RecurrentLongT5's)."""
    q, k, v, do, mask, bias, key, tile = _inputs(Dh, window, biased, scale, dropped, seed=2)
    out, lse = _jax_forward(q, k, v, mask, window, bias, scale, key)
    want = JP._flash_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, mask)), out, lse,
                              jnp.asarray(do), window, True,
                              bias=None if bias is None else jnp.asarray(bias), scale=scale,
                              dropkey=key, rate=RATE if dropped else 0.0)
    tq, tk, tv, tdo, tm, tb, tt = _torch(q, k, v, do, mask, bias, tile)
    keep = 1.0 - RATE if dropped else 1.0
    monkeypatch.setattr(torch, "einsum", einsum_3xtf32)
    tout, tlse = FA.flash_local_attention_reference(tq, tk, tv, tm, window, tb, scale, tt, keep)
    dd = (tdo * tout).sum(dim=-1)
    dq, dbias = FA.flash_dq_reference(tq, tk, tv, tm, tlse, tdo, dd, window, tb, scale, tt, keep)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want[0]), atol=ATOL, rtol=ATOL, err_msg="dq")
    if biased:
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want[3]), atol=ATOL, rtol=ATOL,
                                   err_msg="dbias")
    else:
        assert dbias is None


def test_one_tf32_pass_misses_the_tolerance(monkeypatch):
    """The control: the same forward with one TF32 pass per product is more
    than 1e-5 away from the float32 kernel, so the test above can tell."""
    Dh, window, biased, scale, dropped = CASES[0]
    q, k, v, _, mask, bias, key, tile = _inputs(Dh, window, biased, scale, dropped)
    want_o, _ = _jax_forward(q, k, v, mask, window, bias, scale, key)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    monkeypatch.setattr(torch, "einsum", einsum_1xtf32)
    got_o, _ = FA.flash_local_attention_reference(tq, tk, tv, tm, window)
    assert np.abs(got_o.numpy() - np.asarray(want_o)).max() > 10 * ATOL
