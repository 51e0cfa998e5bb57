"""The port's flash-attention backward (ops/flash_attention.py: the plain
versions of kernels K4, K5 and K3, `_flash_bwd`, the four differentiable
entries) against the JAX package, the same numpy-seeded arrays through both,
TF32 off.

- the plain versions against the Pallas backward kernels in interpret mode
  (as tests/test_attention.py runs them on the CPU): dq, dk, dv and dbias on
  EVERY row, absolute and relative 1e-5 (summation order), with a non-zero
  cotangent on padded rows, ragged and zero lengths, windows whose half is
  and is not a multiple of 8,
  L no multiple of the block, scaled and unscaled, biased, and with the JAX
  0/1 tile injected;
- the four entries' gradients against `jax.grad` of the four `custom_vjp`
  entries, and against autograd through the blocked path on valid rows;
- attention-probs dropout: inactive without a generator or at rate 0,
  unbiased in the mean, one tile for the flash and the blocked path where
  their geometries coincide, and a backward that draws the forward's tile;
- the CUDA kernels against their plain versions on the card (marked `cuda`).
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

# (window, L): half 2, 4 (block 8), 60 (block 64, L no multiple) and 3 (L < block)
GEOMETRIES = [(4, 16), (8, 37), (120, 200), (6, 7), (16, 40)]
# (biased, scale, dropped)
VARIANTS = [(False, True, False), (True, False, False), (True, True, False),
            (False, True, True), (True, False, True)]
ATOL = 1e-5
RATE = 0.25


def _inputs(window, L, seed=0, B=3, H=2, Dh=8):
    """q, k, v, a cotangent that is non-zero on every row, a ragged prefix mask
    with a full and a zero-length row, and a bias tile at the flash geometry."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, L, Dh)).astype(np.float32) for _ in range(4))
    lengths = np.array([L, max(L - 5, 1), 0][:B])
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    block = JP._flash_geometry(L, window // 2)[0]
    bias = (rng.standard_normal((H, block, 3 * block)) * 0.3).astype(np.float32)
    return q, k, v, do, mask, bias


def _jax_tile(seed, B, H, L, window):
    block, nb, _ = JP._flash_geometry(L, window // 2)
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(JP._drop_mask(key, RATE, B, H, nb, block))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("window,L", GEOMETRIES)
@pytest.mark.parametrize("biased,scale,dropped", VARIANTS)
def test_plain_backward_matches_pallas_interpret(window, L, biased, scale, dropped):
    q, k, v, do, mask, bias = _inputs(window, L)
    B, H = q.shape[:2]
    bias = bias if biased else None
    key, tile = _jax_tile(3, B, H, L, window) if dropped else (None, None)
    jq, jk, jv, jdo, jm = (jnp.asarray(a) for a in (q, k, v, do, mask))
    jb = None if bias is None else jnp.asarray(bias)
    rate = RATE if dropped else 0.0
    out, lse = JP._flash_fwd_impl(jq, jk, jv, jm, window, True, bias=jb, scale=scale,
                                  dropkey=key, rate=rate)
    want = JP._flash_bwd_impl(jq, jk, jv, jm, out, lse, jdo, window, True, bias=jb, scale=scale,
                              dropkey=key, rate=rate)

    tq, tk, tv, tdo, tm, tb, tt = _t(q, k, v, do, mask, bias, tile)
    keep = 1.0 - rate
    tout, tlse = FA._flash_fwd(tq, tk, tv, tm, window, tb, scale, tt, keep)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=ATOL)
    got = FA._flash_bwd(tq, tk, tv, tm, tout, tlse, tdo, window, tb, scale, tt, keep)
    # unscaled scores reach +-10 at Dh 8, where one ulp of exp(s - lse) is a few
    # 1e-6 of a gradient of magnitude 1: absolute and relative 1e-5
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL, err_msg=name)
    if biased:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=ATOL, rtol=ATOL,
                                   err_msg="dbias")
    else:
        assert got[3] is None
    # padded query rows get zero dq, whatever their cotangent
    lengths = mask.sum(1).astype(int)
    for b, n in enumerate(lengths):
        assert not got[0][b, :, n:].any()


def test_plain_versions_are_the_wrappers_cpu_route():
    """On CPU tensors the three wrappers return their plain versions' results
    and count no launch."""
    window, L = 8, 37
    q, k, v, do, mask, bias = _t(*_inputs(window, L))
    out, lse = FA._flash_fwd(q, k, v, mask, window, bias, False)
    dd = (do * out).sum(-1)
    before = (FA._flash_dq.launches, FA._flash_dq_dbias.launches, FA._flash_dkv.launches)
    dq, dbias = FA._flash_dq_dbias(q, k, v, mask, lse, do, dd, window, bias, False)
    want_dq, want_dbias = FA.flash_dq_reference(q, k, v, mask, lse, do, dd, window, bias, False)
    torch.testing.assert_close(dq, want_dq, atol=0, rtol=0)
    torch.testing.assert_close(dbias, want_dbias, atol=0, rtol=0)
    dk, dv = FA._flash_dkv(q, k, v, mask, lse, do, dd, window, bias, False)
    want_dk, want_dv = FA.flash_dkv_reference(q, k, v, mask, lse, do, dd, window, bias, False)
    torch.testing.assert_close(dk, want_dk, atol=0, rtol=0)
    torch.testing.assert_close(dv, want_dv, atol=0, rtol=0)
    assert FA._flash_dq(q, k, v, mask, lse, do, dd, window, False).shape == q.shape
    assert before == (FA._flash_dq.launches, FA._flash_dq_dbias.launches, FA._flash_dkv.launches)


def test_backward_wrappers_reject_bad_shapes():
    window, L = 8, 37
    q, k, v, do, mask, bias = _t(*_inputs(window, L))
    out, lse = FA._flash_fwd(q, k, v, mask, window)
    dd = (do * out).sum(-1)
    with pytest.raises(ValueError, match="dO must be"):
        FA._flash_dq(q, k, v, mask, lse[:, :, :-1], do, dd, window)
    with pytest.raises(ValueError, match="bias must be"):
        FA._flash_dkv(q, k, v, mask, lse, do, dd, window, bias[:, :4])
    with pytest.raises(ValueError, match="keep"):
        FA._flash_dkv(q, k, v, mask, lse, do, dd, window, keep=0.0)


def _entry_grads_jax(variant, q, k, v, mask, bias, weights, window, key):
    biased, scale, dropped = variant
    m = jnp.asarray(mask)
    w = jnp.asarray(weights)

    def loss(q, k, v, bias):
        if biased and dropped:
            o = JP.flash_local_attention_biased_dropped(q, k, v, m, bias, key, window, RATE, scale, True)
        elif biased:
            o = JP.flash_local_attention_biased(q, k, v, m, bias, window, scale, True)
        elif dropped:
            o = JP.flash_local_attention_dropped(q, k, v, m, key, window, RATE, True)
        else:
            o = JP.flash_local_attention(q, k, v, m, window, True)
        return jnp.sum(jnp.sin(o) * w)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))


def _entry_grads_torch(variant, q, k, v, mask, bias, weights, window, generator=None):
    biased, scale, dropped = variant
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias))
    tm, tw = torch.from_numpy(mask), torch.from_numpy(weights)
    if biased and dropped:
        o = FA.flash_local_attention_biased_dropped(tq, tk, tv, tm, tb, generator, window, RATE, scale)
    elif biased:
        o = FA.flash_local_attention_biased(tq, tk, tv, tm, tb, window, scale)
    elif dropped:
        o = FA.flash_local_attention_dropped(tq, tk, tv, tm, generator, window, RATE)
    else:
        o = FA.flash_local_attention(tq, tk, tv, tm, window)
    (torch.sin(o) * tw).sum().backward()
    return tq.grad, tk.grad, tv.grad, tb.grad


@pytest.mark.parametrize("window,L", [(4, 16), (8, 37), (6, 7)])
@pytest.mark.parametrize("variant", [(False, True, False), (True, False, False),
                                     (False, True, True), (True, False, True)],
                         ids=["plain", "biased", "dropped", "biased_dropped"])
def test_entries_match_jax_custom_vjp(window, L, variant, monkeypatch):
    """Gradients of sum(sin(O) * W), W non-zero on padded rows too, through
    each differentiable entry against jax.grad of its custom_vjp counterpart;
    the JAX 0/1 tile is injected in place of the port's own draw."""
    q, k, v, _, mask, bias = _inputs(window, L, seed=1)
    B, H = q.shape[:2]
    weights = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    key, tile = _jax_tile(5, B, H, L, window)
    want = _entry_grads_jax(variant, q, k, v, mask, bias, weights, window, key)
    draws = []

    def injected(generator, rate, *geometry):
        draws.append(rate)
        return torch.from_numpy(tile)

    monkeypatch.setattr(FA, "_drop_mask", injected)
    got = _entry_grads_torch(variant, q, k, v, mask, bias, weights, window,
                             torch.Generator().manual_seed(0))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
    if variant[0]:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-5, err_msg="dbias")
    else:
        assert got[3] is None
    # the tile is drawn once in the forward and once more in the backward
    assert draws == ([RATE, RATE] if variant[2] else [])


@pytest.mark.parametrize("window,L", [(4, 16), (8, 37), (16, 40)])
@pytest.mark.parametrize("biased", [False, True])
def test_entries_match_autograd_through_the_blocked_path(window, L, biased):
    """Through a length-masked loss (as every loss of the library is) the
    flash entries give what autograd gives through `local_attention`'s blocked
    path, the bucket table's gradient through `relative_bias_fn` included."""
    q, k, v, _, mask, _ = _inputs(window, L, seed=2)
    table = (np.random.default_rng(9).standard_normal((8, q.shape[1])) * 0.1).astype(np.float32)
    m4 = torch.from_numpy(mask)[:, None, :, None]
    grads = []
    for route in ("flash", False):
        tq, tk, tv, tt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, table))
        fn = TA.relative_bias_fn(tt, 8, window + 1) if biased else None
        o = TA.local_attention(tq, tk, tv, window, torch.from_numpy(mask), bias_fn=fn,
                               use_pallas=route, scale=not biased)
        (torch.sin(o) * m4).sum().backward()
        grads.append((tq.grad, tk.grad, tv.grad, tt.grad if biased else None))
    for name, a, b in zip(("dq", "dk", "dv", "dtable"), *grads):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, err_msg=name)


def test_bucket_table_gradient_matches_jax():
    window, L = 8, 37
    q, k, v, _, mask, _ = _inputs(window, L, seed=4)
    table = (np.random.default_rng(11).standard_normal((8, q.shape[1])) * 0.1).astype(np.float32)
    m4 = mask[:, None, :, None]
    block = JP._flash_geometry(L, window // 2)[0]
    rel = jnp.asarray(np.arange(3 * block)[None, :] - block - np.arange(block)[:, None])

    def loss(tbl):
        tile = JA.relative_bias_fn(tbl, 8, window + 1)(rel)
        o = JP.flash_local_attention_biased(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(mask), tile, window, False, True)
        return jnp.sum(jnp.sin(o) * m4)

    want = jax.grad(loss)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    o = TA.local_attention(*_t(q, k, v), window, torch.from_numpy(mask),
                           bias_fn=TA.relative_bias_fn(tt, 8, window + 1), use_pallas="flash",
                           scale=False)
    (torch.sin(o) * torch.from_numpy(m4)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), atol=2e-5)


# -- attention-probs dropout ---------------------------------------------------


def test_probs_dropout_inactive_without_generator_or_rate():
    q, k, v, _, mask, _ = _t(*_inputs(8, 37, seed=5))
    clean = TA.local_attention(q, k, v, 8, mask, use_pallas="flash")
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    for kwargs in (dict(probs_drop=0.5), dict(probs_drop=0.0, generator=g)):
        for route in ("flash", False):
            got = TA.local_attention(q, k, v, 8, mask, use_pallas=route, **kwargs)
            want = clean if route == "flash" else TA.local_attention(q, k, v, 8, mask,
                                                                     use_pallas=False)
            torch.testing.assert_close(got, want, atol=0, rtol=0)
        torch.testing.assert_close(TA.dense_attention(q, k, v, mask, **kwargs),
                                   TA.dense_attention(q, k, v, mask), atol=0, rtol=0)
    assert torch.equal(g.get_state(), state)  # nothing was drawn
    w = torch.rand(2, 3, 4)
    assert TA._drop_probs(w, 0.3, None) is w and TA._drop_probs(w, 0.0, g) is w


def test_probs_dropout_is_unbiased_in_the_mean():
    g = torch.Generator().manual_seed(0)
    w = torch.full((64, 64, 64), 0.5)
    dropped = TA._drop_probs(w, 0.3, g)
    kept = dropped != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(dropped[kept], torch.full_like(dropped[kept], 0.5 / 0.7))
    assert abs(dropped.mean().item() - 0.5) < 0.01
    tile = FA._drop_mask(torch.Generator().manual_seed(1), 0.3, 2, 2, 5, 8, "cpu")
    assert tile.shape == (4, 40, 24) and set(tile.unique().tolist()) == {0.0, 1.0}
    assert abs(tile.mean().item() - 0.7) < 0.02


def test_flash_and_blocked_routes_draw_the_same_tile_where_geometries_coincide():
    """window 16: half 8 is the flash block too, so one generator state gives
    both routes one tile, and their dropped outputs agree on valid rows."""
    window, L = 16, 40
    q, k, v, _, mask, _ = _t(*_inputs(window, L, seed=6))
    outs = [TA.local_attention(q, k, v, window, mask, use_pallas=route, probs_drop=0.4,
                               generator=torch.Generator().manual_seed(3))
            for route in ("flash", False)]
    clean = TA.local_attention(q, k, v, window, mask, use_pallas=False)
    assert (outs[1] - clean).abs().max() > 1e-2  # dropout did act
    for b, n in enumerate(mask.sum(1).int().tolist()):
        torch.testing.assert_close(outs[0][b, :, :n], outs[1][b, :, :n], atol=ATOL, rtol=0)


@pytest.mark.parametrize("biased", [False, True])
def test_dropped_entry_backward_redraws_the_forward_tile(biased):
    """Gradients of the dropped entries equal those of the plain forward and
    backward given the very tile the generator's state yields, and the
    caller's generator advances only in the forward."""
    window, L = 8, 37
    q, k, v, _, mask, bias = _inputs(window, L, seed=8)
    weights = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    g = torch.Generator().manual_seed(12)
    block, nb, _ = FA._flash_geometry(L, window // 2)
    tile = FA._drop_mask(torch.Generator().manual_seed(12), RATE, q.shape[0], q.shape[1], nb, block,
                         "cpu")
    variant = (biased, not biased, True)
    got = _entry_grads_torch(variant, q, k, v, mask, bias, weights, window, g)
    after = g.get_state()

    tq, tk, tv, tm, tb, tw = _t(q, k, v, mask, bias if biased else None, weights)
    out, lse = FA._flash_fwd(tq, tk, tv, tm, window, tb, not biased, tile, 1.0 - RATE)
    do = torch.cos(out) * tw
    want = FA._flash_bwd(tq, tk, tv, tm, out, lse, do, window, tb, not biased, tile, 1.0 - RATE)
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    once = torch.Generator().manual_seed(12)
    FA._drop_mask(once, RATE, q.shape[0], q.shape[1], nb, block, "cpu")
    assert torch.equal(after, once.get_state())


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("window,L,Dh,empty", [
    (8, 37, 8, False), (120, 200, 32, False), (240, 700, 96, False), (16, 130, 64, False),
    # head dims no multiple of 8, L at and past the 64-row tile edge, windows 2 and 0,
    # half 60 under a block of 64, a batch whose rows are all of length 0
    (2, 65, 4, False), (0, 130, 12, False), (120, 64, 32, False), (120, 200, 32, True)])
@pytest.mark.parametrize("biased,scale,dropped", VARIANTS)
def test_cuda_backward_kernels_match_plain(window, L, Dh, empty, biased, scale, dropped):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, H = 3, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, L, Dh)).astype(np.float32)).to(dev)
                   for _ in range(4))
    if not scale:
        # unit-variance q and k make an unscaled softmax one-hot, with gradients
        # in the tens, where 1e-4 absolute is an ulp; projections are of this size
        q, k = 0.5 * q, 0.5 * k
    lengths = torch.tensor([0, 0, 0] if empty else [L, max(L - 5, 1), 0], device=dev)
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]).float()
    block, nb, _ = FA._flash_geometry(L, window // 2)
    bias = (0.3 * torch.randn(H, block, 3 * block, device=dev)) if biased else None
    tile = (torch.rand(B * H, nb * block, 3 * block, device=dev) < 0.75).float() if dropped else None
    keep = 0.75 if dropped else 1.0
    out, lse = FA._flash_fwd(q, k, v, mask, window, bias, scale, tile, keep)
    got = FA._flash_bwd(q, k, v, mask, out, lse, do, window, bias, scale, tile, keep)
    torch.cuda.synchronize()
    dd = (do * out).sum(-1)
    want_dq, want_dbias = FA.flash_dq_reference(q, k, v, mask, lse, do, dd, window, bias, scale,
                                                tile, keep)
    want_dk, want_dv = FA.flash_dkv_reference(q, k, v, mask, lse, do, dd, window, bias, scale,
                                              tile, keep)
    # tile-wise summation order and expf against torch's exp
    for g, w in zip(got, (want_dq, want_dk, want_dv, want_dbias)):
        if w is not None:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    if biased:  # K5 sums dbias in a fixed order: a second call gives the same bits
        again = FA._flash_dq_dbias(q, k, v, mask, lse, do, dd, window, bias, scale, tile, keep)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[3])

