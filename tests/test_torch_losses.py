"""Port losses (ops/losses.py) and `head_loss` / `dropout` (models/base.py)
against the JAX package: the same numpy-seeded logits and tags through both,
values and gradients to 1e-6 (elementwise float32 arithmetic and one masked
sum), with padded tags of -1 and an all-padded batch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.models import base as JB
from multimodaltopicsegmentation_tpu.ops import losses as JL
from multimodaltopicsegmentation_torch.models import base as TB
from multimodaltopicsegmentation_torch.ops import losses as TL

ATOL = 1e-6
LOSS_FNS = ["CrossEntropy", "BinaryCrossEntropy", "FocalLoss"]


def _case(seed=0, N=97):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(N) * 4).astype(np.float32)
    logits[:3] = [40.0, -40.0, 0.0]  # the stable form's far ends
    targets = (rng.random(N) < 0.2).astype(np.float32)
    mask = (rng.random(N) < 0.7).astype(np.float32)
    return logits, targets, mask


def _value_and_grad_torch(fn, x, *rest):
    t = torch.from_numpy(x).requires_grad_()
    out = fn(t, *(torch.from_numpy(r) for r in rest))
    out.backward()
    return out.item(), t.grad.numpy()


@pytest.mark.parametrize("name,extra", [("sigmoid_focal_loss", (0.9, 2.0)),
                                        ("sigmoid_focal_loss", (-1.0, 1.5)),
                                        ("bce_loss", ())])
@pytest.mark.parametrize("all_masked", [False, True])
def test_masked_losses_match_jax(name, extra, all_masked):
    logits, targets, mask = _case()
    if all_masked:
        mask = np.zeros_like(mask)
    jfn, tfn = getattr(JL, name), getattr(TL, name)
    want, want_grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(targets), jnp.asarray(mask),
                                                       *extra))(jnp.asarray(logits))
    got, got_grad = _value_and_grad_torch(lambda x, t, m: tfn(x, t, m, *extra), logits, targets, mask)
    np.testing.assert_allclose(got, float(want), atol=ATOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), atol=ATOL)
    if all_masked:
        assert got == 0.0 and not got_grad.any()


def test_bce_with_logits_matches_jax_elementwise():
    logits, targets, _ = _case(seed=1)
    want = JL.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets))
    got = TL.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("all_ignored", [False, True])
def test_cross_entropy_ignore_index_matches_jax(all_ignored):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((60, 2)).astype(np.float32) * 3
    targets = rng.integers(0, 2, 60).astype(np.int32)
    targets[rng.random(60) < 0.3] = -1
    if all_ignored:
        targets[:] = -1
    want, want_grad = jax.value_and_grad(
        lambda x: JL.cross_entropy_ignore_index(x, jnp.asarray(targets)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = TL.cross_entropy_ignore_index(t, torch.from_numpy(targets))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), atol=ATOL)


@pytest.mark.parametrize("loss_fn", LOSS_FNS)
@pytest.mark.parametrize("lengths", [(11, 7, 0, 3), (0, 0, 0, 0)], ids=["ragged", "all_padded"])
def test_head_loss_matches_jax(loss_fn, lengths):
    """The three branches on a padded batch: tags are -1 past each length."""
    rng = np.random.default_rng(3)
    B, L = 4, 11
    C = 2 if loss_fn == "CrossEntropy" else 1
    logits = rng.standard_normal((B, L, C)).astype(np.float32) * 2
    lengths = np.array(lengths, np.int32)
    tags = (rng.random((B, L)) < 0.3).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    jcfg = JB.TaggerConfig(loss_fn=loss_fn, alpha=0.9, gamma=2.0)
    tcfg = TB.TaggerConfig(loss_fn=loss_fn, alpha=0.9, gamma=2.0)
    want, want_grad = jax.value_and_grad(
        lambda x: JB.head_loss(jcfg, x, jnp.asarray(lengths), jnp.asarray(tags)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = TB.head_loss(tcfg, t, torch.from_numpy(lengths), torch.from_numpy(tags))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), atol=ATOL)
    assert np.isfinite(got.item())


def test_dropout_semantics():
    """Inactive when deterministic, without a generator or at rate 0 (nothing
    is drawn); otherwise zeroes with probability `rate` and rescales by
    1 / keep, unbiased in the mean."""
    x = torch.ones(200, 300)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert TB.dropout(x, 0.5, g, True) is x
    assert TB.dropout(x, 0.5, None, False) is x
    assert TB.dropout(x, 0.0, g, False) is x
    assert torch.equal(g.get_state(), state)
    y = TB.dropout(x, 0.2, g, False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert abs(y.mean().item() - 1.0) < 0.01
    # the same generator state draws the same mask
    g.set_state(state)
    torch.testing.assert_close(TB.dropout(x, 0.2, g, False), y, atol=0, rtol=0)
