"""The port's auxiliary cosine loss (multimodaltopicsegmentation_torch/ops/
cosine_loss.py) against the JAX package's ops/cosine_loss.py on
numpy-seeded states: value 1e-6, gradient 1e-5.

The cases hold a single-unit segment, a document with no boundary, a
zero-length row, boundaries on every unit, and padding labelled -1."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.ops.cosine_loss import cosine_segment_loss as jax_loss
from multimodaltopicsegmentation_torch.ops.cosine_loss import cosine_segment_loss


def _case(seed):
    rng = np.random.default_rng(seed)
    B, L, D = 6, 12, 5
    h = rng.standard_normal((B, L, D)).astype(np.float32)
    lengths = np.array([12, 9, 0, 7, 12, 5], np.int32)
    tags = (rng.random((B, L)) < 0.3).astype(np.float32)
    tags[0, :] = 0.0
    tags[0, [0, 5, 6]] = 1.0  # a single-unit segment at the start and at 6
    tags[3, :] = 0.0  # no boundary
    tags[4, :] = 1.0  # every unit a boundary
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    return h, lengths, tags


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_value_and_gradient_match_jax(seed):
    h, lengths, tags = _case(seed)
    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(h), jnp.asarray(lengths),
                                                   jnp.asarray(tags))
    th = torch.from_numpy(h).requires_grad_()
    got = cosine_segment_loss(th, torch.from_numpy(lengths), torch.from_numpy(tags))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=0)
    assert not th.grad[1, 9:].any() and not th.grad[2].any()  # padding takes no gradient


def test_no_pair_gives_zero():
    """No complete segment anywhere: no pair, the loss is 0 (0 / max(0, 1))."""
    h, lengths, tags = _case(3)
    tags[:] = 0.0
    got = cosine_segment_loss(torch.from_numpy(h), torch.from_numpy(lengths), torch.from_numpy(tags))
    want = jax_loss(jnp.asarray(h), jnp.asarray(lengths), jnp.asarray(tags))
    assert got.item() == float(want) == 0.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_matches_the_cpu(cuda_device):
    h, lengths, tags = _case(4)
    args = [torch.from_numpy(a) for a in (h, lengths, tags)]
    cpu = cosine_segment_loss(*args)
    card = cosine_segment_loss(*(a.to(cuda_device) for a in args))
    np.testing.assert_allclose(card.item(), cpu.item(), atol=1e-5)
