"""Port kernel K1 (ops/instance_norm_gelu) against the JAX package.

The plain PyTorch version is held to the Pallas kernel (interpret mode, as
tests/test_pallas_norm.py runs it) and to the masked JAX group norm + exact
GELU that the engine path computes. The CUDA kernel itself is compared with
the plain version on the card (marked `cuda`; skipped without one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.encoders.wav2vec2 import _group_norm
from multimodaltopicsegmentation_tpu.ops.pallas_norm import pallas_instance_norm_gelu
from multimodaltopicsegmentation_torch.ops.instance_norm_gelu import (
    instance_norm_gelu,
    instance_norm_gelu_reference,
)


def _inputs(B, C, T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


def _torch(x_btc):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_btc, (0, 2, 1))))


@pytest.mark.parametrize("T", [24, 37])  # multiple of 8 and not
def test_reference_matches_pallas_kernel(T):
    x, scale, bias = _inputs(3, 256, T)
    want = pallas_instance_norm_gelu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     interpret=True)
    got = instance_norm_gelu_reference(_torch(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_reference_matches_masked_group_norm():
    """Ragged lengths including 0 and full: statistics over valid frames only,
    normalisation over all frames (padded frames not zeroed)."""
    B, C, T = 4, 32, 29
    x, scale, bias = _inputs(B, C, T, seed=1)
    x[2] = 0.0  # a zero-length row holds zeros, as bucket_rows pads it
    lengths = np.array([T, 11, 0, 1], np.int32)
    fm = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    want = jax.nn.gelu(
        _group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x),
                    groups=C, frame_mask=jnp.asarray(fm)),
        approximate=False,
    )
    got = instance_norm_gelu_reference(_torch(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                       torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    # the zero-length row gives gelu(bias) in every frame, never NaN
    np.testing.assert_allclose(got[2].numpy(),
                               np.broadcast_to(torch.nn.functional.gelu(torch.from_numpy(bias))
                                               .numpy()[:, None], (C, T)), atol=1e-6)


def test_wrapper_on_cpu_takes_plain_version():
    x, scale, bias = _inputs(2, 8, 13)
    lengths = torch.tensor([13, 5], dtype=torch.int32)
    before = instance_norm_gelu.launches
    got = instance_norm_gelu(_torch(x), torch.from_numpy(scale), torch.from_numpy(bias), lengths)
    want = instance_norm_gelu_reference(_torch(x), torch.from_numpy(scale),
                                        torch.from_numpy(bias), lengths)
    assert torch.equal(got, want)
    assert instance_norm_gelu.launches == before  # the count is of kernel launches only


@pytest.mark.parametrize("bad", ["rank", "scale", "lengths"])
def test_wrapper_rejects_bad_shapes(bad):
    x = torch.zeros(2, 4, 5)
    s, b, l = torch.ones(4), torch.zeros(4), torch.tensor([5, 5], dtype=torch.int32)
    if bad == "rank":
        x = x[0]
    elif bad == "scale":
        s = torch.ones(3)
    else:
        l = l[:1]
    with pytest.raises(ValueError):
        instance_norm_gelu(x, s, b, l)


def test_module_imports_without_building():
    """Importing the op (done above, here without nvcc) builds nothing: the
    build runs at the first launch on a CUDA tensor, into a library named by
    a hash of the source."""
    from multimodaltopicsegmentation_torch.core import cuda_build
    from multimodaltopicsegmentation_torch.ops import instance_norm_gelu as m

    assert m.KERNEL not in cuda_build._loaded
    path = cuda_build.library_path(m.KERNEL)
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("instance_norm_gelu-")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, masked):
    B, C, T = 8, 64, 3199
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, C, T, generator=g).to(cuda_device)
    s = (1 + 0.1 * torch.randn(C, generator=g)).to(cuda_device)
    b = (0.1 * torch.randn(C, generator=g)).to(cuda_device)
    lengths = torch.tensor([T, 0, 1, 17, T, 3000, 2, T], dtype=torch.int32,
                           device=cuda_device) if masked else None
    before = instance_norm_gelu.launches
    got = instance_norm_gelu(x, s, b, lengths)
    torch.cuda.synchronize()
    assert instance_norm_gelu.launches == before + 1
    torch.testing.assert_close(got, instance_norm_gelu_reference(x, s, b, lengths),
                               atol=1e-4, rtol=1e-4)
