"""The feature stack's strided convolutions, channels-last (`ops/conv_tf32x3.py`,
`csrc/conv_tf32x3.cu`), and their use by the wav2vec2 and WavLM encoders.

On the CPU: the implicit GEMM's arithmetic (three TF32 products, emulated on
the rounded and truncated bits) within float32-class error of float64 at
every conv shape of both models and at `tiny()`'s, where one TF32 pass is
not; the padded frame chain against the [B, C, T] stack on ragged lengths;
the plain versions against `F.conv1d`; the cached weight operands following
the parameters; the encoder's CPU path untouched.

On the card (marked `cuda`): the kernel against float64 at each shape, for
the rows of a 256-row chunk and of a 32-row tail bucket, with and without
bias and GELU, the whole batch read as one sequence (as the card does), one
TF32 pass failing the same tolerance; conv layer 0, the transposing pass and
the LayerNorm + GELU against their plain versions; both encoders at full
width on the card against the CPU, with 6 conv launches and 4 L + 1 linear
launches a forward. No JAX here.

The error measure is that of tests/test_torch_linear_tf32x3.py: the worst
element's |y - y64| over the same conv of |x| and |w| plus |b|.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
from multimodaltopicsegmentation_torch.ops import conv_tf32x3 as CV
from multimodaltopicsegmentation_torch.ops import linear_tf32x3 as L

TOL = 2e-6  # float32-class, as the dense layer's tests; one TF32 pass reads 3e-5 or more


def conv64(x, w, b, stride, gelu=False):
    """The plain version in float64 on x [B, stride P, C]: output [B, P, C_out]."""
    y = CV._plain(x.double(), w.double(), None if b is None else b.double(), stride, False)
    return F.gelu(y) if gelu else y


def scaled_error(y, x, w, b, stride, gelu=False):
    want = conv64(x, w, b, stride, gelu)
    scale = conv64(x.abs(), w.abs(), None if b is None else b.abs(), stride)
    return ((y.double() - want).abs() / scale).max().item()


def operands(B, P, c_in, c_out, k, stride, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, stride * P, c_in, generator=g)
    w = torch.randn(c_out, c_in, k, generator=g) * (k * c_in) ** -0.5
    b = 0.1 * torch.randn(c_out, generator=g)
    return x.to(device), w.to(device), b.to(device)


# (C_in, C_out, k, stride) of conv layers 1-6 of wav2vec2-base and WavLM-Large,
# and of tiny()'s layer 1
SHAPES = [(512, 512, 3, 2), (512, 512, 2, 2), (16, 16, 3, 2)]


# -- CPU ------------------------------------------------------------------------------

@pytest.mark.parametrize("c_in, c_out, k, stride", SHAPES)
def test_three_products_hold_float32_class_error(c_in, c_out, k, stride):
    x, w, b = operands(2, 25, c_in, c_out, k, stride, seed=k + c_in)
    assert scaled_error(CV._plain(x, w, b, stride, False), x, w, b, stride) < TOL  # the yardstick
    for gelu in (False, True):
        got = CV.conv_tf32x3_reference(x, w, b, stride, gelu)
        assert got.shape == (2, 25, c_out)
        assert scaled_error(got, x, w, b, stride, gelu) < TOL
    big = lambda t: L.split_tf32(t)[0]  # noqa: E731
    assert scaled_error(CV._plain(big(x), big(w), b, stride, False), x, w, b, stride) > 10 * TOL


@pytest.mark.parametrize("gelu", [False, True])
def test_cpu_wrappers_are_f_conv1d(gelu):
    x, w, b = operands(3, 20, 16, 24, 3, 2, seed=5)
    want = F.conv1d(F.pad(x.transpose(1, 2), (0, 1)), w, b, stride=2)
    want = (F.gelu(want) if gelu else want).transpose(1, 2)
    before = CV.conv_tf32x3.launches
    assert torch.equal(CV.conv_tf32x3(x, w, b, 2, gelu), want)
    conv = torch.nn.Conv1d(16, 24, 3)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    assert torch.equal(CV.FusedConv(conv)(x, 2, gelu), want)
    assert CV.conv_tf32x3.launches == before


def test_first_conv_and_channels_last_plain_versions():
    g = torch.Generator().manual_seed(2)
    audio = torch.randn(3, 1003, generator=g)
    w, b = torch.randn(8, 1, 10, generator=g), torch.randn(8, generator=g)
    full = F.conv1d(audio[:, None], w, b, stride=5)  # 199 frames
    for frames in (199, 200, 150):
        got = CV.first_conv(audio, w, b, 5, frames)
        assert got.shape == (3, frames, 8)
        n = min(frames, 199)
        assert torch.equal(got[:, :n], full.transpose(1, 2)[:, :n])
    # frame 199 reads samples 995 .. 1004: those past the end are zeros
    want = F.conv1d(F.pad(audio, (0, 2))[:, None, 995:], w, b)[..., 0]
    torch.testing.assert_close(CV.first_conv(audio, w, b, 5, 200)[:, 199], want)
    x = torch.randn(2, 8, 7, generator=g)
    y = CV.channels_last(x, 10)
    assert torch.equal(y[:, :7], x.transpose(1, 2)) and not y[:, 7:].any()
    x = torch.randn(2, 5, 8, generator=g)
    ln = torch.nn.LayerNorm(8, eps=1e-5)
    with torch.no_grad():
        assert torch.equal(CV.layer_norm_gelu(x, ln.weight, ln.bias, ln.eps), F.gelu(ln(x)))


@pytest.mark.parametrize("n", [16000, 15999, 12345, 1600, 400, 400 + 319])
def test_padded_frames_chain(n):
    for cfg in (W.Wav2Vec2Config.base(), W.Wav2Vec2Config.tiny()):
        P = W.padded_frames(cfg, n)
        T, t = [], n
        for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
            t = (t - k) // s + 1
            T.append(t)
        assert all(p >= t for p, t in zip(P, T))
        assert all(P[i - 1] == cfg.conv_stride[i] * P[i] for i in range(1, len(P)))
        # the least such chain: one frame fewer at the end breaks a layer
        smaller = [p // P[-1] * (P[-1] - 1) for p in P]
        assert any(p < t for p, t in zip(smaller, T))
    assert W.padded_frames(W.Wav2Vec2Config.base(), 16000) == [3200, 1600, 800, 400, 200, 100, 50]
    with pytest.raises(ValueError):
        W.padded_frames(W.Wav2Vec2Config.base(), 399)


def _model(cfg, seed=0):
    sd = W.random_state_dict(cfg, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for name in sd:  # conv biases not zero, so a lost bias shows
        if name.endswith("conv.bias"):
            sd[name] = torch.randn(sd[name].shape, generator=g)
    return W.build_model(cfg, sd, "cpu")


TINY = W.Wav2Vec2Config.tiny()
GEOMETRIES = {
    "group_norm": TINY,
    "instance_norm": dataclasses.replace(TINY, num_groupnorm_groups=16),  # K1's plain version
    "layer_norm_bias": dataclasses.replace(TINY, feat_extract_norm="layer", conv_bias=True),
    "three_layers": dataclasses.replace(TINY, conv_dim=(16, 16, 20), conv_kernel=(10, 3, 2),
                                        conv_stride=(5, 2, 2), feat_extract_norm="layer"),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_padded_chain_matches_the_plain_stack(name):
    cfg = GEOMETRIES[name]
    model = _model(cfg)
    g = torch.Generator().manual_seed(3)
    S = 3333  # 665 frames after conv layer 0: an odd count
    audio = torch.randn(4, S, generator=g)
    lengths = torch.tensor([S, 0, 2001, 1500])
    audio[1] = 0.0
    with torch.no_grad():
        want = model._features_plain(audio, lengths)
        got = model._features_channels_last(audio, lengths)
    assert got.shape == want.shape == (4, W.feature_extractor_output_length(cfg, S),
                                       cfg.hidden_size)
    valid = W.feature_extractor_output_length(cfg, lengths)
    for row in range(4):
        n = int(valid[row])
        torch.testing.assert_close(got[row, :n], want[row, :n], rtol=1e-6, atol=1e-6)


def test_cpu_encoder_path_is_untouched():
    model = _model(GEOMETRIES["layer_norm_bias"])
    audio = torch.randn(2, 2000, generator=torch.Generator().manual_seed(4))
    counters = (CV.conv_tf32x3, CV.first_conv, CV.channels_last, CV.layer_norm_gelu)
    counts = [f.launches for f in counters]
    with torch.no_grad():
        assert torch.equal(model._features(audio, None), model._features_plain(audio, None))
    assert [f.launches for f in counters] == counts


def test_cached_operands_follow_the_parameters():
    cfg = GEOMETRIES["layer_norm_bias"]
    model = _model(cfg)
    layer = model.feature_extractor.conv_layers[1]

    def check():
        ((big, small), k), bias = layer.fused.operands()
        assert k == cfg.conv_kernel[1]
        assert torch.equal(big + small, CV.gemm_weight(layer.conv.weight))
        assert torch.equal(bias, layer.conv.bias)
        return big

    big = check()
    assert layer.fused.operands()[0][0][0] is big  # cached while nothing changes
    model.load_state_dict(_model(cfg, seed=5).state_dict())  # copies in place: versions move
    assert check() is not big
    with torch.no_grad():
        layer.conv.weight.mul_(2.0)
    check()
    new = {k: v + 1.0 for k, v in model.state_dict().items()}
    model.load_state_dict(new, assign=True)  # new parameter tensors
    check()
    with torch.inference_mode():  # parameters without a version counter
        model = _model(cfg, seed=6)
    layer = model.feature_extractor.conv_layers[1]
    check()


# -- the card -------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (C_in, C_out, k, stride, output frames P) of conv layers 1-6 over 1-s units, and tiny()'s
CARD_SHAPES = [(512, 512, 3, 2, 1600), (512, 512, 3, 2, 800), (512, 512, 3, 2, 400),
               (512, 512, 3, 2, 200), (512, 512, 2, 2, 100), (512, 512, 2, 2, 50),
               (16, 16, 3, 2, 333)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 32])
@pytest.mark.parametrize("c_in, c_out, k, stride, P", CARD_SHAPES)
def test_kernel_against_float64_on_card(cuda_device, B, c_in, c_out, k, stride, P):
    x, w, b = operands(B, P, c_in, c_out, k, stride, seed=B + P + k, device=cuda_device)
    # the card convolves the batch as one sequence: a row's last output frame
    # (k > stride) reads the next row's first frames, the last row's zeros
    flat = x.reshape(1, B * stride * P, c_in)
    pair = (L.split_tf32(CV.gemm_weight(w).contiguous()), k)
    before = CV.conv_tf32x3.launches
    with pytest.raises(ValueError):  # the card takes the split operands only
        CV.conv_tf32x3(x, w, b, stride)
    for bias, gelu in ((None, False), (b, False), (b, True)):
        got = CV.conv_tf32x3(x, pair, bias, stride, gelu)
        torch.cuda.synchronize()
        assert got.shape == (B, P, c_out)
        err = scaled_error(got.reshape(1, B * P, c_out), flat, w, bias, stride, gelu)
        assert err < TOL, (bias is not None, gelu, err)
    assert CV.conv_tf32x3.launches == before + 3
    big = lambda t: L.split_tf32(t)[0]  # noqa: E731
    assert scaled_error(CV._plain(big(flat), big(w), b, stride, False), flat, w, b,
                        stride) > TOL  # one TF32 pass


@pytest.mark.cuda
def test_first_conv_and_channels_last_on_card(cuda_device):
    g = torch.Generator().manual_seed(8)
    audio = torch.randn(32, 16000, generator=g).to(cuda_device)
    w = torch.randn(512, 1, 10, generator=g).to(cuda_device)
    b = torch.randn(512, generator=g).to(cuda_device)
    counters = (CV.first_conv, CV.channels_last, CV.layer_norm_gelu)
    before = [f.launches for f in counters]
    for bias in (None, b):
        got = CV.first_conv(audio, w, bias, 5, 3200)
        want = CV.first_conv(audio.cpu(), w.cpu(), None if bias is None else bias.cpu(), 5, 3200)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    x = torch.randn(32, 512, 3199, generator=g).to(cuda_device)
    got = CV.channels_last(x, 3200)
    assert torch.equal(got.cpu(), CV.channels_last(x.cpu(), 3200))
    # per-frame LayerNorm + GELU: summation order and erff against torch's erf
    scale, shift = 1.0 + torch.randn(512, generator=g), torch.randn(512, generator=g)
    x = torch.randn(64, 400, 512, generator=g).to(cuda_device)
    got = CV.layer_norm_gelu(x, scale.to(cuda_device), shift.to(cuda_device))
    want = CV.layer_norm_gelu(x.cpu(), scale, shift)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert [f.launches - n for f, n in zip(counters, before)] == [2, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["base", "wavlm_large"])
def test_encoder_on_card_against_the_cpu(cuda_device, which):
    cfg = {"base": W.Wav2Vec2Config.base(), "wavlm_large": W.Wav2Vec2Config.wavlm_large()}[which]
    cfg = dataclasses.replace(cfg, conv_bias=which == "wavlm_large")  # the epilogue's bias too
    model = _model(cfg, seed=9)
    g = torch.Generator().manual_seed(9)
    audio = torch.randn(4, 16000, generator=g)
    lengths = torch.tensor([16000, 12000, 0, 8001])
    with torch.inference_mode():
        want = model(audio, lengths)
        model = model.to(cuda_device)
        counters = (CV.conv_tf32x3, CV.first_conv, CV.channels_last, CV.layer_norm_gelu,
                    L.linear_tf32x3)
        before = [f.launches for f in counters]
        got = model(audio.to(cuda_device), lengths.to(cuda_device)).cpu()
    layer_norm = cfg.feat_extract_norm == "layer"
    assert [f.launches - n for f, n in zip(counters, before)] == [
        6, int(layer_norm), int(not layer_norm), 7 * int(layer_norm), 4 * cfg.num_layers + 1]
    valid = W.feature_extractor_output_length(cfg, lengths)
    for row in range(audio.shape[0]):
        n = int(valid[row])
        a, b = got[row, :n].double(), want[row, :n].double()
        gap = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item() if n else 0.0
        assert gap < 2e-5, (which, row, gap)  # one TF32 pass: some 1e-3
