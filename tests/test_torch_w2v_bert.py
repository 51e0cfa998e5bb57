"""The port's w2v-BERT 2.0 (encoders/w2v_bert.py over dsp/kaldi_fbank.py)
against the benchmark's plain reference (benchmark/reference/w2v_bert.py),
and that reference against `transformers`' `SeamlessM4TFeatureExtractor` and
`Wav2Vec2BertModel` (random init, no download), on the CPU at tiny widths with
seeded weights; the HF checkpoint's loading; the engine's chunk loop; the
spans; a planted fault per mechanism; and, marked `cuda`, the published
widths on the card against the CPU.

Tolerances. The port and the reference both compute in float32 on the CPU,
the same equations in other operation orders (a batched gather of q E^T
against an einsum over [T, T, Dh], pointwise convolutions as linears, masked
sums against per-utterance statistics): a few float32 ulps of values of
order 1, so a worst row's relative L2 gap of 1e-5 (`gap`, the benchmark's
measure) on the normalised features and on the layer-normed outputs, where
single elements stray up to 1e-5 absolute. HF's front end runs in float64
with the FFT rounded to complex64; the float32 one lies some 5e-5 from it
(the lowest mel bins, which the preemphasis leaves 30 dB under the rest,
carry the FFT's rounding of the whole frame), so 2e-4 absolute there. A
missing mechanism moves the outputs by 1e-2 or more.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from multimodaltopicsegmentation_torch.dsp import kaldi_fbank
from multimodaltopicsegmentation_torch.encoders import w2v_bert as B
from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
from multimodaltopicsegmentation_torch.ops import linear_tf32x3 as L
from multimodaltopicsegmentation_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmark"))
from reference import w2v_bert as R  # noqa: E402

SR = 16000
GAP = 1e-5
HF_FEATURES_ATOL = 2e-4
TINY = B.W2VBertConfig.tiny()  # left 6, right 2: the clamp bites at 49 frames
# three units padded to one second: 98 frames (49 rows), 49 frames (odd: 24
# valid rows, the 49th frame in the statistics only), 75 frames (37 rows)
LENGTHS = (16000, 8100, 12345)


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's ||got - want|| / ||want|| over the last axis."""
    a, b = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()


def hf_keys(cfg: B.W2VBertConfig) -> dict:
    """The port's config under HF's keys, as the reference reads them."""
    return {"hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.ffn_dim,
            "feature_projection_input_dim": cfg.feature_dim,
            "conv_depthwise_kernel_size": cfg.conv_kernel,
            "left_max_position_embeddings": cfg.left_max_position,
            "right_max_position_embeddings": cfg.right_max_position,
            "layer_norm_eps": cfg.layer_norm_eps}


def seeded_state(cfg: B.W2VBertConfig, seed: int) -> dict:
    """The port's state dict with every leaf drawn: norms around ones and
    zeros (std 0.1), biases of std 0.1, weights of std fan_in ** -0.5, the
    distance table of std 1 (the relative term as large as q k^T)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in B.random_state_dict(cfg, seed).items():
        r = torch.randn(p.shape, generator=g)
        if "norm" in name:
            sd[name] = (1.0 if name.endswith("weight") else 0.0) + 0.1 * r
        elif name.endswith("bias"):
            sd[name] = 0.1 * r
        elif name.endswith("distance_embedding.weight"):
            sd[name] = r
        else:
            sd[name] = r * p[0].numel() ** -0.5
    return sd


def hf_layout(sd: dict) -> dict:
    """The port's state dict in HF's shapes: the pointwise convolutions'
    weights [out, in, 1]."""
    return {k: v[..., None] if "pointwise_conv" in k else v for k, v in sd.items()}


def batch(seed: int, lengths=LENGTHS):
    """Utterances of `lengths` samples, and their zero-padded [B, S] batch."""
    rng = np.random.default_rng(seed)
    waves = [torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.3) for n in lengths]
    audio = torch.zeros(len(waves), max(lengths))
    for b, w in enumerate(waves):
        audio[b, :len(w)] = w
    return waves, audio, torch.tensor(lengths)


def test_fbank_matches_reference():
    waves, audio, lengths = batch(0)
    rows, valid, n_frames = kaldi_fbank.seamless_features(audio, lengths)
    want, mask = R.features(waves)
    assert rows.shape == want.shape == (3, 49, 160) and n_frames == 3 * 98
    assert valid.tolist() == [49, 24, 37] == mask.sum(1).int().tolist()
    for b, n in enumerate(valid.tolist()):
        assert gap(rows[b, :n], want[b, :n]) < GAP
    assert B.output_length(torch.tensor(LENGTHS)).tolist() == [49, 24, 37]
    assert [B.output_length(n) for n in (0, 399, 400, 559, 560, 16000)] == [0, 0, 0, 0, 1, 49]


def test_forward_matches_reference_on_every_row():
    """A padded batch with an odd frame count: every row, valid and padded
    (HF computes the padded ones too: they read the valid ones as keys)."""
    sd = seeded_state(TINY, 1)
    waves, audio, lengths = batch(1)
    with torch.no_grad():
        got = B.build_model(TINY, sd, "cpu")(audio, lengths)
    want, mask = R.frames(hf_layout(sd), hf_keys(TINY), waves)
    assert got.shape == want.shape == (3, 49, TINY.hidden_size)
    assert gap(got, want) < GAP


def _clamp_wraps(T, left, right, device=None):
    pos = torch.arange(T, device=device)
    return (pos[None, :] - pos[:, None] + left) % (left + right + 1)


def _non_causal(x, weight):
    k = weight.shape[-1]
    y = torch.nn.functional.conv1d(torch.nn.functional.pad(x.transpose(1, 2), (k // 2, k // 2)),
                                   weight, groups=weight.shape[0])
    return y.transpose(1, 2)


def _plant(monkeypatch, fault):
    if fault == "full_ffn_residual":
        monkeypatch.setattr(B._ConformerLayer, "ffn_scale", 1.0)
    elif fault == "no_clamp":
        monkeypatch.setattr(B, "relative_key_index", _clamp_wraps)
    elif fault == "centred_pad":
        monkeypatch.setattr(B, "causal_depthwise_conv", _non_causal)
    elif fault == "no_conv_mask":
        real = B._ConvModule.forward
        monkeypatch.setattr(B._ConvModule, "forward",
                            lambda self, x, fmask: real(self, x, torch.ones_like(fmask)))


@pytest.mark.parametrize("fault", ["full_ffn_residual", "no_clamp", "centred_pad", "no_conv_mask"])
def test_each_planted_fault_fails_the_comparison(monkeypatch, fault):
    """The FFNs' half step, the distance clamp, the causal pad and the mask
    before the depthwise conv, each broken in the port. The mask reaches only
    the padded rows (the conv is causal and the padding at each row's end),
    which the comparison holds too."""
    sd = seeded_state(TINY, 2)
    waves, audio, lengths = batch(2)
    want, _ = R.frames(hf_layout(sd), hf_keys(TINY), waves)
    _plant(monkeypatch, fault)
    with torch.no_grad():
        got = B.build_model(TINY, sd, "cpu")(audio, lengths)
    assert gap(got, want) > 1e3 * GAP


def test_encode_document_units_match_reference():
    """The engine's chunks (2 rows; the documents's lengths padded to one
    bucketed length, the tail chunk row-padded) give each unit, a short tail
    among them, the valid frames of its own reference forward."""
    sd = seeded_state(TINY, 3)
    enc = Wav2Vec2Encoder.from_state(TINY, sd, "cpu")
    assert isinstance(enc.model, B.W2VBert) and enc.dim == TINY.hidden_size
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(4 * SR + 5000) * 0.3).astype(np.float32)
    bounds = [(i * SR, (i + 1) * SR) for i in range(4)] + [(4 * SR, 4 * SR + 5000)]
    got = enc.encode_document(audio, bounds, chunk=2)
    assert [g.shape[0] for g in got] == [49] * 4 + [B.output_length(5000)]
    for (s, e), frames in zip(bounds, got):
        want, _ = R.frames(hf_layout(sd), hf_keys(TINY), [torch.from_numpy(audio[s:e])])
        assert gap(torch.from_numpy(frames), want[0, :frames.shape[0]]) < GAP


def test_wav2vec2_encoders_keep_their_model_and_frames():
    cfg = W.Wav2Vec2Config.tiny()
    enc = Wav2Vec2Encoder.from_state(cfg, W.random_state_dict(cfg, 0), "cpu")
    assert type(enc.model) is W.Wav2Vec2
    for n in (400, 16000, 12345):
        assert enc.frames(n) == W.feature_extractor_output_length(cfg, n)


def test_forward_spans_nest_under_forward(monkeypatch):
    """Inside each `encode_document.forward`: the fbank and projection span
    (its frames), then per layer the relative-key span (the table's rows)
    and the conv module's (the chunk's frames). The tail chunk of one unit is
    row-padded to the chunk's 2 rows."""
    monkeypatch.setenv("MTS_PROFILE", "1")
    profiling.reset()
    enc = Wav2Vec2Encoder.from_state(TINY, seeded_state(TINY, 4), "cpu")
    audio = np.random.default_rng(4).standard_normal(3 * SR).astype(np.float32)
    enc.encode_document(audio, [(i * SR, (i + 1) * SR) for i in range(3)], chunk=2)
    records = profiling.spans()
    forwards = [i for i, r in enumerate(records) if r.name == "encode_document.forward"]
    assert len(forwards) == 2
    rows = 2
    for f in forwards:
        inner = [r for r in records if r.parent == f]
        assert [r.name for r in inner] == ["encode_document.forward.features"] + [
            "encode_document.forward.rel_key", "encode_document.forward.conv_module"
        ] * TINY.num_layers
        assert inner[0].counts == {"fbank_frames": rows * 98}
        distances = TINY.left_max_position + TINY.right_max_position + 1
        assert all(r.counts == {"distances": distances} for r in inner[1::2])
        assert all(r.counts == {"frames": rows * 49} for r in inner[2::2])
    profiling.reset()


# -- the published code ---------------------------------------------------------------

def hf_model(cfg: B.W2VBertConfig, seed: int):
    """HF's Wav2Vec2BertModel at `cfg`, its parameters redrawn as
    `seeded_state` draws the port's (HF's 0.02 init would leave the FFNs and
    the relative term nearly idle)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2BertConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.ffn_dim,
        conv_depthwise_kernel_size=cfg.conv_kernel,
        left_max_position_embeddings=cfg.left_max_position,
        right_max_position_embeddings=cfg.right_max_position, mask_time_prob=0.0)
    model = transformers.Wav2Vec2BertModel(hf_cfg).eval()
    port = hf_layout(seeded_state(cfg, seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(port[name])
    return model


def test_reference_matches_hf():
    """SeamlessM4TFeatureExtractor's features and masks (a batch with an odd
    frame count and padding) against the reference's, then HF's model and
    the reference's encoder on those same features: every row."""
    transformers = pytest.importorskip("transformers")
    waves, _, _ = batch(5)
    fe = transformers.SeamlessM4TFeatureExtractor()
    want = fe([w.numpy() for w in waves], sampling_rate=SR, return_tensors="pt")
    rows, mask = R.features(waves)
    assert torch.equal(mask.long(), want["attention_mask"].long())
    valid = mask.bool()
    torch.testing.assert_close(rows[valid], want["input_features"][valid], rtol=0,
                               atol=HF_FEATURES_ATOL)
    model = hf_model(TINY, 5)
    with torch.no_grad():
        hf = model(want["input_features"], attention_mask=want["attention_mask"]).last_hidden_state
    ref = R.encoder(model.state_dict(), hf_keys(TINY), want["input_features"],
                    want["attention_mask"].float())
    assert gap(ref, hf) < GAP


def test_load_hf_state_dict_and_pretrained(tmp_path, monkeypatch):
    """HF's state_dict under the port's names (pointwise weights squeezed),
    and `save_pretrained`'s directory (config.json of model_type
    "wav2vec2-bert" beside model.safetensors) through `load_pretrained` and
    the engine `predict -ee --wav2vec` builds."""
    model = hf_model(TINY, 6)
    sd = B.load_hf_state_dict(model.state_dict(), TINY)
    want = seeded_state(TINY, 6)
    assert sd.keys() == want.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    model.save_pretrained(tmp_path)
    loaded, cfg = W.load_pretrained(str(tmp_path))
    assert cfg == TINY
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)
    monkeypatch.setenv("MTS_WAV2VEC2_WEIGHTS", str(tmp_path))
    enc = Wav2Vec2Encoder(device="cpu")
    assert enc.cfg == TINY and isinstance(enc.model, B.W2VBert) and enc.dim == 32
    waves, audio, lengths = batch(6)
    with torch.no_grad():
        got = enc.model(audio, lengths)
    ref, _ = R.frames(model.state_dict(), hf_keys(TINY), waves)
    assert gap(got, ref) < GAP


def test_config_from_hf_keys():
    published = {"model_type": "wav2vec2-bert", "hidden_size": 1024, "num_hidden_layers": 24,
                 "num_attention_heads": 16, "intermediate_size": 4096, "hidden_act": "swish",
                 "feature_projection_input_dim": 160, "conv_depthwise_kernel_size": 31,
                 "position_embeddings_type": "relative_key", "left_max_position_embeddings": 64,
                 "right_max_position_embeddings": 8, "layer_norm_eps": 1e-5, "add_adapter": False}
    assert B.W2VBertConfig.from_hf(published) == B.W2VBertConfig()
    for bad, match in ((dict(published, model_type="wav2vec2"), "model_type"),
                       (dict(published, hidden_act="gelu"), "swish"),
                       (dict(published, position_embeddings_type="rotary"), "relative_key"),
                       (dict(published, add_adapter=True), "adapter"),
                       (dict(published, feature_projection_input_dim=80), "160|bins")):
        with pytest.raises(ValueError, match=match):
            B.W2VBertConfig.from_hf(bad)
    with pytest.raises(ValueError, match="model_type"):
        W.Wav2Vec2Config.from_hf(published)


# -- the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_published_widths_on_card_match_the_cpu(cuda_device):
    """w2v-BERT 2.0 at its published widths (24 layers of 1024) on the card,
    every dense product on the 3xTF32 kernel (8 L + 1 launches), against the
    CPU's float32 forward: six 1-s units and a short one, every valid row."""
    cfg = B.W2VBertConfig()
    sd = B.random_state_dict(cfg, seed=11)
    g = torch.Generator().manual_seed(11)
    for name in sd:  # biases not zero, so the epilogue's add shows
        if name.endswith("bias") and "norm" not in name:
            sd[name] = 0.1 * torch.randn(sd[name].shape, generator=g)
    audio = 0.3 * torch.randn(7, SR, generator=g)
    lengths = torch.tensor([SR] * 6 + [9000])
    with torch.no_grad():
        want = B.build_model(cfg, sd, "cpu")(audio, lengths)
    model = B.build_model(cfg, sd, cuda_device)
    before = L.linear_tf32x3.launches
    with torch.inference_mode():
        got = model(audio.to(cuda_device), lengths.to(cuda_device)).cpu()
    assert L.linear_tf32x3.launches - before == 8 * cfg.num_layers + 1
    for row, n in enumerate(B.output_length(lengths).tolist()):
        a, b = got[row, :n].double(), want[row, :n].double()
        gap = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
        assert gap < 2e-5, (row, gap)  # one TF32 pass: some 1e-3
