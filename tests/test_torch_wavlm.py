"""The port's WavLM path (encoders/wav2vec2.py with `feat_extract_norm="layer"`,
pre-LN layers and the gated relative position bias) against the plain
reference `tests/plain_wavlm.py` and against `transformers.WavLMModel`, on the
CPU at tiny widths with seeded weights; the HF checkpoint's loading; the
engine's chunk loop; and wav2vec2-base's path left as it was. No JAX here.

Tolerances: both sides compute in float32 on the CPU with other operation
orders (a batched GEMM against a loop over layers, another softmax), over
2-3 layers at widths 16-32: what differs is rounding, a few float32 ulps of
values of order 1, so an absolute 2e-5 on layer-normed outputs. A missing
gate, bias or norm moves them by 1e-2 or more.
"""
import dataclasses

import numpy as np
import pytest
import torch

from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
from multimodaltopicsegmentation_torch.ops import attention
from multimodaltopicsegmentation_torch.utils import profiling
import plain_wavlm  # tests/plain_wavlm.py: pytest puts this file's directory on sys.path

SR = 16000
ATOL = 2e-5

TINY = W.Wav2Vec2Config(
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32, num_layers=3,
    num_heads=4, ffn_dim=64, pos_conv_kernel=16, pos_conv_groups=2, feat_extract_norm="layer",
    do_stable_layer_norm=True, conv_bias=True, num_buckets=32, max_bucket_distance=64,
    do_normalize=True)


def hf_keys(cfg: W.Wav2Vec2Config) -> dict:
    """The port's config under HF's keys, as the plain reference reads them."""
    return {"conv_dim": list(cfg.conv_dim), "conv_kernel": list(cfg.conv_kernel),
            "conv_stride": list(cfg.conv_stride), "conv_bias": cfg.conv_bias,
            "feat_extract_norm": cfg.feat_extract_norm,
            "do_stable_layer_norm": cfg.do_stable_layer_norm, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.ffn_dim, "num_conv_pos_embeddings": cfg.pos_conv_kernel,
            "num_conv_pos_embedding_groups": cfg.pos_conv_groups,
            "layer_norm_eps": cfg.layer_norm_eps, "num_buckets": cfg.num_buckets,
            "max_bucket_distance": cfg.max_bucket_distance, "do_normalize": cfg.do_normalize}


def wavlm_state(cfg: W.Wav2Vec2Config, seed: int) -> dict:
    """Seeded weights at scales where the gate and the bias move the scores
    (bias entries of order 1, gates spread around 1.75) and the norms are no
    identity."""
    g = torch.Generator().manual_seed(seed)
    sd = W.random_state_dict(cfg, seed)
    for name, p in sd.items():
        r = torch.randn(p.shape, generator=g)
        if name.endswith("rel_attn_embed.weight"):
            sd[name] = r
        elif name.endswith("gru_rel_pos_const"):
            sd[name] = 1.0 + 0.5 * r
        elif "gru_rel_pos_linear" in name:
            sd[name] = r * (p.shape[-1] ** -0.5 if name.endswith("weight") else 0.1)
        elif "norm" in name:
            sd[name] = (1.0 if name.endswith("weight") else 0.0) + 0.1 * r
        elif name.endswith("bias"):
            sd[name] = 0.02 * r
    return sd


def _audio(rng, B, S):
    return torch.from_numpy(rng.standard_normal((B, S)).astype(np.float32))


def test_ragged_masked_batch_matches_plain_reference():
    """A padded batch of ragged rows with one zero-length row (uniform
    attention weights there on both sides), a conv bias and pre-LN layers."""
    sd = wavlm_state(TINY, 0)
    audio = _audio(np.random.default_rng(0), 4, 3200)
    lengths = torch.tensor([3200, 2100, 0, 777])
    audio[2] = 0.0
    with torch.no_grad():
        got = W.build_model(TINY, sd, "cpu")(audio, lengths)
    want = plain_wavlm.frames(sd, hf_keys(TINY), audio, lengths)
    assert got.shape == want.shape == (4, W.feature_extractor_output_length(TINY, 3200), 32)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fault", ["gate_one", "no_bias", "post_ln"])
def test_plain_reference_sees_each_mechanism(fault):
    """The comparison above is tight enough to see each WavLM mechanism:
    the reference with the gate held at 1, without P, or post-LN, moves the
    frames by far more than ATOL."""
    sd = wavlm_state(TINY, 1)
    audio = _audio(np.random.default_rng(1), 2, 3200)
    cfg = hf_keys(TINY)
    want = plain_wavlm.frames(sd, cfg, audio)
    bad = dict(sd)
    if fault == "gate_one":  # c = 0 and a = sigmoid(200) = 1: gate = a (b c - 1) + 2 = 1
        for i in range(TINY.num_layers):
            bad[f"encoder.layers.{i}.attention.gru_rel_pos_const"] = torch.zeros(1, 4, 1, 1)
            bad[f"encoder.layers.{i}.attention.gru_rel_pos_linear.weight"] = torch.zeros(8, 8)
            bad[f"encoder.layers.{i}.attention.gru_rel_pos_linear.bias"] = torch.full((8,), 50.0)
    elif fault == "no_bias":
        bad["encoder.layers.0.attention.rel_attn_embed.weight"] = torch.zeros(32, 4)
    else:
        cfg = dict(cfg, do_stable_layer_norm=False)
    assert (plain_wavlm.frames(bad, cfg, audio) - want).abs().max() > 1e3 * ATOL


def _hf_model(cfg: W.Wav2Vec2Config, seed: int):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WavLMConfig(
        conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), num_feat_extract_layers=len(cfg.conv_dim),
        conv_bias=cfg.conv_bias, feat_extract_norm=cfg.feat_extract_norm,
        do_stable_layer_norm=cfg.do_stable_layer_norm, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.ffn_dim, num_conv_pos_embeddings=cfg.pos_conv_kernel,
        num_conv_pos_embedding_groups=cfg.pos_conv_groups, num_buckets=cfg.num_buckets,
        max_bucket_distance=cfg.max_bucket_distance, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0, hidden_act="gelu",
        apply_spec_augment=False)
    torch.manual_seed(seed)
    hf = transformers.WavLMModel(hf_cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # HF's init leaves the bias near 0 and every gate's constant at 1
        for name, p in hf.named_parameters():
            if name.endswith("rel_attn_embed.weight"):
                p.copy_(torch.randn(p.shape, generator=g))
            elif name.endswith("gru_rel_pos_const"):
                p.copy_(1.0 + 0.5 * torch.randn(p.shape, generator=g))
            elif "layer_norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return hf


@pytest.mark.parametrize("pre_ln", [True, False])
def test_matches_hf_wavlm(pre_ln):
    """HF's WavLMModel (random init, no download) over a ragged batch: every
    valid frame. Zero-length rows are left out (HF gives NaN there)."""
    cfg = dataclasses.replace(TINY, do_stable_layer_norm=pre_ln, do_normalize=False)
    hf = _hf_model(cfg, 2)
    audio = _audio(np.random.default_rng(2), 3, 3200)
    lengths = torch.tensor([3200, 1900, 2500])
    for b, n in enumerate(lengths):
        audio[b, n:] = 0.0
    mask = (torch.arange(3200)[None] < lengths[:, None]).long()
    sd = W.load_hf_state_dict(hf.state_dict(), cfg)
    with torch.no_grad():
        want = hf(audio, attention_mask=mask).last_hidden_state
        got = W.build_model(cfg, sd, "cpu")(audio, lengths)
    plain = plain_wavlm.frames(sd, hf_keys(cfg), audio, lengths)
    T = W.feature_extractor_output_length(cfg, lengths)
    for b in range(3):
        torch.testing.assert_close(got[b, : T[b]], want[b, : T[b]], rtol=0, atol=ATOL)
        torch.testing.assert_close(plain[b, : T[b]], want[b, : T[b]], rtol=0, atol=ATOL)


def test_load_pretrained_reads_the_checkpoints_config(tmp_path, monkeypatch):
    """`save_pretrained`'s directory (config.json beside model.safetensors)
    gives WavLM's config and state dict, through `load_pretrained` and through
    the engine `predict -ee --wav2vec` builds."""
    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder

    hf = _hf_model(TINY, 3)
    hf.save_pretrained(tmp_path)
    sd, cfg = W.load_pretrained(str(tmp_path))
    assert cfg == dataclasses.replace(TINY, num_groupnorm_groups=16)
    want = W.load_hf_state_dict(hf.state_dict(), cfg)
    assert sd.keys() == want.keys()
    assert "encoder.layers.0.attention.rel_attn_embed.weight" in sd
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    monkeypatch.setenv("MTS_WAV2VEC2_WEIGHTS", str(tmp_path))
    enc = Wav2Vec2Encoder(device="cpu")
    assert enc.cfg == cfg and enc.dim == 32


def test_config_from_hf_keys():
    wavlm_large = {"model_type": "wavlm", "conv_dim": [512] * 7,
                   "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
                   "conv_bias": False, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
                   "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
                   "intermediate_size": 4096, "num_conv_pos_embeddings": 128,
                   "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5,
                   "num_buckets": 320, "max_bucket_distance": 800, "hidden_act": "gelu",
                   "feat_extract_activation": "gelu"}
    assert W.Wav2Vec2Config.from_hf(wavlm_large) == W.Wav2Vec2Config.wavlm_large()
    base = {"model_type": "wav2vec2", "conv_dim": [512] * 7, "feat_extract_norm": "group",
            "do_stable_layer_norm": False}
    assert W.Wav2Vec2Config.from_hf(base) == W.Wav2Vec2Config.base()
    with pytest.raises(ValueError, match="model_type"):
        W.Wav2Vec2Config.from_hf({"model_type": "hubert"})
    with pytest.raises(ValueError, match="gelu"):
        W.Wav2Vec2Config.from_hf(dict(wavlm_large, hidden_act="relu"))
    with pytest.raises(ValueError, match="feat_extract_norm"):
        W.Wav2Vec2Config(feat_extract_norm="batch")


def _encoder(cfg, sd):
    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder

    enc = Wav2Vec2Encoder.__new__(Wav2Vec2Encoder)
    enc.device, enc.cfg = torch.device("cpu"), cfg
    enc.model = W.build_model(cfg, sd, enc.device)
    return enc


def test_encode_document_ragged_units_equal_one_at_a_time():
    """The engine's chunks (padded to one bucketed length, the tail chunk
    row-padded) give each unit the frames of its own solo forward."""
    enc = _encoder(TINY, wavlm_state(TINY, 4))
    rng = np.random.default_rng(4)
    cuts = np.cumsum(rng.integers(300, 4000, size=7))
    audio = rng.standard_normal(int(cuts[-1])).astype(np.float32)
    bounds = [(int(a), int(b)) for a, b in zip(np.concatenate([[0], cuts[:-1]]), cuts)]
    got = enc.encode_document(audio, bounds, chunk=3)
    assert len(got) == len(bounds)
    for (s, e), frames in zip(bounds, got):
        with torch.no_grad():
            solo = enc.model(torch.from_numpy(audio[s:e])[None])[0].numpy()
        assert frames.shape == solo.shape
        np.testing.assert_allclose(frames, solo, rtol=0, atol=ATOL)


def test_buckets_match_hf_wavlm():
    """`ops.attention.t5_relative_bucket` and the plain reference's buckets
    against HF WavLM's `_relative_positions_bucket`, offsets -4000..4000, at
    WavLM-Large's 320 buckets and distance 800 and at the tests' 32 and 64."""
    pytest.importorskip("transformers")
    from transformers.models.wavlm.modeling_wavlm import WavLMAttention

    rel = torch.arange(-4000, 4001)
    for buckets, distance in ((320, 800), (32, 64)):
        hf = WavLMAttention(16, 2, num_buckets=buckets, max_distance=distance)
        want = hf._relative_positions_bucket(rel)
        assert torch.equal(attention.t5_relative_bucket(rel, buckets, distance), want)
        assert torch.equal(plain_wavlm.bucket(rel, buckets, distance), want)
        assert int(want.max()) == buckets - 1 and int(want.min()) == 0


def test_wav2vec2_base_path_is_untouched(monkeypatch):
    """The group-norm config with one group per channel (wav2vec2-base's
    geometry) calls K1 once a chunk, as before, and builds no relative bias:
    no bucket, no rel_bias or gate span, no gate parameter."""
    monkeypatch.setenv("MTS_PROFILE", "1")
    profiling.reset()
    cfg = dataclasses.replace(W.Wav2Vec2Config.tiny(), num_groupnorm_groups=16)
    enc = _encoder(cfg, W.random_state_dict(cfg, 0))
    calls = []
    real = W.instance_norm_gelu
    monkeypatch.setattr(W, "instance_norm_gelu",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    audio = np.random.default_rng(5).standard_normal(6 * SR + SR // 2).astype(np.float32)
    enc.encode_document(audio, [(i * SR, (i + 1) * SR) for i in range(6)], chunk=4)
    assert len(calls) == 2  # two chunks
    assert enc.model._buckets == {}
    assert not any("gru" in k or "rel_attn" in k for k in enc.model.state_dict())
    names = [r.name for r in profiling.spans()]
    assert names.count("encode_document.forward.features") == 2
    assert not any(n.endswith((".rel_bias", ".gate")) for n in names)
    profiling.reset()


def test_relative_bias_buckets_are_cached_per_length():
    model = W.build_model(TINY, wavlm_state(TINY, 6), "cpu")
    with torch.no_grad():
        model(_audio(np.random.default_rng(6), 2, 3200))
        model(_audio(np.random.default_rng(7), 3, 3200))
        model(_audio(np.random.default_rng(8), 1, 1600))
    T1, T2 = (W.feature_extractor_output_length(TINY, n) for n in (3200, 1600))
    assert sorted(k[0] for k in model._buckets) == sorted([T1, T2])
    P = model.relative_bias(T1, "cpu")
    assert P.shape == (4, T1, T1)
    # P[h, i, j] = rel_attn_embed[bucket(j - i), h]
    table = model.encoder.layers[0].attention.rel_attn_embed.weight
    i, j = 3, T1 - 1
    assert torch.equal(P[:, i, j], table[plain_wavlm.bucket(torch.tensor(j - i), 32, 64)])


def test_train_fit_takes_the_width_of_a_wavlm_folder(tmp_path, monkeypatch):
    """`train_fit -enc wav2vec` over a folder of 1024-wide (WavLM-Large)
    unit embeddings builds its tagger at 1024, the folder's width, where the
    encoder name's table says 768."""
    from multimodaltopicsegmentation_torch.cli import train_fit
    from multimodaltopicsegmentation_torch.train import loop
    from synth import make_synthetic_corpus

    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=6,
                                                     dim=1024, min_units=10, max_units=16)
    widths = []
    build = loop.Trainer._build
    monkeypatch.setattr(loop.Trainer, "_build",
                        lambda self: widths.append(self.cfg.embedding_dim) or build(self))
    cwd = str(tmp_path)
    monkeypatch.chdir(cwd)
    train_fit.cli_main(["-arc", "BiLSTM", "-enc", "wav2vec", "-ef", emb_dir, "-lf", lab_file,
                        "-split", split, "-lr", "1e-2", "-hu", "8", "-nl", "1", "-bs", "4",
                        "-max", "1", "-pat", "1", "-loss", "FocalLoss", "-exp",
                        str(tmp_path / "exp"), "--device", "cpu"])
    assert train_fit.infer_embedding_dim("wav2vec") == 768
    assert widths and set(widths) == {1024}
