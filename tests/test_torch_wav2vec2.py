"""Port wav2vec2 (encoders/wav2vec2.py) against the JAX package's `apply`.

The same numpy-seeded audio goes through both; the JAX random parameters are
carried into the port with `from_jax_params`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.encoders import wav2vec2 as JW
from multimodaltopicsegmentation_torch.encoders import wav2vec2 as TW


def _port_model(jax_params, jcfg):
    cfg = TW.Wav2Vec2Config(**{f.name: getattr(jcfg, f.name)
                               for f in JW.Wav2Vec2Config.__dataclass_fields__.values()})
    return TW.build_model(cfg, TW.from_jax_params(jax.tree.map(np.asarray, jax_params), cfg),
                          "cpu")


@pytest.mark.parametrize("stacked", [True, False])
def test_tiny_matches_jax(stacked):
    """Masked ragged batch plus one zero-length row, from stacked and
    per-layer JAX storage."""
    jcfg = JW.Wav2Vec2Config.tiny()
    params = JW.init_params(jax.random.PRNGKey(0), jcfg, stacked=stacked)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((4, 1600)).astype(np.float32)
    lengths = np.array([1600, 1000, 0, 401], np.int32)
    audio[2] = 0.0
    want = np.asarray(JW.apply(params, jcfg, jnp.asarray(audio), jnp.asarray(lengths)))
    with torch.no_grad():
        got = _port_model(params, jcfg)(torch.from_numpy(audio), torch.from_numpy(lengths))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_tiny_unmasked_and_output_length():
    jcfg = JW.Wav2Vec2Config.tiny()
    params = JW.init_params(jax.random.PRNGKey(1), jcfg, stacked=True)
    audio = np.random.default_rng(1).standard_normal((2, 1200)).astype(np.float32)
    want = np.asarray(JW.apply(params, jcfg, jnp.asarray(audio)))
    with torch.no_grad():
        got = _port_model(params, jcfg)(torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for n in (0, 9, 400, 1600, 3171):
        assert TW.feature_extractor_output_length(TW.Wav2Vec2Config.tiny(), n) == \
            JW.feature_extractor_output_length(jcfg, n)
        assert int(TW.feature_extractor_output_length(TW.Wav2Vec2Config.base(), torch.tensor(n))) \
            == JW.feature_extractor_output_length(JW.Wav2Vec2Config.base(), n)


def test_base_width_matches_jax():
    """wav2vec2-base geometry (7x512 conv, 768 hidden, 12 layers), the layer-0
    norm through ops/instance_norm_gelu: 2 rows of 1 s, one padded."""
    jcfg = JW.Wav2Vec2Config.base()
    params = JW.init_params(jax.random.PRNGKey(0), jcfg, stacked=False)
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((2, 16000)).astype(np.float32)
    lengths = np.array([16000, 11000], np.int32)
    audio[1, 11000:] = 0.0
    want = np.asarray(jax.jit(lambda p, a, l: JW.apply(p, jcfg, a, l))(
        params, jnp.asarray(audio), jnp.asarray(lengths)))
    with torch.no_grad():
        got = _port_model(params, jcfg)(torch.from_numpy(audio), torch.from_numpy(lengths))
    assert got.shape == want.shape == (2, 49, 768)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_random_init_is_seeded():
    cfg = TW.Wav2Vec2Config.tiny()
    a, b = TW.random_state_dict(cfg, 3), TW.random_state_dict(cfg, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layers.0.attention.q_proj.weight"],
                           TW.random_state_dict(cfg, 4)["encoder.layers.0.attention.q_proj.weight"])


def test_load_hf_state_dict_matches_hf_model():
    pytest.importorskip("transformers")
    from transformers import Wav2Vec2Config as HFConfig, Wav2Vec2Model

    cfg = TW.Wav2Vec2Config(**{**TW.Wav2Vec2Config.tiny().__dict__,
                               "num_groupnorm_groups": 16, "do_normalize": False})
    hf_cfg = HFConfig(
        conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), num_feat_extract_layers=len(cfg.conv_dim),
        num_conv_pos_embeddings=cfg.pos_conv_kernel,
        num_conv_pos_embedding_groups=cfg.pos_conv_groups, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.ffn_dim, feat_extract_norm="group", do_stable_layer_norm=False,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, hidden_act="gelu",
    )
    torch.manual_seed(0)
    hf = Wav2Vec2Model(hf_cfg).eval()
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1600)).astype(np.float32))
    with torch.no_grad():
        want = hf(audio).last_hidden_state
        got = TW.build_model(cfg, TW.load_hf_state_dict(hf.state_dict(), cfg), "cpu")(audio)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


def test_engine_ragged_units_match_jax(monkeypatch):
    """Ragged units (sample-bucketed) in chunks whose tail is row-padded:
    the port engine gives the JAX engine's frames."""
    from multimodaltopicsegmentation_tpu.encoders.engine import Wav2Vec2Encoder as JaxEncoder
    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder

    jcfg = JW.Wav2Vec2Config.tiny()
    params = JW.init_params(jax.random.PRNGKey(0), jcfg)
    jenc = JaxEncoder.__new__(JaxEncoder)
    jenc.cfg, jenc.params, jenc._W = jcfg, params, JW
    jenc._apply = jax.jit(lambda p, a, l: JW.apply(p, jcfg, a, l))

    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    monkeypatch.setattr(TW.Wav2Vec2Config, "base", classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(TW, "random_state_dict", lambda cfg, seed=0: TW.from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    enc = Wav2Vec2Encoder(device="cpu")

    audio = np.random.default_rng(4).standard_normal(4000).astype(np.float32)
    bounds = [(0, 1000), (1000, 2500), (2500, 4000)]
    want = jenc.encode_document(audio, bounds, chunk=2)
    for chunk in (2, 8):
        got = enc.encode_document(audio, bounds, chunk=chunk)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4)


def test_engine_weights_env_wins_over_random(tmp_path, monkeypatch):
    """MTS_WAV2VEC2_WEIGHTS (a local HF checkpoint directory, weight-normed
    positional conv) beats MTS_RANDOM_ENCODER_WEIGHTS=1."""
    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder

    cfg = TW.Wav2Vec2Config.tiny()
    sd = TW.random_state_dict(cfg, seed=7)
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    hf = {f"wav2vec2.{k}": v for k, v in sd.items()}
    hf["wav2vec2.encoder.pos_conv_embed.conv.weight_v"] = 3.0 * w
    hf["wav2vec2.encoder.pos_conv_embed.conv.weight_g"] = torch.sqrt(
        torch.sum(w ** 2, dim=(0, 1), keepdim=True))
    torch.save(hf, tmp_path / "pytorch_model.bin")
    monkeypatch.setenv("MTS_WAV2VEC2_WEIGHTS", str(tmp_path))
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    monkeypatch.setattr(TW.Wav2Vec2Config, "base", classmethod(lambda cls: cls.tiny()))
    got = Wav2Vec2Encoder(device="cpu").model.state_dict()
    torch.testing.assert_close(got["encoder.pos_conv_embed.conv.weight"], w)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
