"""The port's predict slice as a whole against the JAX package: both
packages' extract (--wav2vec) and predict CLIs on the same synthetic wavs,
with the same weights.

A tiny wav2vec2 geometry, per-channel layer-0 norm as in wav2vec2-base (so
the port goes through ops/instance_norm_gelu), is injected into both
packages' random-weight mode, and the JAX random weights are carried into
the port with `from_jax_params`. The BiLSTM checkpoint is written by the
JAX package. The `_mean` embeddings agree within 1e-4 and `results.pkl` and
the segment wavs are identical.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest

import jax

from multimodaltopicsegmentation_tpu.encoders import wav2vec2 as JW
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.models.taggers import BiLSTMTagger as JaxBiLSTM
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_torch.encoders import wav2vec2 as TW
from multimodaltopicsegmentation_torch.utils.audio import save_wav

SR = 16000


def _write_wavs(audio_dir, seconds=(7.4, 11.0), seed=0):
    """Topic-like tone changes plus noise."""
    rng = np.random.default_rng(seed)
    os.makedirs(audio_dir)
    for d, dur in enumerate(seconds):
        t = np.arange(int(dur * SR)) / SR
        tone = np.where(t < dur / 2, 180.0, 330.0 + 40.0 * d)
        sig = 0.4 * np.sin(2 * np.pi * tone * t) + 0.05 * rng.standard_normal(len(t))
        save_wav(os.path.join(audio_dir, f"doc{d}.wav"), sig.astype(np.float32), SR)


@pytest.fixture
def same_weights(monkeypatch):
    """Both packages' MTS_RANDOM_ENCODER_WEIGHTS mode builds the same tiny
    wav2vec2; -> its config."""
    jcfg = dataclasses.replace(JW.Wav2Vec2Config.tiny(), num_groupnorm_groups=16)
    tcfg = TW.Wav2Vec2Config(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, JW.init_params(jax.random.PRNGKey(0), jcfg, stacked=True))
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    monkeypatch.delenv("MTS_WAV2VEC2_WEIGHTS", raising=False)
    monkeypatch.setattr(JW.Wav2Vec2Config, "base", classmethod(lambda cls: jcfg))
    monkeypatch.setattr(TW.Wav2Vec2Config, "base", classmethod(lambda cls: tcfg))
    monkeypatch.setattr(TW, "random_state_dict", lambda cfg, seed=0: TW.from_jax_params(params, cfg))
    # the JAX predict decodes on a single device, as on one chip
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    return jcfg


def _checkpoint(tmp_path, embedding_dim):
    cfg = JaxTaggerConfig(embedding_dim=embedding_dim, hidden_dim=8, num_layers=2,
                          loss_fn="FocalLoss")
    params = jax.tree.map(np.asarray, JaxBiLSTM(cfg).init(jax.random.PRNGKey(3)))
    params["cls"]["w"] = params["cls"]["w"] * 30.0  # spread the scores: some boundaries
    path = str(tmp_path / "ckpt" / "best_model")
    jax_ckpt.save(path, params, cfg, "BiLSTM")
    hyp = tmp_path / "results.txt"
    hyp.write_text("Sentence encoder: wav2vec_mean\nNeural architecture: BiLSTM\n"
                   "Hidden units: 8\nNumber of layers: 2\n")
    return path, str(hyp)


def _outputs(exp):
    with open(os.path.join(exp, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    seg_dir = os.path.join(exp, "audio_segments")
    return results, sorted(os.listdir(seg_dir))


def test_predict_cli_matches_jax(tmp_path, same_weights):
    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    audio_dir = str(tmp_path / "audio")
    _write_wavs(audio_dir)
    ckpt, hyp = _checkpoint(tmp_path, same_weights.hidden_size)
    common = ["-ee", "-hyp", hyp, "-model", ckpt, "-af", audio_dir, "-ui", "1.0", "-th", "0.5"]
    jax_predict(common + ["-ef", str(tmp_path / "jemb"), "-exp", str(tmp_path / "jexp")])
    torch_predict(common + ["-ef", str(tmp_path / "temb"), "-exp", str(tmp_path / "texp"),
                            "--device", "cpu"])

    for doc in ("doc0.npy", "doc1.npy"):
        want = np.load(tmp_path / "jemb" / "_mean" / doc)
        got = np.load(tmp_path / "temb" / "_mean" / doc)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-4)
    for variant in ("_max", "_mean_std", "_max_std", "_last", "_delta_gap"):
        np.testing.assert_allclose(np.load(tmp_path / "temb" / variant / "doc1.npy"),
                                   np.load(tmp_path / "jemb" / variant / "doc1.npy"), atol=1e-4)

    j_results, j_wavs = _outputs(str(tmp_path / "jexp"))
    t_results, t_wavs = _outputs(str(tmp_path / "texp"))
    assert t_results == j_results
    assert any(sum(tags) for tags in t_results.values())  # boundaries were found
    assert t_wavs == j_wavs and t_wavs


def test_predict_cli_refuses_missing_cuda(tmp_path, same_weights):
    """Without a card the default device raises; it does not fall back."""
    import torch
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ckpt, hyp = _checkpoint(tmp_path, same_weights.hidden_size)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_predict(["-ef", str(tmp_path / "e"), "-hyp", hyp, "-model", ckpt,
                       "-exp", str(tmp_path / "x")])


def test_segment_audio_matches_jax():
    from multimodaltopicsegmentation_tpu.cli.predict import BasePredictor as JaxBase
    from multimodaltopicsegmentation_torch.cli.predict import BasePredictor

    audio = np.zeros(SR * 7 + 123, np.float32)
    for adapt in (False, True):
        tags = [0, 1, 0, 0, 1, 1, 0] if not adapt else [int(i % 17 == 3) for i in range(100)]
        spans = []
        for cls in (JaxBase, BasePredictor):
            p = cls()
            p.adapt, p.interval, p.sr = adapt, 1, SR
            spans.append(p.segment_audio(None, tags, mock_audio=audio, mock_sr=SR)[0])
        assert spans[0] == spans[1]
