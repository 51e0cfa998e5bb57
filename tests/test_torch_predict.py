"""The port's predict slice as a whole against the JAX package: both
packages' extract (--wav2vec) and predict CLIs on the same synthetic wavs,
with the same weights.

A tiny wav2vec2 geometry, per-channel layer-0 norm as in wav2vec2-base (so
the port goes through ops/instance_norm_gelu), is injected into both
packages' random-weight mode, and the JAX random weights are carried into
the port with `from_jax_params`. The BiLSTM checkpoint is written by the
JAX package. The `_mean` embeddings agree within 1e-4 and `results.pkl` and
the segment wavs are identical.

The transformer taggers' predict path is held the same way from a folder of
`.npy` embeddings: one JAX-written random checkpoint per architecture, both
predict CLIs with `-rjs`, identical `results.pkl`.
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
TRANSFORMER_TAGGERS = ["Transformer", "RecurrentLongT5", "BiLSTMRestrictedMHA"]


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
    _one_jax_device(monkeypatch)
    return jcfg


def _one_jax_device(monkeypatch):
    """The JAX predict decodes on a single device, as on one chip."""
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])


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


@pytest.mark.parametrize("architecture", TRANSFORMER_TAGGERS)
def test_predict_cli_transformer_taggers_match_jax(tmp_path, monkeypatch, architecture):
    """Precomputed embeddings -> tags, three ragged documents in two chunks."""
    import jax.numpy as jnp

    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict
    from multimodaltopicsegmentation_tpu.models import registry as jax_registry
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    _one_jax_device(monkeypatch)
    rng = np.random.default_rng(0)
    emb = tmp_path / "emb"
    emb.mkdir()
    docs = [rng.standard_normal((n, 32)).astype(np.float32) for n in (70, 9, 130)]
    for d, x in enumerate(docs):
        np.save(emb / f"doc{d}.npy", x)

    cfg = JaxTaggerConfig(embedding_dim=32, hidden_dim=32, num_layers=2, nheads=4,
                          attention_window=8, loss_fn="FocalLoss")
    arch = jax_registry.build(architecture, cfg)
    params = jax.tree.map(np.asarray, arch.init(jax.random.PRNGKey(1)))
    params["cls"]["w"] = params["cls"]["w"] * 20.0
    # the threshold goes between two scores of the first document
    logits, _ = arch.decode(params, jnp.asarray(docs[0])[None], jnp.asarray([70]), 0.5)
    ordered = np.sort(np.asarray(logits)[0, :, 0])
    params["cls"]["b"] = params["cls"]["b"] - 0.5 * (ordered[34] + ordered[35])
    ckpt = str(tmp_path / "ckpt" / "best_model")
    jax_ckpt.save(ckpt, params, cfg, architecture)
    hyp = tmp_path / "results.txt"
    hyp.write_text(f"Sentence encoder: wav2vec_mean\nNeural architecture: {architecture}\n")

    common = ["-ef", str(emb), "-hyp", str(hyp), "-model", ckpt, "-bs", "2", "-rjs"]
    jax_predict(common + ["-exp", str(tmp_path / "jexp")])
    torch_predict(common + ["-exp", str(tmp_path / "texp"), "--device", "cpu"])
    results = []
    for exp in ("jexp", "texp"):
        with open(tmp_path / exp / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[1] == results[0]
    assert [len(results[1][f"doc{d}.npy"]) for d in range(3)] == [70, 9, 130]
    assert 0 < sum(results[1]["doc0.npy"]) < 70  # both tags occur


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


ZOO_TAGGERS = ["biLSTMCRF", "Transformer-CRF", "SimpleBiLSTM", "MLP", "SheikhBiLSTM",
               "BiLSTMLateFusion"]


def _zoo_checkpoint(tmp_path, architecture):
    """A JAX-written random checkpoint of `architecture` whose scores are
    spread so that both tags occur (a sigmoid head's bias is set so that the
    median unit of a random document scores 0.5), and its results.txt."""
    import jax.numpy as jnp

    from multimodaltopicsegmentation_tpu.models import registry as jax_registry

    cfg = JaxTaggerConfig(embedding_dim=32, embedding_dim2=12, hidden_dim=16, num_layers=2,
                          nheads=4, loss_fn="CrossEntropy" if architecture.endswith("CRF")
                          else "FocalLoss")
    arch = jax_registry.build(architecture, cfg)
    params = jax.tree.map(np.asarray, arch.init(jax.random.PRNGKey(4)))
    if "crf" in params:
        params["crf"]["fc_w"] = params["crf"]["fc_w"] * 20.0
    if "cls" in params:
        rng = np.random.default_rng(5)
        x, x2 = (jnp.asarray(rng.standard_normal((1, 70, d)), jnp.float32) for d in (32, 12))
        kw = {"x2": x2} if architecture == "BiLSTMLateFusion" else {}
        logits, _ = arch.decode(params, x, jnp.asarray([70]), 0.5, **kw)
        params["cls"]["b"] = params["cls"]["b"] - np.median(np.asarray(logits))
    if architecture == "SheikhBiLSTM":
        params["fwd_dense"]["w"] = params["fwd_dense"]["w"] * 5.0
    ckpt = str(tmp_path / "ckpt" / "best_model")
    jax_ckpt.save(ckpt, params, cfg, architecture)
    hyp = tmp_path / "results.txt"
    second = "Second sentence encoder: crepe\n" if architecture == "BiLSTMLateFusion" else ""
    hyp.write_text(f"Sentence encoder: wav2vec_mean\n{second}Neural architecture: {architecture}\n")
    return ckpt, str(hyp)


def _write_docs(folder, units, dim, seed):
    rng = np.random.default_rng(seed)
    folder.mkdir()
    for d, n in enumerate(units):
        np.save(folder / f"doc{d}.npy", rng.standard_normal((n, dim)).astype(np.float32))
    return str(folder)


@pytest.mark.parametrize("architecture", ZOO_TAGGERS)
def test_predict_cli_zoo_taggers_match_jax(tmp_path, monkeypatch, architecture):
    """Precomputed embeddings -> tags through both predict CLIs, three ragged
    documents in two chunks: a CRF's tags are its Viterbi paths; late fusion
    reads its second modality from -ef2."""
    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    _one_jax_device(monkeypatch)
    units = (70, 9, 130)
    emb = _write_docs(tmp_path / "emb", units, 32, 0)
    emb2 = _write_docs(tmp_path / "emb2", units, 12, 1)
    ckpt, hyp = _zoo_checkpoint(tmp_path, architecture)
    common = ["-ef", emb, "-hyp", hyp, "-model", ckpt, "-bs", "2", "-rjs"]
    if architecture == "BiLSTMLateFusion":
        common += ["-ef2", emb2]
    jax_predict(common + ["-exp", str(tmp_path / "jexp")])
    torch_predict(common + ["-exp", str(tmp_path / "texp"), "--device", "cpu"])
    results = []
    for exp in ("jexp", "texp"):
        with open(tmp_path / exp / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[1] == results[0]
    assert [len(results[1][f"doc{d}.npy"]) for d in range(3)] == list(units)
    assert 0 < sum(sum(t) for t in results[1].values()) < sum(units)  # both tags occur


def test_predict_cli_refusals_match_jax(tmp_path, monkeypatch):
    """SwitchBiLSTM is refused (no domain ids at predict time); late fusion
    refuses a results.txt without its second encoder, a second folder with
    other files, and one with other unit counts, as the JAX CLI does."""
    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict
    from multimodaltopicsegmentation_tpu.models.taggers import SwitchBiLSTM as JaxSwitch
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    _one_jax_device(monkeypatch)
    predicts = (jax_predict, lambda argv: torch_predict(argv + ["--device", "cpu"]))
    emb = _write_docs(tmp_path / "emb", (20, 9), 32, 0)
    cfg = JaxTaggerConfig(embedding_dim=32, hidden_dim=8, num_layers=1)
    switch = str(tmp_path / "switch.ckpt")
    jax_ckpt.save(switch, JaxSwitch(cfg).init(jax.random.PRNGKey(0)), cfg, "SwitchBiLSTM")
    hyp_switch = tmp_path / "switch.txt"
    hyp_switch.write_text("Sentence encoder: wav2vec_mean\nNeural architecture: SwitchBiLSTM\n")
    for i, predict in enumerate(predicts):
        with pytest.raises(NotImplementedError, match="domain ids"):
            predict(["-ef", emb, "-hyp", str(hyp_switch), "-model", switch,
                     "-exp", str(tmp_path / f"s{i}")])

    ckpt, hyp = _zoo_checkpoint(tmp_path, "BiLSTMLateFusion")
    no_second = tmp_path / "no_second.txt"
    no_second.write_text("Sentence encoder: wav2vec_mean\nNeural architecture: BiLSTMLateFusion\n")
    other_files = _write_docs(tmp_path / "other_files", (20,), 12, 1)
    other_units = _write_docs(tmp_path / "other_units", (20, 10), 12, 1)
    for i, predict in enumerate(predicts):
        with pytest.raises(ValueError, match="Second sentence encoder"):
            predict(["-ef", emb, "-hyp", str(no_second), "-model", ckpt,
                     "-exp", str(tmp_path / f"a{i}")])
        with pytest.raises(ValueError, match="same documents"):
            predict(["-ef", emb, "-ef2", other_files, "-hyp", hyp, "-model", ckpt,
                     "-exp", str(tmp_path / f"b{i}")])
        with pytest.raises(ValueError, match="9 units"):
            predict(["-ef", emb, "-ef2", other_units, "-hyp", hyp, "-model", ckpt,
                     "-exp", str(tmp_path / f"c{i}")])
