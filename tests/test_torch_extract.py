"""The port's training extractor, inference extractor and `predict -ee`
against the JAX package's, on the CPU, with the same weights.

A two-wav corpus (8 and 12 s: sentence-like tones with gaps, JSON
transcripts of 1.5-3 s sentences, a flat label file with about 30 %
boundaries) runs through both training CLIs for every encoder and
unitization flag set (the energy and the CRDNN VAD, -ust, -vd, each
encoder), plus -cl, -aus, -cont and --BMAT. CREPE
(some 10 ms of CPU per 10 ms frame) and OpenL3 (whose JAX chunks pad one
window to 32) run on a 1.5 + 2.5 s corpus. Random-weight mode is patched so that both packages hold the JAX
`*_init(PRNGKey(0))` weights (wav2vec2 at a tiny geometry whose layer-0 norm
is per channel, as in test_torch_predict.py), and MTS_VAD_WEIGHTS names a
CRDNN npz written from the JAX `random_params`.

segments.pkl, labs_dict.pkl and labels.npy are identical; `.npy` files,
the pooling folders and the `_no_reduction` frames agree within 1e-4 of each
row's scale (its largest magnitude, at least 1: OpenL3's float32 sums over
4608 products reach some 40 and round at 2e-4).
"""
import dataclasses
import functools
import json
import os
import pickle
import tempfile

import numpy as np
import pytest

import jax

from multimodaltopicsegmentation_tpu.encoders import crdnn_vad as JV
from multimodaltopicsegmentation_tpu.encoders import crepe as JC
from multimodaltopicsegmentation_tpu.encoders import openl3 as JO
from multimodaltopicsegmentation_tpu.encoders import tdnn as JT
from multimodaltopicsegmentation_tpu.encoders import wav2vec2 as JW
from multimodaltopicsegmentation_torch.encoders import crepe as TC
from multimodaltopicsegmentation_torch.encoders import openl3 as TO
from multimodaltopicsegmentation_torch.encoders import tdnn as TT
from multimodaltopicsegmentation_torch.encoders import wav2vec2 as TW
from multimodaltopicsegmentation_torch.utils.audio import save_wav

SR = 16000
POOL_VARIANTS = ("_mean", "_max", "_mean_std", "_max_std", "_last", "_delta_gap")


def make_corpus(root, seconds=(8.0, 12.0), seed=0):
    """-> (audio dir, transcript dir, flat labels path, {stem: sentence count})."""
    rng = np.random.default_rng(seed)
    audio_dir, data_dir = os.path.join(root, "audio"), os.path.join(root, "data")
    os.makedirs(audio_dir)
    os.makedirs(data_dir)
    labs, counts = [], {}
    for d, dur in enumerate(seconds):
        sig = (0.01 * rng.standard_normal(int(dur * SR))).astype(np.float32)
        sentences, t = [], 0.0
        while t < dur - 0.5:
            length = float(min(rng.uniform(1.5, 3.0), dur - t))
            a, b = int(t * SR), int(min(t + length - 0.4, dur) * SR)
            tone = rng.choice([140.0, 220.0, 310.0])
            sig[a:b] += 0.4 * np.sin(2 * np.pi * tone * np.arange(b - a) / SR)
            sentences.append({"sentence": f"s{len(sentences)}", "start": round(t, 3),
                              "end": round(min(t + length, dur), 3)})
            labs.append(int(rng.random() < 0.3))
            t += length
        labs[-1] = 1
        counts[f"doc{d}"] = len(sentences)
        save_wav(os.path.join(audio_dir, f"doc{d}.wav"), sig, SR)
        with open(os.path.join(data_dir, f"doc{d}.json"), "w") as f:
            json.dump(sentences, f)
    lab_path = os.path.join(root, "labs.npy")
    np.save(lab_path, np.asarray(labs))
    return audio_dir, data_dir, lab_path, counts


@pytest.fixture
def same_weights(monkeypatch, tmp_path):
    """Both packages' random-weight mode holds the JAX init weights; -> the
    path of a CRDNN npz (JAX random_params) for MTS_VAD_WEIGHTS."""
    jcfg = dataclasses.replace(JW.Wav2Vec2Config.tiny(), num_groupnorm_groups=16)
    tcfg = TW.Wav2Vec2Config(**dataclasses.asdict(jcfg))
    w2v = jax.tree.map(np.asarray, JW.init_params(jax.random.PRNGKey(0), jcfg, stacked=True))
    monkeypatch.setattr(JW.Wav2Vec2Config, "base", classmethod(lambda cls: jcfg))
    monkeypatch.setattr(TW.Wav2Vec2Config, "base", classmethod(lambda cls: tcfg))
    monkeypatch.setattr(TW, "random_state_dict", lambda cfg, seed=0: TW.from_jax_params(w2v, cfg))

    def carried(init, convert):
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
        return lambda generator: convert(params)

    monkeypatch.setattr(TT, "xvector_random_state_dict",
                        carried(JT.xvector_init, TT.xvector_from_jax_params))
    monkeypatch.setattr(TT, "ecapa_random_state_dict",
                        carried(JT.ecapa_init, TT.ecapa_from_jax_params))
    monkeypatch.setattr(TO, "random_state_dict", carried(JO.openl3_init, TO.from_jax_params))
    monkeypatch.setattr(TC, "random_state_dict", carried(JC.crepe_init, TC.from_jax_params))
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    for var in ("MTS_WAV2VEC2_WEIGHTS", "MTS_XVECTOR_WEIGHTS", "MTS_ECAPA_WEIGHTS",
                "MTS_OPENL3_WEIGHTS", "MTS_OPENL3_WEIGHTS_MEL128", "MTS_OPENL3_WEIGHTS_MEL256",
                "MTS_CREPE_WEIGHTS", "MTS_VAD_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    vad = str(tmp_path / "vad.npz")
    np.savez(vad, **calibrated_crdnn())
    return vad


@functools.lru_cache(maxsize=1)
def calibrated_crdnn():
    """JAX random CRDNN weights whose posteriors spread around 0.5 on the
    corpus: random weights put every posterior within 0.01 of 0.5, where the
    VAD finds no span (the head is scaled by 300 and its bias set so that
    the median frame of a corpus document scores 0.5)."""
    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    params = jax.tree.map(np.asarray, JV.random_params(jax.random.PRNGKey(0)))
    params["out_w"] = params["out_w"] * 300.0
    with tempfile.TemporaryDirectory() as root:
        audio_dir, _, _, _ = make_corpus(root)
        post = JV.posteriors(params, load_audio(os.path.join(audio_dir, "doc1.wav"))[0], SR)
    median = float(np.median(post))
    params["out_b"] = (params["out_b"] - np.log(median / (1.0 - median))).astype(np.float32)
    return params


def _close(got, want):
    """Within 1e-4 of each row's scale, max(1, its largest magnitude)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if want.size == 0:
        return
    w2 = want.reshape(len(want), -1) if want.ndim > 1 else want[None]
    scale = np.maximum(np.abs(w2).max(axis=1, keepdims=True), 1.0)
    bad = np.abs(got.reshape(w2.shape) - w2) > 1e-4 * scale
    assert not bad.any(), (np.argwhere(bad)[:5], got.reshape(w2.shape)[bad][:5], w2[bad][:5])


def _run_both(tmp_path, argv, corpus=None, tag="run"):
    """Run both training CLIs on one corpus -> (jax out root, port out root)."""
    from multimodaltopicsegmentation_tpu.cli.extract_embeddings import cli_main as jax_extract
    from multimodaltopicsegmentation_torch.cli.extract_embeddings import cli_main as torch_extract

    audio_dir, data_dir, lab_path, _ = corpus or make_corpus(str(tmp_path / "corpus"))
    outs = []
    for name, cli, extra in (("jax", jax_extract, []), ("torch", torch_extract, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}_{name}")
        cli(["-data", data_dir, "-audio", audio_dir, "-lab", lab_path, "-od", out + "/emb",
             "-lod", out + "/labs"] + argv + extra)
        outs.append(out)
    return outs


def _same_outputs(jout, tout, frame_level, docs=("doc0", "doc1")):
    for name in ("segments.pkl", "labs_dict.pkl"):
        with open(os.path.join(jout, "labs", name), "rb") as a, \
                open(os.path.join(tout, "labs", name), "rb") as b:
            assert pickle.load(b) == pickle.load(a), name
    want = np.load(os.path.join(jout, "labs", "labels.npy"), allow_pickle=True)
    got = np.load(os.path.join(tout, "labs", "labels.npy"), allow_pickle=True)
    assert got.tolist() == want.tolist()
    for doc in docs:
        if not frame_level:
            _close(np.load(os.path.join(tout, "emb", doc + ".npy")),
                   np.load(os.path.join(jout, "emb", doc + ".npy")))
            continue
        for variant in POOL_VARIANTS:
            _close(np.load(os.path.join(tout, "emb", variant, doc + ".npy")),
                   np.load(os.path.join(jout, "emb", variant, doc + ".npy")))
        with open(os.path.join(jout, "emb", "_no_reduction", doc + ".pkl"), "rb") as a, \
                open(os.path.join(tout, "emb", "_no_reduction", doc + ".pkl"), "rb") as b:
            want_frames, got_frames = pickle.load(a), pickle.load(b)
        assert len(got_frames) == len(want_frames)
        for g, w in zip(got_frames, want_frames):
            _close(g, w)


# (argv, frame-level outputs, CRDNN VAD): the VADs, unitizations and encoders, and the extra flags
CASES = {
    "vad_xvector": ([], False, False),
    "crdnn_vad_xvector": ([], False, True),
    "sentences_prosodic": (["-ust", "--prosodic_feats"], False, False),
    "uniform_mfcc": (["-vd", "--mfcc"], False, False),
    "uniform_wav2vec": (["-vd", "--wav2vec"], True, False),
    "uniform_ecapa": (["-vd", "--ecapa"], False, False),
    "sentences_concatenated_labels": (["-ust", "-cl", "--mfcc"], False, False),
    "adaptive_uniform": (["-vd", "-aus", "--mfcc"], False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_extractor_matches_jax(tmp_path, monkeypatch, same_weights, case):
    argv, frame_level, crdnn = CASES[case]
    if crdnn:
        monkeypatch.setenv("MTS_VAD_WEIGHTS", same_weights)
    jout, tout = _run_both(tmp_path, argv)
    _same_outputs(jout, tout, frame_level)
    with open(os.path.join(tout, "labs", "labs_dict.pkl"), "rb") as f:
        labs = pickle.load(f)
    assert sorted(labs) == ["doc0", "doc1"] and all(sum(v) >= 1 for v in labs.values())


@pytest.mark.parametrize("flag", ["--CREPE", "--openl3"])
def test_windowed_encoders_match_jax(tmp_path, same_weights, flag):
    corpus = make_corpus(str(tmp_path / "corpus"), seconds=(1.5, 2.5), seed=1)
    jout, tout = _run_both(tmp_path, ["-vd", flag], corpus)
    _same_outputs(jout, tout, frame_level=True)


def test_uniform_concatenated_labels_fail_alike(tmp_path, same_weights):
    """-vd -cl: one label list per topic never matches the window count; the
    JAX CLI asserts, the port raises."""
    with pytest.raises((AssertionError, RuntimeError), match="same length as labels"):
        _run_both(tmp_path, ["-vd", "-cl", "--mfcc"])
    from multimodaltopicsegmentation_torch.cli.extract_embeddings import cli_main

    audio_dir, data_dir, lab_path, _ = make_corpus(str(tmp_path / "c2"))
    with pytest.raises(RuntimeError, match="same length as labels"):
        cli_main(["-data", data_dir, "-audio", audio_dir, "-lab", lab_path, "-vd", "-cl",
                  "--mfcc", "-od", str(tmp_path / "o"), "-lod", str(tmp_path / "l"),
                  "--device", "cpu"])


def test_continue_from_check_matches_jax(tmp_path, same_weights):
    """A second -cont run skips the documents already written (and their labels)."""
    corpus = make_corpus(str(tmp_path / "corpus"))
    outs = _run_both(tmp_path, ["-vd", "--mfcc"], corpus)
    for out in outs:
        os.remove(os.path.join(out, "emb", "doc1.npy"))
        os.remove(os.path.join(out, "labs", "segments.pkl"))
    jout, tout = _run_both(tmp_path, ["-vd", "--mfcc", "-cont"], corpus)
    assert (jout, tout) == tuple(outs)
    _same_outputs(jout, tout, frame_level=False, docs=("doc1",))
    with open(os.path.join(tout, "labs", "labs_dict.pkl"), "rb") as f:
        assert sorted(pickle.load(f)) == ["doc1"]


def test_bmat_labels_match_jax(tmp_path, same_weights):
    """--BMAT: topic durations per document from a JSON label file."""
    audio_dir, data_dir, _, _ = make_corpus(str(tmp_path / "corpus"))
    lab_json = str(tmp_path / "bmat.json")
    with open(lab_json, "w") as f:
        json.dump({"doc0": [3.0, 5.0], "doc1": [4.0, 4.5, 3.5]}, f)
    jout, tout = _run_both(tmp_path, ["-vd", "--mfcc", "--BMAT"],
                           (audio_dir, data_dir, lab_json, None))
    _same_outputs(jout, tout, frame_level=False)


@pytest.mark.parametrize("flag", ["--openl3", "--prosodic_feats"])
def test_inference_extractor_matches_jax(tmp_path, same_weights, flag):
    """Uniform 1-second units; OpenL3 takes its mel256 inference variant."""
    from multimodaltopicsegmentation_tpu.cli.extract_embeddings_inference import cli_main as jx
    from multimodaltopicsegmentation_torch.cli.extract_embeddings_inference import cli_main as tx

    seconds = (1.5, 2.5) if flag == "--openl3" else (8.0, 12.0)
    audio_dir, _, _, _ = make_corpus(str(tmp_path / "corpus"), seconds)
    jx(["-audio", audio_dir, "-od", str(tmp_path / "j"), flag])
    tx(["-audio", audio_dir, "-od", str(tmp_path / "t"), flag, "--device", "cpu"])
    sub = "_mean" if flag == "--openl3" else ""
    for doc in ("doc0.npy", "doc1.npy"):
        got = np.load(tmp_path / "t" / sub / doc)
        assert got.shape[0] in (1, 2, 8, 12)
        _close(got, np.load(tmp_path / "j" / sub / doc))


def test_predict_ee_prosodic_matches_jax(tmp_path, monkeypatch, same_weights):
    """predict -ee with a prosodic BiLSTM checkpoint (embedding 167)."""
    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict
    from multimodaltopicsegmentation_tpu.models.base import TaggerConfig
    from multimodaltopicsegmentation_tpu.models.taggers import BiLSTMTagger
    from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    audio_dir, _, _, _ = make_corpus(str(tmp_path / "corpus"))
    cfg = TaggerConfig(embedding_dim=167, hidden_dim=8, num_layers=2, loss_fn="FocalLoss")
    params = jax.tree.map(np.asarray, BiLSTMTagger(cfg).init(jax.random.PRNGKey(3)))
    params["cls"]["w"] = params["cls"]["w"] * 30.0
    ckpt = str(tmp_path / "ckpt" / "best_model")
    jax_ckpt.save(ckpt, params, cfg, "BiLSTM")
    hyp = tmp_path / "results.txt"
    hyp.write_text("Sentence encoder: prosodic\nNeural architecture: BiLSTM\n"
                   "Hidden units: 8\nNumber of layers: 2\n")
    common = ["-ee", "-hyp", str(hyp), "-model", ckpt, "-af", audio_dir, "-ui", "1.0"]
    jax_predict(common + ["-ef", str(tmp_path / "jemb"), "-exp", str(tmp_path / "jexp")])
    torch_predict(common + ["-ef", str(tmp_path / "temb"), "-exp", str(tmp_path / "texp"),
                            "--device", "cpu"])
    for doc in ("doc0.npy", "doc1.npy"):
        _close(np.load(tmp_path / "temb" / doc), np.load(tmp_path / "jemb" / doc))
    results = []
    for exp in ("jexp", "texp"):
        with open(tmp_path / exp / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[1] == results[0]
    assert sorted(os.listdir(tmp_path / "texp" / "audio_segments")) == \
        sorted(os.listdir(tmp_path / "jexp" / "audio_segments"))


def test_extractor_refuses_missing_cuda(tmp_path, same_weights):
    """Without a card the default device raises; nothing falls back."""
    import torch
    from multimodaltopicsegmentation_torch.cli.extract_embeddings import cli_main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    audio_dir, data_dir, lab_path, _ = make_corpus(str(tmp_path / "corpus"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["-data", data_dir, "-audio", audio_dir, "-lab", lab_path, "-vd", "--mfcc",
                  "-od", str(tmp_path / "o"), "-lod", str(tmp_path / "l")])


def test_extractor_profiling_report_and_trace(tmp_path, monkeypatch, capsys, same_weights):
    """MTS_PROFILE=1 prints the per-document encode totals and MTS_TRACE_DIR
    receives a torch.profiler Chrome trace of the run."""
    from multimodaltopicsegmentation_torch.cli.extract_embeddings import cli_main
    from multimodaltopicsegmentation_torch.utils import profiling

    profiling.reset()
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MTS_PROFILE", "1")
    monkeypatch.setenv("MTS_TRACE_DIR", str(trace_dir))
    audio_dir, data_dir, lab_path, _ = make_corpus(str(tmp_path / "corpus"))
    cli_main(["-data", data_dir, "-audio", audio_dir, "-lab", lab_path, "-vd", "--mfcc",
              "-od", str(tmp_path / "o"), "-lod", str(tmp_path / "l"), "--device", "cpu"])
    assert profiling.report()["encode_document"]["calls"] == 2
    assert "encode_document" in capsys.readouterr().out
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(trace_dir / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    profiling.reset()
