"""The port's tracer (utils/profiling.py): span nesting, parents, counts and
self time; nothing recorded and nothing read with tracing off; the spans on a
torch profiler's timeline and on the host's perf_counter clock; and the span
trees that `Trainer.fit`, `Wav2Vec2Encoder.encode_document` and
`Predictor.predict` open (CPU, tiny sizes)."""
import os
import threading
import time

import numpy as np
import pytest
import torch

from multimodaltopicsegmentation_torch.utils import profiling

SR = 16000


@pytest.fixture
def traced(monkeypatch):
    """MTS_PROFILE=1 and no span left from another test."""
    monkeypatch.setenv("MTS_PROFILE", "1")
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def untraced(monkeypatch):
    monkeypatch.delenv("MTS_PROFILE", raising=False)
    profiling.reset()
    yield
    profiling.reset()


def _tree(records):
    """[(name, parent's name or None)] in the order the spans opened."""
    return [(r.name, records[r.parent].name if r.parent >= 0 else None) for r in records]


def test_nesting_parents_counts_and_self_time(traced):
    with profiling.span("a", n=1) as a:
        time.sleep(0.01)
        with profiling.span("a.b"):
            time.sleep(0.02)
        with profiling.span("a.b") as b:
            b.add("bytes", 5)
            b.add("bytes", 2)
        a.add("n", 2)
    with profiling.span("c"):
        pass
    records = profiling.spans()
    assert _tree(records) == [("a", None), ("a.b", "a"), ("a.b", "a"), ("c", None)]
    assert [r.parent for r in records] == [-1, 0, 0, -1]
    assert all(r.start <= r.end for r in records)
    assert records[0].start <= records[1].start and records[2].end <= records[0].end
    report = profiling.report()
    assert report["a.b"]["calls"] == 2 and report["a.b"]["counts"] == {"bytes": 7}
    assert report["a"]["counts"] == {"n": 3} and report["c"]["counts"] == {}
    children = sum(r.end - r.start for r in records[1:3]) / 1e9
    assert report["a"]["self_s"] == pytest.approx(report["a"]["total_s"] - children, abs=1e-9)
    assert report["a"]["self_s"] >= 0.01 and report["a.b"]["total_s"] >= 0.02
    assert report["a.b"]["self_s"] == pytest.approx(report["a.b"]["total_s"])


def test_each_thread_nests_its_own_spans(traced):
    seen = {}

    def worker():
        with profiling.span("worker"):
            seen["thread"] = threading.get_ident()

    with profiling.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    by_name = {r.name: r for r in profiling.spans()}
    # the worker's span is no child of the span open on the main thread
    assert by_name["worker"].parent == -1 and by_name["worker"].thread == seen["thread"]
    assert by_name["main"].thread == threading.get_ident()


def test_report_prints_under_mts_profile(traced, capsys):
    with profiling.span("encode_document", units=4):
        pass
    profiling.maybe_print_report()
    out = capsys.readouterr().out
    assert "encode_document" in out and "units 4" in out


def test_tracing_off_reads_no_clock_records_nothing_and_opens_no_range(untraced, monkeypatch):
    def touched(*args, **kwargs):
        raise AssertionError("read or opened with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", touched)
    monkeypatch.setattr(torch.profiler, "record_function", touched)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", touched)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", touched)
    with profiling.span("fit", epochs=3) as handle:
        handle.add("epochs", 1)
        with profiling.span("fit.epoch") as inner:
            pass
    assert handle is inner is profiling.span("other")
    monkeypatch.undo()
    assert profiling.spans() == [] and profiling.report() == {}
    profiling.maybe_print_report()  # nothing to print, nothing raised


def test_spans_ride_the_profilers_timeline_on_the_perf_counter_clock(untraced):
    """Under a torch profiler (no MTS_PROFILE) each span records and opens
    its mts.<name> range, a function-scope record: no user annotation, which
    would cast a shadow onto the device's timeline."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        with profiling.span("outer", units=2):
            with profiling.span("outer.inner"):
                torch.ones(16, 16) @ torch.ones(16, 16)
        t1 = time.perf_counter()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("mts.")]
    assert sorted(e.name() for e in events) == ["mts.outer", "mts.outer.inner"]
    assert not any(e.is_user_annotation() for e in events)
    outer = next(e for e in events if e.name() == "mts.outer")
    inner = next(e for e in events if e.name() == "mts.outer.inner")
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()
    records = profiling.spans()
    assert _tree(records) == [("outer", None), ("outer.inner", "outer")]
    for r in records:
        assert t0 * 1e9 <= r.start <= r.end <= t1 * 1e9
    # tracing is off again once the profiler has stopped
    with profiling.span("after"):
        pass
    assert len(profiling.spans()) == 2


def test_stage_is_gone():
    assert not hasattr(profiling, "stage")


# -- the spans of the port's layers ------------------------------------------------------

def _batch(rng, B, L, D, lengths):
    lengths = np.array(lengths, np.int32)
    tags = (rng.random((B, L)) < 0.2).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    return {"src_tokens": rng.standard_normal((B, L, D)).astype(np.float32),
            "tgt_tokens": tags, "src_lengths": lengths, "n_real": B}


def test_fit_span_tree_and_bytes(traced, tmp_path):
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    train = [_batch(rng, 3, 12, 8, (12, 7, 4)), _batch(rng, 2, 9, 8, (9, 5))]
    valid = [_batch(rng, 2, 10, 8, (10, 6))]
    cfg = TaggerConfig(embedding_dim=8, hidden_dim=8, num_layers=1)
    trainer = Trainer("BiLSTM", cfg, max_epochs=4, patience=2, check_dir=str(tmp_path / "ck"),
                      device="cpu")
    _, history = trainer.fit(train, valid)
    records = profiling.spans()
    names = [r.name for r in records]
    assert names.count("fit") == 1 and names.count("fit.epoch") == len(history) >= 1
    for once in ("fit.build", "fit.to_device", "fit.checkpoint", "fit.gather"):
        assert names.count(once) == 1, once
    assert all(parent == "fit" for name, parent in _tree(records) if name != "fit")
    fit = records[names.index("fit")]
    assert fit.counts == {"epochs": len(history)}
    want = sum(b[k].nbytes for b in train + valid for k in ("src_tokens", "tgt_tokens",
                                                            "src_lengths"))
    assert records[names.index("fit.to_device")].counts == {"bytes_to_device": want}
    assert records[names.index("fit.checkpoint")].counts == {
        "bytes_written": os.path.getsize(trainer.best_model_path)}
    epochs = [r for r in records if r.name == "fit.epoch"]
    assert all(fit.start <= e.start <= e.end <= fit.end for e in epochs)


def test_device_epoch_fit_opens_windows(traced, tmp_path, monkeypatch):
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "2")
    rng = np.random.default_rng(1)
    train = [_batch(rng, 2, 8, 8, (8, 5))]
    cfg = TaggerConfig(embedding_dim=8, hidden_dim=8, num_layers=1)
    trainer = Trainer("BiLSTM", cfg, max_epochs=3, patience=5, device_epochs=True,
                      check_dir=str(tmp_path / "ck"), device="cpu")
    _, history = trainer.fit(train, train)
    records = profiling.spans()
    windows = [r for r in records if r.name == "fit.window"]
    assert len(windows) == 2 and sum(w.counts["epochs"] for w in windows) == len(history) == 3
    assert [r.name for r in records if r.name != "fit.window"] == [
        "fit", "fit.build", "fit.to_device", "fit.checkpoint", "fit.gather"]
    assert records[0].counts == {"epochs": 3}


def _tiny_wav2vec2_encoder(**changes):
    import dataclasses

    from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder

    cfg = dataclasses.replace(W.Wav2Vec2Config.tiny(), **changes)
    enc = Wav2Vec2Encoder.__new__(Wav2Vec2Encoder)
    enc.device, enc.cfg = torch.device("cpu"), cfg
    enc.model = W.build_model(cfg, W.random_state_dict(cfg, seed=0), enc.device)
    return enc


def test_wav2vec2_encode_document_spans(traced):
    enc = _tiny_wav2vec2_encoder()
    audio = np.random.default_rng(0).standard_normal(6 * SR + SR // 2).astype(np.float32)
    bounds = [(i * SR, (i + 1) * SR) for i in range(6)]
    frames = enc.encode_document(audio, bounds, chunk=4)
    records = profiling.spans()
    top = [r for r in records if r.name == "encode_document"]
    assert len(top) == 1 and top[0].counts == {"units": len(bounds)}
    # the document's padded length once, then one chunk ahead: chunk 1 is packed,
    # sent and queued before chunk 0's frames are drained and sliced
    queue = ["encode_document.pack", "encode_document.to_device", "encode_document.forward"]
    drain = ["encode_document.to_host", "encode_document.slice"]
    tree = _tree(records)
    outer = [name for name, parent in tree if parent in (None, "encode_document")]
    assert outer == ["encode_document", "encode_document.pack"] + queue * 2 + drain * 2
    assert [r.counts["ahead"] for r in records if r.name.endswith(".forward")] == [0, 1]
    # inside each forward: the conv stack's span alone (no relative bias in wav2vec2)
    assert [name for name, parent in tree if parent == "encode_document.forward"] == \
        ["encode_document.forward.features"] * 2
    assert len(tree) == 1 + 1 + 2 * len(queue) + 2 * len(drain) + 2
    # whole 1-s units keep every frame the chunk brought back
    to_host = sum(r.counts["bytes_to_host"] for r in records if r.name.endswith(".to_host"))
    assert to_host == sum(f.nbytes for f in frames)
    to_device = sum(r.counts["bytes_to_device"] for r in records if r.name.endswith(".to_device"))
    assert to_device == 2 * 4 * (SR * 4 + 4)  # two chunks of 4 rows (the tail bucketed) + lengths


def test_wavlm_forward_spans_nest_under_forward(traced):
    """WavLM's forward opens, inside each `encode_document.forward`, the conv
    stack's span, the relative bias's once (its bytes, H x T x T float32) and
    one gate span a layer (its heads)."""
    from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W

    enc = _tiny_wav2vec2_encoder(feat_extract_norm="layer", do_stable_layer_norm=True,
                                 num_buckets=32, max_bucket_distance=64)
    audio = np.random.default_rng(1).standard_normal(3 * SR).astype(np.float32)
    bounds = [(i * SR, (i + 1) * SR) for i in range(3)]
    enc.encode_document(audio, bounds, chunk=2)
    records = profiling.spans()
    forwards = [i for i, r in enumerate(records) if r.name == "encode_document.forward"]
    assert len(forwards) == 2
    cfg = enc.cfg
    T = W.feature_extractor_output_length(cfg, SR)
    for f in forwards:
        inner = [r for r in records if r.parent == f]
        assert [r.name for r in inner] == (
            ["encode_document.forward.features", "encode_document.forward.rel_bias"]
            + ["encode_document.forward.gate"] * cfg.num_layers)
        assert inner[1].counts == {"bias_bytes": cfg.num_heads * T * T * 4}
        assert all(r.counts == {"heads": cfg.num_heads} for r in inner[2:])
        assert all(records[f].start <= r.start and r.end <= records[f].end for r in inner)


def test_every_encoder_opens_encode_document():
    from multimodaltopicsegmentation_torch.encoders import crepe, engine, openl3, tdnn

    for cls in (engine.ProsodicEncoder, engine.MFCCEncoder, engine.Wav2Vec2Encoder,
                tdnn._PooledEncoder, tdnn.RandomProjectionEncoder, openl3.OpenL3Encoder,
                crepe.CrepeEncoder):
        assert cls.encode_document.__code__.co_name == "traced", cls


def test_predict_span_tree(traced, tmp_path):
    from multimodaltopicsegmentation_torch.cli.predict import Predictor
    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig
    from multimodaltopicsegmentation_torch.train import checkpoints
    from multimodaltopicsegmentation_torch.train.data import pad_batch

    cfg = TaggerConfig(embedding_dim=8, hidden_dim=8, num_layers=1)
    tagger = registry.build("BiLSTM", cfg, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "model.ckpt")
    checkpoints.save(ckpt, tagger.to_jax_params(), cfg, "BiLSTM")
    hyp = tmp_path / "results.txt"
    hyp.write_text("Sentence encoder: wav2vec\nNeural architecture: BiLSTM\n")
    emb = tmp_path / "emb"
    emb.mkdir()
    rng = np.random.default_rng(0)
    lengths = [7, 12, 5]
    for d, n in enumerate(lengths):
        np.save(emb / f"doc{d}.npy", rng.standard_normal((n, 8)).astype(np.float32))
    predictor = Predictor(str(hyp), ckpt, device="cpu")
    profiling.reset()  # the checkpoint's load is not predict's
    results = predictor.predict(str(emb), str(tmp_path / "exp"), write_audio_segments=False,
                                batch_size=2)
    assert [len(r) for r in results] == lengths
    records = profiling.spans()
    per_chunk = ["predict.pad", "predict.to_device", "predict.decode", "predict.to_host"]
    assert [r.name for r in records] == (["predict", "predict.load"] + per_chunk * 2
                                         + ["predict.write"])
    assert all(parent == "predict" for _, parent in _tree(records)[1:])
    assert records[0].counts == {"documents": 3, "units": sum(lengths)}
    sent = [r.counts["bytes_to_device"] for r in records if r.name == "predict.to_device"]
    docs = [(np.load(emb / f"doc{d}.npy"), [0] * n, f"doc{d}.npy") for d, n in enumerate(lengths)]
    padded = [pad_batch(docs[i:i + 2], crf=False, bucket=True) for i in (0, 2)]
    assert sent == [b["src_tokens"].nbytes + b["src_lengths"].nbytes for b in padded]
    assert os.path.exists(tmp_path / "exp" / "results.pkl")
