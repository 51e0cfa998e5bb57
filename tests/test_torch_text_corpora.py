"""The port's text-corpus loaders (utils/text_corpora.py) and logging helpers
(utils/logging_utils.py) against the JAX package's, on the fixtures of
tests/test_text_corpora.py and a few more: every loader and the dispatch,
`split_sentences` on both branches (punkt and the regex, `_PUNKT_AVAILABLE`
pinned alike on both sides), `expand_label`, `predictions_analysis` on
numpy-seeded vectors, and `setup_logger`. Outputs are equal."""
import json
import logging

import numpy as np
import pytest

from multimodaltopicsegmentation_tpu.utils import logging_utils as JL
from multimodaltopicsegmentation_tpu.utils import text_corpora as JT
from multimodaltopicsegmentation_torch.utils import logging_utils as PL
from multimodaltopicsegmentation_torch.utils import text_corpora as PT

TEXT = ("Dr. Smith went to Washington. He arrived at 3 p.m. on Monday! Did he meet "
        "the senator?  Nobody knows... The end")


def _choi(root):
    (root / "1.ref").write_text(
        "==========\nFirst sentence of segment one.\nSecond sentence of segment one.\n"
        "==========\nOnly sentence of segment two.\n==========\n")
    sub = root / "sub"
    sub.mkdir()
    (sub / "d.ref").write_text("==========\ns1.\ns2.\ns3.\n==========\ns4.\ns5.\n==========\n")
    (sub / "lead.ref").write_text("==========\nonly.\n==========\na.\nb.\n")


def _wiki(root):
    (root / "article").write_text(
        "========,1,preface.\nPreface sentence.\n========,2,Intro.\nIntro sentence one.\n"
        "Intro sentence two.\n========,2,Body.\nBody sentence.\n***LIST***\n")
    (root / "doc.txt").write_text(
        "========,1,Preface.\npre one.\n========,1,Alpha.\na one.\na two.\n"
        "========,3,Deep.\na three.\n***formula***\n========,2,Beta.\nb one.\n")
    (root / "skip.json").write_text("{}")


def _bbc(root):
    shows = [{"Items": ["One. Two.", "Three."], "Date": "2021-01-01"},
             {"Items": ["Only one sentence here."], "Date": "2021-01-02"},
             {"Items": ["Alpha beta. Gamma! Delta?", "Epsilon."]}]
    (root / "train.json").write_text(json.dumps({"Transcripts": shows}))
    (root / "test.json").write_text(json.dumps({"Transcripts": shows[:1]}))


def _bbc_audio(root):
    payload = {"data": {"getProgrammeById": {"segments": [
        {"transcript": "First sentence. Second sentence."}, {"transcript": "Third one."}]}}}
    sub = root / "nested"
    sub.mkdir()
    (sub / "show.json").write_text(json.dumps(payload))
    (root / "other.json").write_text(json.dumps(payload))


def _cnn(root):
    for i in (1, 2, 3):
        (root / f"doc{i}.txt").write_text(
            "==== preface separator\nAlpha one. Alpha two.\n==== section break\nBeta one.\n"
            + ("==== third\nGamma one. Gamma two. Gamma three.\n" if i == 2 else ""))


def _icsi(root):
    seg_dir, data_dir = root / "segments", root / "data"
    seg_dir.mkdir()
    data_dir.mkdir()
    (seg_dir / "Bmr001.segs").write_text("seg 2.0\nseg 4.0\n")
    (data_dir / "Bmr001.dacsv").write_text(
        "u_0_1000,hello there\nu_1500_2400,more talk\nu_2500_3000,new topic starts\n"
        "u_4500_5000,final words\n")
    (data_dir / "Bmr001.dadb").write_text("ignored")
    (seg_dir / "Bmr002.segs").write_text("seg 1.0\nno time here\n")  # dropped whole
    (data_dir / "Bmr002.dacsv").write_text("u_0_1,dropped\n")
    (data_dir / "Xyz999.dacsv").write_text("u_0_1,orphan\n")
    (seg_dir / "Bed003.segs").write_text("seg 0.5\nseg 1.0\nseg 9.0\n")
    (data_dir / "Bed003.dacsv").write_text(
        "u_0_100,a\nu_600_700,b\nu_800_900,c\nu_1200_1300,d\nu_1400_1500,e\nshort\n")


FIXTURES = {"choi": _choi, "wiki": _wiki, "bbc": _bbc, "bbcaudio": _bbc_audio, "cnn": _cnn,
            "icsi": _icsi}
CASES = [("choi", {}), ("choi", {"delete_last_sentence": True}),
         ("wiki", {}), ("wiki727", {"high_granularity": False}),
         ("wikisection", {"remove_special_tokens": True, "remove_preface_segment": False}),
         ("wiki", {"delete_last_sentence": True}),
         ("bbc", {}), ("bbc", {"delete_last_sentence": True}),
         ("bbcaudio", {}), ("bbcaudio", {"delete_last_sentence": True}),
         ("cnn", {"n_docs": 3}), ("cnn", {"n_docs": 3, "delete_last_sentence": True}),
         ("icsi", {}), ("icsi", {"delete_last_sentence": True})]


def _pin(monkeypatch, value):
    monkeypatch.setattr(JT, "_PUNKT_AVAILABLE", value)
    monkeypatch.setattr(PT, "_PUNKT_AVAILABLE", value)


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}" for n, k in CASES])
@pytest.mark.parametrize("punkt", [None, False])
def test_loaders_equal_to_jax(tmp_path, monkeypatch, name, kwargs, punkt):
    _pin(monkeypatch, punkt)
    key = "wiki" if name.startswith("wiki") else name
    FIXTURES[key](tmp_path)
    got = PT.load_text_dataset(name, str(tmp_path), **kwargs)
    want = JT.load_text_dataset(name, str(tmp_path), **kwargs)
    assert got == want
    assert len(got) > 0
    assert PT._PUNKT_AVAILABLE == JT._PUNKT_AVAILABLE


def test_document_loaders_equal_to_jax(tmp_path):
    _choi(tmp_path)
    _wiki(tmp_path)
    for path in ("1.ref", "sub/d.ref", "sub/lead.ref"):
        assert PT.load_choi_document(str(tmp_path / path)) == \
            JT.load_choi_document(str(tmp_path / path))
    for kw in ({}, {"high_granularity": False}, {"remove_special_tokens": True}):
        for path in ("article", "doc.txt"):
            assert PT.load_wiki_document(str(tmp_path / path), **kw) == \
                JT.load_wiki_document(str(tmp_path / path), **kw)


@pytest.mark.parametrize("punkt", [None, True, False])
def test_split_sentences_both_branches(monkeypatch, punkt):
    """None: first call decides (punkt if nltk and its data load, else the
    regex); True: punkt tried, the regex if it fails; False: the regex."""
    _pin(monkeypatch, punkt)
    for text in (TEXT, "One sentence. Another one! And a third?", "", "  no stop  "):
        assert PT.split_sentences(text) == JT.split_sentences(text)
        assert PT._PUNKT_AVAILABLE == JT._PUNKT_AVAILABLE
    if punkt is False:
        assert PT.split_sentences(TEXT) == [
            "Dr.", "Smith went to Washington.", "He arrived at 3 p.m.", "on Monday!",
            "Did he meet the senator?", "Nobody knows...", "The end"]


@pytest.mark.parametrize("remove", [False, True])
def test_extract_sentence_words(remove):
    s = "Hello, world! ***LIST*** x_y 42 ***formula*** done."
    assert PT.extract_sentence_words(s, remove) == JT.extract_sentence_words(s, remove)


def test_expand_label_and_dropped_boundaries():
    sents = ["a", "b", "c", "d", "e"]
    for ends in ([1, 3], [4], [], [0, 1, 2, 3, 4], [-1]):
        assert PT.expand_label(ends, sents) == JT.expand_label(ends, sents)
    for labels in ([0, 1, 0, 0, 1], [1, 0, 0, 0, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]):
        assert PT._drop_boundary_sentences(sents, labels) == \
            JT._drop_boundary_sentences(sents, labels)


def test_unknown_corpus_raises(tmp_path):
    for mod in (PT, JT):
        with pytest.raises(ValueError, match="unknown text corpus"):
            mod.load_text_dataset("nope", str(tmp_path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predictions_analysis_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    t, p = (rng.random(n) < 0.3).astype(int).tolist(), (rng.random(n) < 0.3).astype(int).tolist()
    for targets, preds in ((t, p), ([0] * n, [0] * n), (t, t)):
        assert PL.predictions_analysis(targets, preds) == JL.predictions_analysis(targets, preds)


def test_setup_logger_like_jax(tmp_path):
    loggers = []
    for mod, name in ((PL, "torch_port_test_logger"), (JL, "jax_package_test_logger")):
        log_file = tmp_path / f"{name}.log"
        logger = mod.setup_logger(name, str(log_file), level=logging.DEBUG)
        assert mod.setup_logger(name, str(log_file)) is logger  # handlers added once
        logger.info("hello %d", 3)
        for h in logger.handlers:
            h.flush()
        loggers.append((logger, log_file.read_text()))
    (p, p_text), (j, j_text) = loggers
    assert p.level == j.level == logging.DEBUG
    assert [type(h) for h in p.handlers] == [type(h) for h in j.handlers]
    assert [h.formatter._fmt for h in p.handlers] == [h.formatter._fmt for h in j.handlers]
    assert p_text.split(" ", 2)[2] == j_text.split(" ", 2)[2] == "INFO hello 3\n"
    for logger, _ in loggers:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
