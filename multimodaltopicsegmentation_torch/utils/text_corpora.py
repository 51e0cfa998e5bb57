"""Text-corpus loaders (legacy lineage of the reference): a copy of the JAX
package's utils/text_corpora.py (the port does not import that package).

The reference carries pre-audio text-segmentation loaders
(utils/{load_datasets,wiki_loader_sentences,choiloader_sentences,
text_manipulation,wiki_utils}.py) that its audio pipeline imports but never
exercises. This module provides the same capabilities in one place, without
torch Datasets (documents come back as plain (sentences, boundary_labels,
path) tuples the framework's batching layer consumes):

- Choi synthetic corpus: `.ref` files with `==========` segment delimiters
- wiki-727k-style files: `========,<level>,<title>` section separators,
  ***LIST***/***formula***/***codice*** special tokens
- BBC, BBC audio, CNN10 and ICSI corpora
- sentence splitting (nltk punkt when importable, regex otherwise; nltk is
  imported on the first call, never at import) and word extraction matching
  text_manipulation.py semantics
"""
from __future__ import annotations

import os
import re
from glob import glob
from typing import List, Tuple

CHOI_DELIMITER = "=========="
WIKI_SEPARATOR = re.compile(r"^========,\d+,.*?\.?$")
SPECIAL_TOKENS = ("***LIST***", "***formula***", "***codice***")

_MISSING_STOP_PUNCT = re.compile(r"[^.!?]\s*$")
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


_PUNKT_AVAILABLE = None  # decided once: nltk's data-path scan is expensive


def split_sentences(text: str) -> List[str]:
    """Sentence splitting: nltk punkt when importable, regex otherwise
    (text_manipulation.py:80-99 uses punkt; the fallback keeps the same
    segment structure for well-punctuated corpora)."""
    global _PUNKT_AVAILABLE
    if _PUNKT_AVAILABLE is not False:
        try:
            import nltk

            out = nltk.tokenize.sent_tokenize(text)
            _PUNKT_AVAILABLE = True
            return out
        except Exception:
            _PUNKT_AVAILABLE = False
    return [s for s in _SENT_SPLIT.split(text.strip()) if s]


def extract_sentence_words(
    sentence: str, remove_special_tokens: bool = False
) -> List[str]:
    if remove_special_tokens:
        for token in SPECIAL_TOKENS:
            sentence = sentence.replace(token, "")
    return [w for w in re.split(r"\W+", sentence) if w]


def load_choi_document(path: str) -> Tuple[List[str], List[int]]:
    """One .ref file -> (sentences, 0/1 boundary labels, 1 = last sentence
    of a segment)."""
    with open(path, "r", errors="ignore") as f:
        raw = f.read()
    segments = [s.strip() for s in raw.split(CHOI_DELIMITER) if s.strip()]
    sentences, labels = [], []
    for seg in segments:
        seg_sents = [l.strip() for l in seg.splitlines() if l.strip()]
        if not seg_sents:
            continue
        sentences.extend(seg_sents)
        labels.extend([0] * (len(seg_sents) - 1) + [1])
    return sentences, labels


def load_choi_corpus(root: str, delete_last_sentence: bool = False):
    files = sorted(glob(os.path.join(root, "**", "*.ref"), recursive=True))
    docs = []
    for path in files:
        sents, labels = load_choi_document(path)
        if delete_last_sentence and sents:
            sents, labels = _drop_boundary_sentences(sents, labels)
        if sents:
            docs.append((sents, labels, path))
    return docs


def _wiki_sections(text: str, high_granularity: bool = True) -> List[str]:
    """Split a wiki-727 file into sections on separator lines.

    Low granularity splits only on level-1/2 separators; DEEPER separator
    lines are deleted outright (the reference strips them with re.sub
    before splitting, wiki_loader_sentences.py:45-49) — they must never
    surface as content sentences."""
    sections: List[List[str]] = [[]]
    for line in text.splitlines():
        if WIKI_SEPARATOR.match(line.strip()):
            if high_granularity or line.strip().startswith(("========,1,", "========,2,")):
                sections.append([])
            continue
        sections[-1].append(line)
    return ["\n".join(s).strip() for s in sections if "\n".join(s).strip()]


def load_wiki_document(
    path: str,
    remove_preface_segment: bool = True,
    high_granularity: bool = True,
    remove_special_tokens: bool = False,
) -> Tuple[List[str], List[int]]:
    with open(path, "r", errors="ignore") as f:
        text = f.read()
    sections = _wiki_sections(text, high_granularity)
    if remove_preface_segment and sections:
        sections = sections[1:]
    sentences, labels = [], []
    for sec in sections:
        sec_sents = [l.strip() for l in sec.splitlines() if l.strip()]
        if remove_special_tokens:
            sec_sents = [
                s for s in sec_sents if s not in SPECIAL_TOKENS
            ]
        if not sec_sents:
            continue
        sentences.extend(sec_sents)
        labels.extend([0] * (len(sec_sents) - 1) + [1])
    return sentences, labels


def load_wiki_corpus(root: str, delete_last_sentence: bool = False, **kwargs):
    files = sorted(
        p for p in glob(os.path.join(root, "**", "*"), recursive=True)
        if os.path.isfile(p) and not p.endswith((".pkl", ".json"))
    )
    docs = []
    for path in files:
        sents, labels = load_wiki_document(path, **kwargs)
        if delete_last_sentence and sents:
            sents, labels = _drop_boundary_sentences(sents, labels)
        if sents:
            docs.append((sents, labels, path))
    return docs


def expand_label(boundary_indices: List[int], sentences: List[str]) -> List[int]:
    """Sentence indices of segment ends -> dense 0/1 labels
    (utils/load_datasets.py:12-16)."""
    labels = [0] * len(sentences)
    for i in boundary_indices:
        labels[i] = 1
    return labels


def _segments_to_doc(segment_texts: List[str], delete_last_sentence: bool = False):
    """Sentence-tokenize consecutive segment transcripts -> (sentences,
    dense 0/1 labels); the last sentence of each segment is a boundary."""
    sentences: List[str] = []
    ends: List[int] = []
    for seg in segment_texts:
        seg_sents = split_sentences(seg)
        if delete_last_sentence:
            seg_sents = seg_sents[:-1]
        sentences.extend(seg_sents)
        ends.append(len(sentences) - 1)
    ends = [e for e in ends if e >= 0]
    return sentences, (expand_label(ends, sentences) if sentences else [])


def _drop_boundary_sentences(sentences: List[str], labels: List[int]):
    """The reference's delete_last_sentence for dense-labelled documents
    (utils/load_datasets.py:170-181): walk all but the final sentence,
    DROP each boundary sentence and move its boundary to the previously
    kept sentence, then force a final boundary. A leading boundary yields
    index -1, which expand_label applies to the LAST sentence — the
    reference's negative-index quirk, kept."""
    kept: List[str] = []
    ends: List[int] = []
    for idx, sent in enumerate(sentences[:-1]):
        if labels[idx]:
            ends.append(len(kept) - 1)
        else:
            kept.append(sent)
    ends.append(len(kept) - 1)
    if not kept:
        return [], []
    return kept, expand_label(ends, kept)


def load_bbc_corpus(root: str, delete_last_sentence: bool = False):
    """BBC transcript corpus: train.json/test.json with
    {"Transcripts": [{"Items": [segment texts], "Date": ...}]}
    (utils/load_datasets.py:37-95). -> (train_docs, test_docs)."""
    import json

    out = []
    for split_name in ("train", "test"):
        with open(os.path.join(root, f"{split_name}.json")) as f:
            payload = json.load(f)
        docs = []
        for show in payload["Transcripts"]:
            sents, labels = _segments_to_doc(show["Items"], delete_last_sentence)
            if sents:
                docs.append((sents, labels, str(show.get("Date", ""))))
        out.append(docs)
    return tuple(out)


def load_bbc_audio_corpus(root: str, delete_last_sentence: bool = False):
    """AudioBBC/modconhack JSON exports: every *.json under `root` holds
    data.getProgrammeById.segments[*].transcript (utils/load_datasets.py:97-132)."""
    import json

    docs = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith("json"):
                continue
            with open(os.path.join(dirpath, fname)) as f:
                payload = json.load(f)
            segments = payload["data"]["getProgrammeById"]["segments"]
            sents, labels = _segments_to_doc(
                [s["transcript"] for s in segments], delete_last_sentence
            )
            if sents:
                docs.append((sents, labels, os.path.join(dirpath, fname)))
    return docs


def load_cnn_corpus(root: str, n_docs: int = 10, delete_last_sentence: bool = False):
    """CNN10: doc1.txt..doc10.txt, sections separated by '====' lines
    (utils/load_datasets.py:135-164). A leading separator line is ignored
    (the reference would hit an undefined variable there — defect not
    copied, SURVEY.md §7)."""
    docs = []
    for i in range(1, n_docs + 1):
        path = os.path.join(root, f"doc{i}.txt")
        with open(path, errors="ignore") as f:
            text = f.read()
        segment_texts = [
            part.strip()
            for part in re.split(r"^====.*$", text, flags=re.MULTILINE)
            if part.strip()
        ]
        sents, labels = _segments_to_doc(segment_texts, delete_last_sentence)
        if sents:
            docs.append((sents, labels, path))
    return docs


def load_icsi_corpus(root: str, delete_last_sentence: bool = False):
    """ICSI meeting corpus (mrda+hs layout): `segments/` holds one file per
    meeting with a float segment-end time per line; `data/` holds CSVs whose
    first column is `id_start_end` (start in ms) and second column the
    utterance text (utils/load_datasets.py:186-251).

    Label semantics preserved from the reference: walking utterances in
    order, when an utterance's start passes the next segment-end time the
    PREVIOUS utterance is marked a boundary (at most one segment advance per
    utterance); the final utterance is always a boundary.
    """
    import csv

    seg_dir = os.path.join(root, "segments")
    data_dir = os.path.join(root, "data")
    seg_files = os.listdir(seg_dir)
    docs = []
    for dirpath, _dirs, files in os.walk(data_dir):
        for fname in sorted(files):
            if fname.endswith("dadb"):
                continue
            matches = [s for s in seg_files if re.search(re.escape(fname[:-6]), s)]
            if not matches:
                continue
            # CONTRACT: a segments file containing ANY line without a float
            # timestamp drops the whole meeting (the reference indexes the
            # first regex hit inside a try whose except skips the file,
            # utils/load_datasets.py:203-212) — corpus composition must match
            seg_ends = []
            bad_line = False
            with open(os.path.join(seg_dir, matches[0])) as f:
                for line in f:
                    found = re.findall(r"\d+\.\d+", line)
                    if not found:
                        bad_line = True
                        break
                    seg_ends.append(float(found[0]))
            if bad_line:
                continue

            texts, starts = [], []
            with open(os.path.join(dirpath, fname)) as f:
                for row in csv.reader(f):
                    if len(row) < 2:
                        continue
                    texts.append(row[1])
                    starts.append(int(row[0].split("_")[1]))

            labels: List[int] = []
            kept_texts: List[str] = []
            seg_idx = 0
            for start, text in zip(starts, texts):
                if seg_idx < len(seg_ends) and start > seg_ends[seg_idx] * 1000:
                    if seg_idx > 0 and labels:
                        if delete_last_sentence:
                            # drop the boundary utterance, promote the one before
                            if len(labels) >= 2:
                                labels[-2] = 1
                            labels.pop()
                            kept_texts.pop()
                        else:
                            labels[-1] = 1
                    seg_idx += 1
                labels.append(0)
                kept_texts.append(text)
            if not labels:
                continue
            labels[-1] = 1
            docs.append((kept_texts, labels, os.path.join(dirpath, fname)))
    return docs


def load_text_dataset(name: str, root: str, **kwargs):
    """Dispatch matching the reference's corpus names
    (utils/load_datasets.py load_dataset branches)."""
    name = name.lower()
    if name == "choi":
        return load_choi_corpus(root, **kwargs)
    if name in ("wiki", "wiki727", "wikisection"):
        return load_wiki_corpus(root, **kwargs)
    if name == "bbc":
        return load_bbc_corpus(root, **kwargs)
    if name == "bbcaudio":
        return load_bbc_audio_corpus(root, **kwargs)
    if name == "cnn":
        return load_cnn_corpus(root, **kwargs)
    if name == "icsi":
        return load_icsi_corpus(root, **kwargs)
    raise ValueError(f"unknown text corpus {name!r}")
