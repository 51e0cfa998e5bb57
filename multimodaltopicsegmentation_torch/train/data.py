"""Dataset assembly from precomputed embeddings, and batching (a copy of
the JAX package's train/data.py, numpy only; the port does not import it).

On-disk contract and fold semantics of the reference loader
(utils/load_datasets_precomputed.py): per-document `{doc_id}.npy` float
arrays `[n_units, dim]`, a pickled `labs_dict.pkl` mapping doc_id -> 0/1
boundary list (1 = last unit of a segment), split JSONs
`{"train": [...], "test": [...], "validation": [...]}`.

Replicated quirks (they affect which documents and labels reach training):
- ":Zone.Identifier" artifacts and the 7 hard-excluded Podcast ids skipped;
- `+`-separated embedding dirs concatenated feature-wise (early fusion);
  optional 2 timing features appended;
- final label zeroed per document;
- negative downsampling "mask_inner_sentences" with np seed 1 re-seeded per
  document;
- a standard split consumes the split lists as stacks: train, then test, then
  validation, popping from the END;
- the k-fold `cross_validation_split` layout, with the augmentation path
  provided but off, as the reference always calls it.
- --both_datasets merges the sibling corpus (`add_dataset`), found by the
  RadioNews <-> NonNews name swap at the ../<corpus>/<corpus>/... layout.

`pad_batch` pads the unit axis up to bucket sizes, so that a run sees few
distinct batch shapes; masking makes the padding numerically invisible.
"""
from __future__ import annotations

import json
import os
import pickle
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

# documents too long for the Podcast corpus, excluded by the reference
EXCLUDED_IDS = ("24580", "25539", "25684", "26071", "26214", "26321", "26427")

# default per-length buckets
DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 3600)

Doc = Tuple[np.ndarray, List[int], str]  # (embeddings [n, d], labels, filename)


def load_dataset_from_precomputed(
    embedding_directory: str,
    lab_file: str,
    delete_last_sentence: bool = False,
    inverse_augmentation: bool = False,
    k_folds: int = 5,
    mask_inner_sentences: bool = False,
    mask_probability: float = 0.9,
    split: Optional[str] = None,
    timing_info: Optional[str] = None,
):
    """Returns folds. Standard split: `[[train, test, validation]]`;
    otherwise k-fold list of `[train, test]`.

    `delete_last_sentence` is accepted for CLI-contract parity but — exactly
    as in the reference loader — has no effect (the reference accepts and
    never uses it)."""
    standard_split = split is not None
    if standard_split:
        with open(split) as f:
            split_lists = json.load(f)
        split_lists = {k: list(v) for k, v in split_lists.items()}
        data = [[], [], []]
    else:
        data = []
    original_data: List[Doc] = []

    with open(lab_file, "rb") as f:
        labs = pickle.load(f)
    assert isinstance(labs, dict)

    times = None
    if timing_info is not None:
        with open(timing_info, "rb") as f:
            times = pickle.load(f)

    directories = embedding_directory.split("+")

    # CONTRACT: under a standard split the reference iterates the embedding
    # dir only to BOUND the number of iterations; the document actually
    # loaded comes from consuming the split lists as stacks — train, then
    # test, then validation, popping from the END of each list
    # (load_datasets_precomputed.py:146-156). Fold membership and in-fold
    # document order (hence batch composition) depend on this, so the
    # listdir bound, the skip-before-pop behavior for artifact/excluded
    # entries, and the reversed consumption order are all kept.
    # DELIBERATE DIVERGENCE: the reference iterates os.listdir unsorted
    # (filesystem order — irreproducible across machines); sorting makes
    # k-fold membership deterministic. Standard-split runs are unaffected
    # (membership comes from the split lists, listdir only bounds the loop).
    phase = 0  # 0=train, 1=test, 2=validation (standard split only)
    for file in sorted(os.listdir(directories[0])):
        if file.endswith(":Zone.Identifier"):
            continue
        if file[:-4] in EXCLUDED_IDS:
            continue

        if standard_split:
            if split_lists["train"]:
                file = split_lists["train"].pop()
            elif split_lists["test"]:
                file = split_lists["test"].pop()
                phase = 1
            elif split_lists.get("validation"):
                file = split_lists["validation"].pop()
                phase = 2
            else:
                break

        embs = [
            np.load(os.path.join(root, file)).squeeze().astype(np.float32)
            for root in directories
        ]
        embs = [e[None, :] if e.ndim == 1 else e for e in embs]
        emb = np.concatenate(embs, axis=-1)

        file_name = file[:-4]

        if times is not None:
            emb = np.concatenate(
                [emb, np.asarray(times[file_name], np.float32)], axis=-1
            )

        if len(labs.get(file_name, [])) < 1:
            print(f"warning: skipping {file_name} — empty label entry")
            continue
        lab = list(labs[file_name])
        lab[-1] = 0

        if mask_inner_sentences:
            original_data.append((emb.copy(), list(lab), file))
            # CONTRACT: the reference seeds np.random with 1 PER DOCUMENT and
            # draws one uniform per original unit in order, dropping
            # non-boundary units whose draw exceeds the keep probability
            # (load_datasets_precomputed.py:174-185). Which units survive is
            # observable in every downstream artifact, so the seed, the
            # number of draws, and their order must all be preserved; a
            # single vectorized draw consumes the identical RNG stream.
            np.random.seed(1)
            draws = np.random.rand(len(emb))
            keep = ~((draws > mask_probability) & (np.asarray(lab) == 0))
            emb = np.ascontiguousarray(emb[keep], np.float32)
            lab = [l for l, k in zip(lab, keep) if k]

        if sum(lab) < 1:
            print(f"warning: {file_name} contains no boundary labels after masking")

        doc: Doc = (emb, lab, file)
        if standard_split:
            data[phase].append(doc)
        else:
            data.append(doc)

    if standard_split:
        return [data]

    folds = cross_validation_split(data, num_folds=k_folds, inverse_augmentation=False)
    if mask_inner_sentences:
        for index in range(len(folds)):
            folds[index][1] = [original_data[index]]
    return folds


def cross_validation_split(
    dataset: List[Doc],
    num_folds: int = 5,
    n_test_folds: int = 1,
    inverse_augmentation: bool = False,
):
    """Reference fold layout (load_datasets_precomputed.py:56-100), with the
    optional segment-reversal augmentation of up to 11 training documents."""
    unit_size = len(dataset) // num_folds
    test_size = len(dataset) // num_folds * n_test_folds
    folds = []
    for i in range(num_folds):
        test_start = i * unit_size
        test_end = i * unit_size + test_size
        test = dataset[test_start:test_end]
        if i == num_folds + 1 - n_test_folds:
            test = test + dataset[: test_size // n_test_folds]
            train = dataset[test_size // n_test_folds : -test_size // n_test_folds]
        else:
            train = dataset[:test_start] + dataset[test_end:]

        if inverse_augmentation:
            max_new_programs = 10
            new_docs = []
            for idx, (emb, lab, name) in enumerate(train):
                if max_new_programs < idx:
                    break
                segments, seg_labs = [], []
                start = 0
                cur = []
                for j, l in enumerate(lab):
                    cur.append(l)
                    if l:
                        segments.append(emb[start : j + 1])
                        seg_labs.append(cur)
                        start = j + 1
                        cur = []
                if not segments:
                    continue
                rev_emb = np.concatenate(list(reversed(segments)), axis=0)
                rev_lab = [l for seg in reversed(seg_labs) for l in seg]
                new_docs.append((rev_emb, rev_lab, name + "_inv"))
            train = list(train) + new_docs

        folds.append([list(train), list(test)])
    return folds


def add_dataset(args, folds, fold2: bool = False):
    """Merge the sibling corpus (RadioNews <-> NonNews) into each fold, for
    --both_datasets. The sibling's embedding folder, labels file and split
    JSON are derived from the primary folder's name by the Radio <-> Non swap,
    at the fixed ../<corpus>/<corpus>/... layout, relative to the working
    directory (the reference's load_datasets_precomputed.py contract)."""
    embedding_folder = args.embedding_folder2 if fold2 else args.embedding_folder
    parts = list(os.path.split(embedding_folder))
    if len(parts[0].split(os.path.sep)) > 1:
        parts = parts[0].split(os.path.sep) + parts[1:]

    corpus = parts[0]
    if corpus.startswith("RadioNews"):
        swaps, sibling_split = (("Radio", "Non"), ("radio", "non")), "NonNews_split.json"
    elif corpus.startswith("NonNews"):
        swaps, sibling_split = (("Non", "Radio"), ("non", "radio")), "RadioNews_split.json"
    else:
        raise ValueError(
            f"--both_datasets needs a RadioNews or NonNews embedding folder, got {embedding_folder!r}")
    sibling_root = re.sub(swaps[0][0], swaps[0][1], corpus)
    sibling_tail = [re.sub(swaps[1][0], swaps[1][1], p) for p in parts[1:]]
    split = os.path.join("..", sibling_root, sibling_split)

    new_embedding_folder = os.path.sep.join(["..", sibling_root, sibling_root] + sibling_tail)
    new_lab_folder = os.path.join("..", sibling_root, sibling_root, "labs_dict.pkl")
    if args.standard_split is None:
        split = None

    folds2 = load_dataset_from_precomputed(
        new_embedding_folder,
        new_lab_folder,
        delete_last_sentence=args.delete_last_sentence,
        k_folds=args.k_folds,
        mask_inner_sentences=args.mask_inner_sentences,
        mask_probability=args.mask_probability,
        split=split,
    )
    return [[s + folds2[index][si] for si, s in enumerate(fold)]
            for index, fold in enumerate(folds)]


def load_dataset_for_inference(embedding_directory: str):
    data = []
    for file in sorted(os.listdir(embedding_directory)):
        emb = np.load(os.path.join(embedding_directory, file)).squeeze()
        if emb.ndim == 1:
            emb = emb[None, :]
        data.append(emb.astype(np.float32))
    return data


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_batch(
    docs: List[Doc],
    crf: bool = False,
    truncate: bool = False,
    truncate_value: int = 100,
    bucket: bool = True,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    pad_batch_to: Optional[int] = None,
    domain_adapt: bool = False,
):
    """List of docs -> dict of fixed-shape arrays (reference collater contract,
    EncoderDataset.py:91-152: labels padded with 0 for CRF else -1).

    `bucket=True` rounds the padded length up to a bucket, so that a run sees
    a bounded number of shapes. `pad_batch_to` pads the batch axis with
    zero-length dummy docs (masked out downstream) for a static batch size.
    """
    pad_label = 0.0 if crf else -1.0
    if truncate:
        max_len = truncate_value
    else:
        max_len = max(len(d[0]) for d in docs)
        if bucket:
            max_len = bucket_length(max_len, buckets)

    n = len(docs)
    B = pad_batch_to if pad_batch_to else n
    dim = docs[0][0].shape[-1]
    src = np.zeros((B, max_len, dim), np.float32)
    tgt = np.full((B, max_len), pad_label, np.float32)
    lengths = np.zeros((B,), np.int32)
    domains = np.zeros((B,), np.int32)
    for i, (emb, lab, name) in enumerate(docs):
        L = min(len(emb), max_len)
        src[i, :L] = emb[:L]
        tgt[i, :L] = np.asarray(lab[:L], np.float32)
        lengths[i] = L
        if domain_adapt:
            # digit-leading filename => RadioNews (EncoderDataset.py:36-44)
            domains[i] = 1 if name[:1].isdigit() else 0
    return {
        "src_tokens": src,
        "tgt_tokens": tgt,
        "src_lengths": lengths,
        "domain": domains,
        "n_real": n,
        "ids": [d[2] for d in docs],
    }


def batches(
    docs: List[Doc],
    batch_size: int,
    sort_by_length: bool = False,
    **pad_kwargs,
):
    """Yield padded batches. `sort_by_length` groups similar lengths to cut
    bucket padding waste (off by default to preserve reference batch order)."""
    order = range(len(docs))
    if sort_by_length:
        order = sorted(order, key=lambda i: len(docs[i][0]))
    docs = [docs[i] for i in order]
    for i in range(0, len(docs), batch_size):
        chunk = docs[i : i + batch_size]
        yield pad_batch(chunk, pad_batch_to=batch_size if len(chunk) < batch_size else None, **pad_kwargs)
