"""Inference-side dataset loading and batching (a copy of the parts of the
JAX package's train/data.py that predict uses; the port does not import it).

`pad_batch` pads the unit axis up to bucket sizes; masking makes the padding
numerically invisible.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 3600)

Doc = Tuple[np.ndarray, List[int], str]  # (embeddings [n, d], labels, filename)


def load_dataset_for_inference(embedding_directory: str):
    data = []
    for file in sorted(os.listdir(embedding_directory)):
        emb = np.load(os.path.join(embedding_directory, file)).squeeze()
        if emb.ndim == 1:
            emb = emb[None, :]
        data.append(emb.astype(np.float32))
    return data


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
    """List of docs -> dict of fixed-shape arrays (reference collater
    contract: labels padded with 0 for CRF else -1). `bucket=True` rounds
    the padded length up to a bucket; `pad_batch_to` pads the batch axis
    with zero-length dummy docs."""
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
            # digit-leading filename => RadioNews (reference EncoderDataset.py:36-44)
            domains[i] = 1 if name[:1].isdigit() else 0
    return {
        "src_tokens": src,
        "tgt_tokens": tgt,
        "src_lengths": lengths,
        "domain": domains,
        "n_real": n,
        "ids": [d[2] for d in docs],
    }
