"""The one generator that every traffic mix (`traffic/<name>.json`) feeds.

Document lengths come from the RadioNews-SBBC corpus record
(`data/radionews.json`, a frozen copy of the repository's sentence-timing
pickle and split): a document's units are its sentences, or its whole
seconds (the predict path's 1-s units). A mix names the sets it takes
("train", "validation", "test" of the split, or "all"), the unit, and an
order. The lengths and their order are fixed by the mix, so that every seed
asks for the same work; `--seed` draws the content (audio, embeddings,
labels), the weights and the samples the output check reads.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import List, Tuple

import numpy as np

from .spec import BENCH_DIR

RECORDS = os.path.join(BENCH_DIR, "data", "radionews.json")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one use of `--seed` (weights, data, samples, ...)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def load_records() -> dict:
    with open(RECORDS) as f:
        return json.load(f)


def _units(record: dict, unit: str) -> int:
    if unit == "sentences":
        return int(record["sentences"])
    if unit == "seconds":
        return int(record["seconds"] // 1)  # the 1-s units of inference_uniform_units
    raise ValueError(f"unknown unit {unit!r}")


def set_ids(records: dict, name: str) -> List[str]:
    """The ids of one set, in the order the corpus loader yields them: the
    split's lists are consumed from their end; "all" is every document by id."""
    if name == "all":
        return sorted(records["documents"])
    return list(reversed(records["split"][name]))


def documents(spec: dict, max_units: int = None) -> List[Tuple[str, int]]:
    """[(id, units)] of a mix's `documents` entry: its `sets` in order (or its
    given `lengths`), each
    document's units cut at `max_units` (the configuration's cut) if given,
    then put in the mix's `order`: "loader" keeps the loader's order;
    "stride:<k>" sorts by length and takes every k-th, cyclically, so that
    every prefix spans the corpus's range of lengths."""
    if "lengths" in spec:  # a mix of given lengths
        docs = [(f"doc{i:03d}", int(n)) for i, n in enumerate(spec["lengths"])]
    else:
        records = load_records()
        ids = [i for s in spec["sets"] for i in set_ids(records, s)]
        docs = [(i, _units(records["documents"][i], spec["unit"])) for i in ids]
    if max_units:
        docs = [(i, min(n, max_units)) for i, n in docs]
    order = spec.get("order", "loader")
    if order.startswith("stride:"):
        k = int(order.split(":")[1])
        by_len = sorted(docs, key=lambda d: (d[1], d[0]))
        if np.gcd(k, len(by_len)) != 1:
            raise ValueError(f"stride {k} must be prime to the {len(by_len)} documents")
        docs = [by_len[(j * k) % len(by_len)] for j in range(len(by_len))]
    elif order != "loader":
        raise ValueError(f"unknown order {order!r}")
    return docs


def boundary_labels(n: int, every: float, r: np.random.Generator) -> List[int]:
    """0/1 labels with a boundary (1 = a segment's last unit) after about
    every `every` units; the final label is 0, as the corpus loader leaves it."""
    labels = (r.random(n) < 1.0 / every).astype(int)
    labels[-1] = 0
    return labels.tolist()
