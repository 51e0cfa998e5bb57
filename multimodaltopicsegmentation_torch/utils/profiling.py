"""Tracing and profiling hooks (counterpart of the JAX package's
utils/profiling.py).

- `stage(name)`: wall-clock context manager adding to per-stage totals
  (extraction, encode, train epoch, decode, metrics);
- `device_trace(logdir)`: a torch.profiler trace (CPU and, when a card is
  present, CUDA activity) written as a Chrome trace into `logdir`;
- `report()`: per-stage totals for logs and results.

The training extractor (cli/extract_embeddings.py) times each document's
encode as a stage, prints the totals with MTS_PROFILE=1 and traces its run
into MTS_TRACE_DIR=<dir> when that is set.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_totals = defaultdict(float)
_counts = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _totals[name] += time.perf_counter() - t0
        _counts[name] += 1


@contextlib.contextmanager
def device_trace(logdir: str = None):
    logdir = logdir or os.environ.get("MTS_TRACE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def report() -> dict:
    return {
        name: {"total_s": _totals[name], "calls": _counts[name]}
        for name in sorted(_totals)
    }


def reset():
    _totals.clear()
    _counts.clear()


def maybe_print_report():
    if os.environ.get("MTS_PROFILE") == "1" and _totals:
        print("=== stage timings ===")
        for name, info in report().items():
            print(f"{name:30s} {info['total_s']:8.3f} s  ({info['calls']} calls)")
