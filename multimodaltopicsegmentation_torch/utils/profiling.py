"""The port's tracer: spans and counts at the layer boundaries of the
encoders, the trainer and the predict loop (counterpart of the JAX package's
utils/profiling.py).

A span is a named interval of `time.perf_counter_ns`, the clock of the
benchmark's window (`time.perf_counter`), with the index of its parent in
`spans()` (the innermost span open on the same thread, -1 at the top), the
thread's id and its counts. Spans record only while tracing is on: while a
torch profiler captures (`device_trace()`, the benchmark's traced runs), or
with MTS_PROFILE=1. While a profiler captures, each span also opens the
range `mts.<name>` on the profiler's host timeline, the clock of the kernels
and copies, so that a device trace can put each idle gap down to the span
that was open when it began. The range is a function-scope record (not a
user annotation, which would cast a shadow interval onto the device's
timeline and count there as device activity). With tracing off, `span()`
returns one shared handle that does nothing: no clock, no record, no range.

No span synchronises the device. Each is one of two kinds:
- wall-true: it ends with its outputs on the host (a pull, or a blocking
  copy from pageable memory, waits for the device), so its host time is its
  real time;
- enqueue only: it ends once its work is queued; its device time is read
  from a device trace through its `mts.<name>` range.

Spans (kind; counts), by where they open:
  encoders/ (every encoder's encode_document)
    encode_document            wall-true; units
  encoders/engine.Wav2Vec2Encoder.encode_document
    encode_document.pack       wall-true (host); pad_units once, bucket_rows per chunk
    encode_document.to_device  wall-true; bytes_to_device (per chunk)
    encode_document.forward    enqueue only
    encode_document.to_host    wall-true; bytes_to_host (the chunk's frames)
    encode_document.slice      wall-true (host): each unit's valid frames
  train/loop.Trainer.fit
    fit                        wall-true; epochs (len of the history)
    fit.build                  wall-true: a new tagger and optimizer
    fit.to_device              wall-true; bytes_to_device (the batches' arrays)
    fit.epoch                  wall-true (host loop): steps, validation, the
                               losses pulled, the learning-rate step
    fit.window                 wall-true (device epochs); epochs
    fit.checkpoint             wall-true; bytes_written (the top-1 snapshot)
    fit.gather                 wall-true: the final weights to the host
  cli/predict.Predictor.predict
    predict                    wall-true; documents, units
    predict.load               wall-true (disk)
    predict.pad                wall-true (host), per chunk of documents
    predict.to_device          wall-true; bytes_to_device, per chunk
    predict.decode             enqueue only (a tagger that pulls inside waits)
    predict.to_host            wall-true: the tags, after the decode
    predict.write              wall-true: segment wavs and results.pkl
  cli/train_fit
    fit_grid, test             wall-true

Environment:
- MTS_PROFILE=1: spans record, and the CLIs (train_fit, predict,
  extract_embeddings) print `report()` at the end of a run;
- MTS_TRACE_DIR=<dir>: `device_trace()` writes a torch.profiler Chrome trace
  into <dir> (the train CLI around each fit, predict and the extractor
  around the whole run); spans record inside it.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List

import torch

_records: List["Span"] = []
_lock = threading.Lock()
_local = threading.local()


def _open() -> list:
    """Indices of this thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span's record, and its handle while it is open. `end` is None
    until it closes."""

    __slots__ = ("name", "start", "end", "parent", "thread", "counts", "_range")

    def __init__(self, name: str, counts: Dict[str, int], profiler: bool):
        self.name, self.counts = name, counts
        self.start = self.end = None
        self._range = torch._C._profiler._RecordFunctionFast("mts." + name) if profiler else None

    def add(self, key: str, n: int):
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        stack = _open()
        self.thread = threading.get_ident()
        self.parent = stack[-1] if stack else -1
        with _lock:
            stack.append(len(_records))
            _records.append(self)
        if self._range is not None:
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open().pop()
        return False


class _Off:
    """The handle of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n: int):
        pass


_OFF = _Off()


def span(name: str, **counts):
    """A span `name` with initial `counts`; its handle's `add(key, n)` adds
    counts known only inside it."""
    profiler = torch.autograd._profiler_enabled()
    if not profiler and os.environ.get("MTS_PROFILE") != "1":
        return _OFF
    return Span(name, counts, profiler)


def spans() -> List[Span]:
    """Every span recorded since the last `reset()`, in the order they opened
    (a span's `parent` indexes this list)."""
    return list(_records)


def reset():
    """Forget the recorded spans (call it with no span open)."""
    with _lock:
        _records.clear()


def report() -> dict:
    """{name: {"calls", "total_s", "self_s", "counts"}} over the closed spans;
    self time is a span's duration less its children's."""
    records = spans()
    children = [0] * len(records)
    for r in records:
        if r.end is not None and r.parent >= 0:
            children[r.parent] += r.end - r.start
    out: Dict[str, dict] = {}
    for r, inner in zip(records, children):
        if r.end is None:
            continue
        row = out.setdefault(r.name, {"calls": 0, "total_s": 0.0, "self_s": 0.0, "counts": {}})
        row["calls"] += 1
        row["total_s"] += (r.end - r.start) / 1e9
        row["self_s"] += (r.end - r.start - inner) / 1e9
        for k, n in r.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + n
    return dict(sorted(out.items()))


def maybe_print_report():
    if os.environ.get("MTS_PROFILE") == "1" and _records:
        print("=== spans: calls, total s, self s, counts ===")
        for name, row in report().items():
            counts = ", ".join(f"{k} {n}" for k, n in row["counts"].items())
            print(f"{name:28s} {row['calls']:6d} {row['total_s']:10.3f} {row['self_s']:10.3f}"
                  f"  {counts}")


@contextlib.contextmanager
def device_trace(logdir: str = None):
    logdir = logdir or os.environ.get("MTS_TRACE_DIR")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
