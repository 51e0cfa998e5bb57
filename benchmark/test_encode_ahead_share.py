"""`encode_ahead_share`: by hand on synthetic spans, nothing from a program
without the `ahead` count, and read in a traced run of the tiny audio cell on
the CPU."""
from types import SimpleNamespace

import pytest

from mtsbench.spec import metric_reader
from test_mtsbench_runs import run, tiny_cell
from test_mtsbench_spans import _capture_run, _in_window

MS = 1_000_000  # ns
READ = "encode_ahead_share"


def _span(name, start_ms, end_ms, parent=-1, **counts):
    return SimpleNamespace(name=name, start=start_ms * MS, end=end_ms * MS, parent=parent,
                           thread=1, counts=counts)


def _window(records, monkeypatch):
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return SimpleNamespace(t0=0.1, loop_end=10.0, timeline=None)


def test_ahead_share_by_hand(monkeypatch):
    records = [_span("encode_document", 200, 400, units=10),
               _span("encode_document.forward", 210, 220, parent=0, ahead=0),
               _span("encode_document.forward", 230, 240, parent=0, ahead=1),
               _span("encode_document.forward", 250, 260, parent=0, ahead=1),
               _span("encode_document", 500, 600, units=3),
               _span("encode_document.forward", 510, 520, parent=4, ahead=0),
               _span("encode_document", 50, 150, units=3),  # begun before the window
               _span("encode_document.forward", 60, 70, parent=6, ahead=1)]
    # 2 of the 4 chunks inside the window's documents
    assert metric_reader(READ)(_window(records, monkeypatch)) == pytest.approx(50.0)


def test_ahead_share_reads_nothing_without_the_count(monkeypatch):
    from multimodaltopicsegmentation_torch.utils import profiling

    # a program whose forward spans carry no `ahead` (a loop that never runs ahead)
    records = [_span("encode_document", 200, 400, units=4),
               _span("encode_document.forward", 210, 220, parent=0),
               _span("encode_document.forward", 230, 240, parent=0)]
    assert metric_reader(READ)(_window(records, monkeypatch)) is None
    assert metric_reader(READ)(_window([], monkeypatch)) is None
    monkeypatch.delattr(profiling, "spans")
    assert metric_reader(READ)(SimpleNamespace(t0=0.0, loop_end=1.0, timeline=None)) is None


def test_traced_predict_run_reads_the_ahead_share(monkeypatch):
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.delenv("MTS_PROFILE", raising=False)
    profiling.reset()
    cell = tiny_cell("w2v2base_bilstm", "predict_audio")
    cell.per_layer = [{"name": READ, "unit": "%"}]
    seen = _capture_run(monkeypatch)
    r = run(cell, traced=True)
    assert r["correct"]
    # documents of 3, 9 and 6 units in chunks of 4: every chunk but a document's first
    records = profiling.spans()
    docs = {records.index(d) for d in _in_window(seen["run"], "encode_document")}
    chunks = [-(-records[i].counts["units"] // cell.traffic["encode_chunk"]) for i in docs]
    assert sum(chunks) > len(docs)
    assert r["metrics"][READ]["value"] == pytest.approx(
        100.0 * (sum(chunks) - len(docs)) / sum(chunks))
    profiling.reset()
