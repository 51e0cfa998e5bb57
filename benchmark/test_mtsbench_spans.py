"""The readers of the program's own spans: by hand on synthetic spans and
timelines, and in whole traced runs of the tiny cells on the CPU."""
from types import SimpleNamespace

import pytest

from mtsbench import harness, trace
from mtsbench.spec import load_benchmark, metric_reader
from test_mtsbench_runs import CELLS, run, tiny_cell

MS = 1_000_000  # ns


def _span(name, start_ms, end_ms, parent=-1, **counts):
    return SimpleNamespace(name=name, start=start_ms * MS, end=end_ms * MS, parent=parent,
                           thread=1, counts=counts)


def _window(records, monkeypatch, timeline=None, t0_ms=100, end_ms=10_000):
    """A run whose window is [t0_ms, end_ms] on the perf_counter clock, with
    `records` as the program's spans."""
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return SimpleNamespace(t0=t0_ms / 1e3, loop_end=end_ms / 1e3, timeline=timeline)


# -- the readers by hand ----------------------------------------------------------------

def test_encode_idle_reader_by_hand(monkeypatch):
    # device busy [0, 10], [20, 30], [45, 50], [60, 70] ms
    device = [(a * MS, b * MS, "k", 0, (0, 0)) for a, b in ((0, 10), (20, 30), (45, 50), (60, 70))]
    host = [(5 * MS, 50 * MS, "mts.encode_document", 1, 0, 0),
            (18 * MS, 48 * MS, "mts.encode_document.to_host", 1, 0, 0),
            (49 * MS, 70 * MS, "mts.encode_document", 2, 0, 0),  # another thread's
            (0, 100 * MS, trace.SPAN_PREFIX + trace.WINDOW, 1, 0, 0)]
    tl = trace.Timeline.from_events(device, host, thread_id=1)
    records = [_span("encode_document", 200, 300, units=500),
               _span("encode_document", 50, 150, units=9999)]  # begun before the window
    run_ = _window(records, monkeypatch, tl)
    # gaps that began at 10 and 30 ms (inside the ranges) count, 10 + 15 ms;
    # the one at 50 ms began as the range ended
    assert metric_reader("encode_idle_ms_per_kunit")(run_) == pytest.approx(25 / 0.5)
    assert metric_reader("encode_idle_ms_per_kunit")(_window([], monkeypatch, tl)) is None
    bare = trace.Timeline.from_events(device, host[3:], thread_id=1)
    assert metric_reader("encode_idle_ms_per_kunit")(_window(records, monkeypatch, bare)) is None


def test_frames_to_host_reader_by_hand(monkeypatch):
    records = [_span("encode_document", 200, 400, units=10),
               _span("encode_document.to_host", 210, 250, parent=0, bytes_to_host=100_000),
               _span("encode_document.to_host", 300, 350, parent=0, bytes_to_host=50_000),
               _span("encode_document", 50, 150, units=3),  # begun before the window
               _span("encode_document.to_host", 60, 70, parent=3, bytes_to_host=10 ** 9)]
    assert metric_reader("frames_to_host_kb_per_unit")(_window(records, monkeypatch)) == \
        pytest.approx(15.0)


def test_epoch_span_reader_by_hand(monkeypatch):
    records = [_span("fit", 200, 1000), _span("fit.epoch", 300, 400, parent=0),
               _span("fit.epoch", 400, 600, parent=0), _span("fit.epoch", 10, 500)]
    assert metric_reader("epoch_span_ms.train")(_window(records, monkeypatch)) == \
        pytest.approx(150.0)


def test_fit_overhead_reader_by_hand(monkeypatch):
    records = [_span("fit", 1000, 2000, epochs=2), _span("fit.build", 1000, 1050, parent=0),
               _span("fit.epoch", 1100, 1500, parent=0), _span("fit.epoch", 1500, 1900, parent=0),
               _span("fit.checkpoint", 1900, 2000, parent=0),
               _span("fit", 20, 900), _span("fit.epoch", 30, 40, parent=5),  # before the window
               _span("fit", 3000, 3100), _span("fit.window", 3000, 3090, parent=7)]
    # (1000 - 800) + (100 - 90) ms outside the epochs, of 1100 ms
    assert metric_reader("fit_overhead_share.train")(_window(records, monkeypatch)) == \
        pytest.approx(100 * 210 / 1100)


@pytest.mark.parametrize("name", ["encode_idle_ms_per_kunit", "frames_to_host_kb_per_unit",
                                  "epoch_span_ms.train", "fit_overhead_share.train"])
def test_span_readers_find_nothing_in_a_program_without_spans(monkeypatch, name):
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    tl = trace.Timeline.from_events([(0, 10, "k", 0, (0, 0)), (20, 30, "k", 0, (0, 0))],
                                    [(0, 30, "aten::mm", 1, 0, 0)], thread_id=1)
    run_ = SimpleNamespace(t0=0.0, loop_end=1.0, timeline=tl)
    assert metric_reader(name)(run_) is None


# -- the program's own spans in the window of a whole run ----------------------------------

def _per_layer(cell_name):
    return [m for m in load_benchmark()["per_layer"] if cell_name in m["workloads"]]


def _capture_run(monkeypatch):
    """The Run that the harness hands its readers."""
    seen = {}
    real = harness.read_metrics

    def read_metrics(metrics, run_):
        seen["run"] = run_
        return real(metrics, run_)

    monkeypatch.setattr(harness, "read_metrics", read_metrics)
    return seen


def _in_window(run_, name):
    from multimodaltopicsegmentation_torch.utils import profiling

    t0, t1 = run_.t0 * 1e9, run_.loop_end * 1e9
    return [r for r in profiling.spans() if r.name == name and t0 <= r.start and r.end <= t1]


def test_traced_predict_run_reads_the_encoders_spans(monkeypatch):
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.delenv("MTS_PROFILE", raising=False)
    profiling.reset()
    cell = tiny_cell("w2v2base_bilstm", "predict_audio")
    cell.per_layer = _per_layer(cell.name)
    seen = _capture_run(monkeypatch)
    r = run(cell, traced=True)
    assert r["correct"]
    # no device here: the frames' count reads, the device's idle does not
    assert "frames_to_host_kb_per_unit" in r["metrics"]
    assert "encode_idle_ms_per_kunit" not in r["metrics"]
    hidden = cell.config["encoder"]["hidden_size"]
    # frames of a whole 1-s unit through the tiny convs (kernels 10 and 3, strides 5 and 2)
    frames = (((16000 - 10) // 5 + 1) - 3) // 2 + 1
    assert r["metrics"]["frames_to_host_kb_per_unit"]["value"] == pytest.approx(
        frames * hidden * 4 / 1e3, rel=0.05)
    # the program's encode_document spans against the benchmark's host timer
    run_ = seen["run"]
    inside = sum(s.end - s.start for s in _in_window(run_, "encode_document")) / 1e9
    assert inside == pytest.approx(run_.spans["encode"], rel=0.02)
    assert sum(s.counts["units"] for s in _in_window(run_, "encode_document")) == \
        run_.span_units["encode"]
    profiling.reset()


def test_traced_train_run_reads_the_trainers_spans(monkeypatch):
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.delenv("MTS_PROFILE", raising=False)
    profiling.reset()
    cell = tiny_cell("transformer_longdoc", "train_1s")
    cell.per_layer = _per_layer(cell.name)
    seen = _capture_run(monkeypatch)
    r = run(cell, traced=True)
    assert r["correct"]
    assert {"epoch_span_ms.train", "fit_overhead_share.train"} <= set(r["metrics"])
    assert 0 < r["metrics"]["fit_overhead_share.train"]["value"] < 100
    run_ = seen["run"]
    fits = _in_window(run_, "fit")
    assert len(fits) == len(run_.completions) == r["attempted"]
    assert sum(f.counts["epochs"] for f in fits) == r["attempted"] * cell.traffic["epochs_per_fit"]
    # each fit's span against the harness's host time around its call
    host = sum(v * cell.traffic["epochs_per_fit"] for v in run_.samples["epoch_ms"]) / 1e3
    assert sum(f.end - f.start for f in fits) / 1e9 == pytest.approx(host, rel=0.01)
    profiling.reset()


@pytest.mark.parametrize("config,mix", CELLS[::3])
def test_untraced_run_records_no_span(monkeypatch, config, mix):
    from multimodaltopicsegmentation_torch.utils import profiling

    monkeypatch.delenv("MTS_PROFILE", raising=False)
    profiling.reset()
    r = run(tiny_cell(config, mix))
    assert r["correct"] and profiling.spans() == []
