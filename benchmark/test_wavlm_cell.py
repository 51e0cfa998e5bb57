"""The `wavlm_large_bilstm.predict_audio_wavlm` cell on the CPU at tiny widths
(its weight scales, buckets and traffic kept): a whole run is correct under
the cell's own limits; WavLM's mechanisms each left out of the timed path
(the gate held at 1, the bias P, pre-LN) make it not correct by `emb_gap`; the
model FLOPs; and the two readers of WavLM's spans, by hand."""
import copy
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from mtsbench import harness, roofline, trace, wavlm
from mtsbench.spec import Cell, load_benchmark, load_config, load_limits, load_traffic, metric_reader

NAME = "wavlm_large_bilstm.predict_audio_wavlm"
SEED = 2 ** 33 + 29
TINY = {"conv_dim": [16, 16, 16], "conv_kernel": [10, 3, 3], "conv_stride": [5, 4, 4],
        "hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 4,
        "num_hidden_layers": 2, "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 2}


def tiny_cell() -> Cell:
    config = copy.deepcopy(load_config("wavlm_large_bilstm"))
    traffic = copy.deepcopy(load_traffic("predict_audio_wavlm"))
    config["encoder"].update(TINY)
    config["tagger"].update(embedding_dim=TINY["hidden_size"], hidden_dim=8)
    traffic["documents"] = {"lengths": [3, 9, 6], "order": "loader"}
    traffic.update(encode_chunk=4, check_sample_units=5)
    bench = load_benchmark()
    e2e = [m for m in bench["end_to_end"] if NAME in m.get("workloads", [NAME])]
    per_layer = [m for m in bench["per_layer"] if NAME in m.get("workloads", [NAME])]
    return Cell(NAME, "wavlm_large_bilstm", "predict_audio_wavlm", 1, config, traffic, e2e,
                per_layer, load_limits(NAME))


def run(cell, traced=False, seconds=8.0):
    return harness.run_cell(cell, SEED, seconds, traced, "cpu")


def test_sound_run_is_correct():
    cell = tiny_cell()
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "predict_units_per_s"}
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_span_metrics():
    r = run(tiny_cell(), traced=True, seconds=2.0)
    assert r["correct"], r["checks"]
    # no device here: the spans' metrics read, the device trace's do not
    assert {"glue_share.predict", "encode_ms_per_kunit", "decode_ms_per_kunit", "mfu.predict",
            "frames_to_host_kb_per_unit"} <= set(r["metrics"])
    assert not {"feature_stack_share", "rel_bias_share", "k1_roofline"} & set(r["metrics"])
    frames = (((16000 - 10) // 5 + 1 - 3) // 4 + 1 - 3) // 4 + 1
    assert r["metrics"]["frames_to_host_kb_per_unit"]["value"] == pytest.approx(
        frames * TINY["hidden_size"] * 4 / 1e3, rel=0.05)


def _gate_one(monkeypatch, W):
    monkeypatch.setattr(W._Attention, "gated_bias", lambda self, u, P: P)


def _no_bias(monkeypatch, W):
    monkeypatch.setattr(W.Wav2Vec2, "relative_bias",
                        lambda self, T, device: torch.zeros(self.cfg.num_heads, T, T, device=device))


def _post_ln(monkeypatch, W):
    from mtsbench.spec import driver

    cls = driver("predict_audio_wavlm")
    real = cls.port_encoder_config
    monkeypatch.setattr(cls, "port_encoder_config", lambda self: dataclasses.replace(
        real(self), do_stable_layer_norm=False))


@pytest.mark.parametrize("plant", [_gate_one, _no_bias, _post_ln])
def test_each_mechanism_left_out_is_not_correct(monkeypatch, plant):
    """At the cell's weight scales (mtsbench/wavlm.py) the gate, the bias and
    the pre-LN order each move the pooled embeddings past the cell's limit."""
    from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W

    plant(monkeypatch, W)
    r = run(tiny_cell())
    gap = r["checks"]["emb_gap"]
    assert not r["correct"] and gap["value"] > 10 * gap["limit"], r["checks"]


def test_reference_is_the_programs_model():
    """The reference and the program on the same tiny units, the same seeded
    weights: equal but for rounding."""
    from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
    from mtsbench.spec import driver
    from reference import wavlm as RW

    cell = tiny_cell()
    enc = cell.config["encoder"]
    d = driver("predict_audio_wavlm")(cell, SEED, torch.device("cpu"), "/nonexistent")
    sd = wavlm.weights(enc, SEED, "cpu")
    model = W.build_model(d.port_encoder_config(), sd, "cpu")
    units = torch.randn(5, 16000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(units).mean(dim=1)
    want = RW.pooled_units(sd, enc, units, block=2)
    assert harness.gap_rel(got.numpy(), want.numpy()) < 1e-5


def test_unit_flops_count_the_gate():
    cfg = load_config("wavlm_large_bilstm")["encoder"]
    total = wavlm.unit_flops(cfg, 16000)
    T, D, H, L = 49, 1024, 16, 24
    assert total - roofline.wav2vec2_unit_flops(cfg, 16000) == L * (2 * 64 * 8 * H * T
                                                                     + 2 * H * T * T)
    assert 35.0e9 < total < 36.5e9  # about 35.6 GFLOP a 1-s unit


# -- the readers by hand ----------------------------------------------------------------

def _timeline(names):
    """Host ranges `names` ([(name, start, end)]) on thread 1, each with one
    kernel launched inside (correlation id = its index + 1) running for the
    range's length."""
    host, device = [], []
    for i, (name, a, b) in enumerate(names):
        host.append((a, b, name, 1, 0, 0))
        host.append((a + 1, a + 2, "cudaLaunchKernel", 1, 0, 100 + i))
        device.append((a + 1, a + 1 + (b - a), "k", 0, (100 + i, 0)))
    return trace.Timeline.from_events(device, host, thread_id=1)


def test_feature_and_bias_shares_by_hand():
    fwd = "mts.encode_document.forward"
    tl = _timeline([(fwd, 0, 100), (fwd + ".features", 10, 40), (fwd + ".rel_bias", 40, 45),
                    (fwd + ".gate", 50, 54), (fwd + ".gate", 60, 62),
                    (fwd, 200, 300), (fwd + ".features", 210, 230)])
    run_ = SimpleNamespace(timeline=tl)
    # under .forward: the kernels launched inside it, its own and its children's
    forward = 100 + 30 + 5 + 4 + 2 + 100 + 20
    assert metric_reader("feature_stack_share")(run_) == pytest.approx(100 * 50 / forward)
    assert metric_reader("rel_bias_share")(run_) == pytest.approx(100 * 11 / forward)


@pytest.mark.parametrize("name", ["feature_stack_share", "rel_bias_share"])
def test_readers_give_nothing_without_their_ranges(name):
    assert metric_reader(name)(SimpleNamespace(timeline=None)) is None
    bare = _timeline([("aten::mm", 0, 10)])
    assert metric_reader(name)(SimpleNamespace(timeline=bare)) is None
    # wav2vec2-base's forward: features, no bias
    w2v2 = _timeline([("mts.encode_document.forward", 0, 100),
                      ("mts.encode_document.forward.features", 10, 40)])
    got = metric_reader(name)(SimpleNamespace(timeline=w2v2))
    assert (got is None) == (name == "rel_bias_share")
