"""The `w2vbert2_bilstm.predict_audio_w2vbert` cell on the CPU at tiny widths
(its weight scales, distances, kernel and traffic kept): a whole run is
correct under the cell's own limits; w2v-BERT's mechanisms each left out of
the timed path make it not correct by `emb_gap`; a program without w2v-BERT
stops at once; the model FLOPs; and the three new readers, by hand."""
import copy
import sys
from types import SimpleNamespace

import pytest
import torch

from mtsbench import harness, roofline, trace, w2v_bert
from mtsbench.spec import Cell, load_benchmark, load_config, load_limits, load_traffic, metric_reader

NAME = "w2vbert2_bilstm.predict_audio_w2vbert"
SEED = 2 ** 33 + 41
TINY = {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 4,
        "num_hidden_layers": 2}


def tiny_cell() -> Cell:
    config = copy.deepcopy(load_config("w2vbert2_bilstm"))
    traffic = copy.deepcopy(load_traffic("predict_audio_w2vbert"))
    config["encoder"].update(TINY)
    config["tagger"].update(embedding_dim=TINY["hidden_size"], hidden_dim=8)
    traffic["documents"] = {"lengths": [3, 9, 6], "order": "loader"}
    traffic.update(encode_chunk=4, check_sample_units=5)
    bench = load_benchmark()
    e2e = [m for m in bench["end_to_end"] if NAME in m.get("workloads", [NAME])]
    per_layer = [m for m in bench["per_layer"] if NAME in m.get("workloads", [NAME])]
    return Cell(NAME, "w2vbert2_bilstm", "predict_audio_w2vbert", 1, config, traffic, e2e,
                per_layer, load_limits(NAME))


def run(cell, traced=False, seconds=8.0):
    return harness.run_cell(cell, SEED, seconds, traced, "cpu")


def test_sound_run_is_correct():
    r = run(tiny_cell())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "predict_units_per_s"}
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_span_metrics():
    r = run(tiny_cell(), traced=True, seconds=2.0)
    assert r["correct"], r["checks"]
    # no device here: the spans' metrics read, the device trace's do not
    assert {"glue_share.predict", "encode_ms_per_kunit", "decode_ms_per_kunit", "mfu.predict",
            "frames_to_host_kb_per_unit", "encode_ahead_share"} <= set(r["metrics"])
    assert not {"conv_module_share", "rel_key_share", "conformer_linear_roofline",
                "feature_stack_share", "k1_roofline"} & set(r["metrics"])
    assert r["metrics"]["frames_to_host_kb_per_unit"]["value"] == pytest.approx(
        49 * TINY["hidden_size"] * 4 / 1e3, rel=0.05)


def _half_step_dropped(monkeypatch, B, K):
    monkeypatch.setattr(B._ConformerLayer, "ffn_scale", 1.0)


def _no_relative_key(monkeypatch, B, K):
    monkeypatch.setattr(B._SelfAttention, "relative_key_bias", lambda self, q, index: None)


def _no_clamp(monkeypatch, B, K):
    def wraps(T, left, right, device=None):
        pos = torch.arange(T, device=device)
        return (pos[None, :] - pos[:, None] + left) % (left + right + 1)

    monkeypatch.setattr(B, "relative_key_index", wraps)


def _centred_conv(monkeypatch, B, K):
    def centred(x, weight):
        k = weight.shape[-1]
        y = torch.nn.functional.conv1d(torch.nn.functional.pad(x.transpose(1, 2), (k // 2, k // 2)),
                                       weight, groups=weight.shape[0])
        return y.transpose(1, 2)

    monkeypatch.setattr(B, "causal_depthwise_conv", centred)


def _no_bin_norm(monkeypatch, B, K):
    monkeypatch.setattr(K, "normalize_bins", lambda feats, frames: feats)


@pytest.mark.parametrize("plant", [_half_step_dropped, _no_relative_key, _no_clamp,
                                   _centred_conv, _no_bin_norm])
def test_each_mechanism_left_out_is_not_correct(monkeypatch, plant):
    """At the cell's weight scales (mtsbench/w2v_bert.py) the FFNs' half step,
    the relative-key term, its clamp at +8, the causal pad and the fbank's
    per-bin normalisation each move the pooled embeddings past the cell's
    limit. (The mask before the depthwise conv reaches only padded frames,
    which pooling never reads: tests/test_torch_w2v_bert.py holds it.)"""
    from multimodaltopicsegmentation_torch.dsp import kaldi_fbank as K
    from multimodaltopicsegmentation_torch.encoders import w2v_bert as B

    plant(monkeypatch, B, K)
    r = run(tiny_cell(), seconds=2.0)
    gap = r["checks"]["emb_gap"]
    assert not r["correct"] and gap["value"] > 10 * gap["limit"], r["checks"]


def test_program_without_w2v_bert_stops_at_once(monkeypatch):
    """The parent of this cell has no encoders/w2v_bert.py: its run ends with
    an ImportError before any kernel is built or weight drawn."""
    from multimodaltopicsegmentation_torch import encoders

    monkeypatch.setitem(sys.modules, "multimodaltopicsegmentation_torch.encoders.w2v_bert", None)
    monkeypatch.delattr(encoders, "w2v_bert")
    with pytest.raises(ImportError):
        run(tiny_cell())


def test_reference_is_the_programs_model():
    """The reference and the program on the same tiny units, the same seeded
    weights (the program's through its checkpoint loader): equal but for
    rounding."""
    from multimodaltopicsegmentation_torch.encoders import w2v_bert as B
    from reference import w2v_bert as RB

    enc = tiny_cell().config["encoder"]
    cfg = B.W2VBertConfig.from_hf(enc)
    sd = w2v_bert.weights(enc, SEED, "cpu")
    model = B.build_model(cfg, B.load_hf_state_dict(sd, cfg), "cpu")
    units = torch.randn(5, 16000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(units).mean(dim=1)
    want = RB.pooled_units(sd, enc, units, block=2)
    assert harness.gap_rel(got.numpy(), want.numpy()) < 1e-5


def test_unit_flops_by_hand():
    cfg = load_config("w2vbert2_bilstm")["encoder"]
    t, D, F, H, L = 49, 1024, 4096, 16, 24
    assert w2v_bert.frames(16000) == t
    linears = 14 * D * D + 8 * D * F
    per_layer = linears + 4 * t * D + 2 * 73 * D + H * t + 2 * 31 * D
    assert w2v_bert.unit_flops(cfg, 16000) == t * (2 * 160 * D + L * per_layer)
    assert 56.5e9 < w2v_bert.unit_flops(cfg, 16000) < 57.5e9  # about 57.2 GFLOP a 1-s unit
    from metrics.conformer_linear_roofline import unit_linear_flops

    assert unit_linear_flops(cfg, 16000) == t * (2 * 160 * D + L * linears)


def test_weights_are_the_checkpoints_leaves():
    """The drawn leaves are exactly `Wav2Vec2BertModel`'s parameters (names
    and shapes), at the tiny widths."""
    transformers = pytest.importorskip("transformers")
    enc = tiny_cell().config["encoder"]
    hf = transformers.Wav2Vec2BertModel(transformers.Wav2Vec2BertConfig(
        **{k: v for k, v in enc.items() if k not in ("architectures", "model_type")},
        mask_time_prob=0.0))
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    got = {name: shape for name, shape, _, _ in w2v_bert.leaves(enc)}
    assert got == want


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


def test_conv_module_and_rel_key_shares_by_hand():
    fwd = "mts.encode_document.forward"
    tl = _timeline([(fwd, 0, 100), (fwd + ".features", 10, 12), (fwd + ".rel_key", 20, 23),
                    (fwd + ".conv_module", 30, 40), (fwd + ".rel_key", 50, 51),
                    (fwd + ".conv_module", 60, 70), (fwd, 200, 300), (fwd + ".conv_module", 210, 215)])
    run_ = SimpleNamespace(timeline=tl)
    # under .forward: the kernels launched inside it, its own and its children's
    forward = 100 + 2 + 3 + 10 + 1 + 10 + 100 + 5
    assert metric_reader("conv_module_share")(run_) == pytest.approx(100 * 25 / forward)
    assert metric_reader("rel_key_share")(run_) == pytest.approx(100 * 4 / forward)
    assert metric_reader("feature_stack_share")(run_) == pytest.approx(100 * 2 / forward)


@pytest.mark.parametrize("name", ["conv_module_share", "rel_key_share"])
def test_share_readers_give_nothing_without_their_ranges(name):
    assert metric_reader(name)(SimpleNamespace(timeline=None)) is None
    bare = _timeline([("aten::mm", 0, 10)])
    assert metric_reader(name)(SimpleNamespace(timeline=bare)) is None
    # wav2vec2 or WavLM's forward: features, no conformer range
    w2v2 = _timeline([("mts.encode_document.forward", 0, 100),
                      ("mts.encode_document.forward.features", 10, 40)])
    assert metric_reader(name)(SimpleNamespace(timeline=w2v2)) is None


KERNEL = "void (anonymous namespace)::linear_tf32x3_kernel(CUtensorMap_st, CUtensorMap_st)"


class _Kernels:
    def __init__(self, events):
        self.events = events  # [(name, seconds)]

    def matching(self, pred):
        hits = [s for name, s in self.events if pred(name)]
        return sum(hits), len(hits)


def _linear_run(units, events, launches):
    cell = SimpleNamespace(config={"encoder": load_config("w2vbert2_bilstm")["encoder"]},
                           traffic={"interval_s": 1})
    return SimpleNamespace(cell=cell, completions=[(1.0, u, 0.0) for u in units],
                           timeline=_Kernels(events), launches=launches)


def test_conformer_linear_roofline_by_hand():
    from metrics.conformer_linear_roofline import COUNTER, unit_linear_flops

    read = metric_reader("conformer_linear_roofline")
    enc = load_config("w2vbert2_bilstm")["encoder"]
    events = [(KERNEL, 0.5), (KERNEL, 0.5), ("other", 1.0)]
    want = 100.0 * 1000 * unit_linear_flops(enc, 16000) / roofline.F32_ACCURATE_FLOP_PER_S / 1.0
    assert read(_linear_run([300, 700], events, {COUNTER: 2})) == pytest.approx(want)
    # counts that disagree, a program without the kernel, no trace, nothing finished
    assert read(_linear_run([300, 700], events, {COUNTER: 3})) is None
    assert read(_linear_run([300], [("sm80_xmma_gemm", 1.0)], {})) is None
    no_trace = _linear_run([300], events, {COUNTER: 2})
    no_trace.timeline = None
    assert read(no_trace) is None
    assert read(_linear_run([], events, {COUNTER: 2})) is None
