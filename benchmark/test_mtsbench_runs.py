"""Whole runs of every driver on the CPU at tiny widths (the harness's look
for a card skipped): sound runs pass the check under the cells' own limits,
and runs with the timed path broken underneath come out not correct."""
import numpy as np
import pytest
import torch

import tiny
from mtsbench import harness, trace
from mtsbench.spec import load_limits

CELLS = [("w2v2base_bilstm", "predict_audio"), ("w2v2base_bilstm", "train_sentences"),
         ("transformer_longdoc", "predict_1s"), ("transformer_longdoc", "train_1s")]
SEED = 2 ** 33 + 17


def tiny_cell(config, mix):
    c = tiny.cell(config, mix)
    c.limits = load_limits(f"{config}.{mix}")
    return c


def run(cell, traced=False, seconds=0.5):
    return harness.run_cell(cell, SEED, seconds, traced, "cpu")


@pytest.mark.parametrize("config,mix", CELLS)
def test_sound_run_is_correct(config, mix):
    cell = tiny_cell(config, mix)
    r = run(cell, seconds=8.0)  # long enough for a work item to finish on a busy CPU
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["metrics"]["setup_s"]["value"] > 0
    # every end-to-end metric of the cell, each read by its own file
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"


def test_traced_run_reads_its_metrics():
    cell = tiny_cell("w2v2base_bilstm", "predict_audio")
    from mtsbench.spec import load_benchmark

    cell.per_layer = [m for m in load_benchmark()["per_layer"]
                      if "w2v2base_bilstm.predict_audio" in m["workloads"]]
    r = run(cell, traced=True)
    assert r["correct"]
    # no device here: the spans' metrics read, the device's do not
    assert {"glue_share.predict", "encode_ms_per_kunit", "decode_ms_per_kunit",
            "mfu.predict"} <= set(r["metrics"])
    assert "k1_roofline" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_reference_init_is_the_trainers():
    from multimodaltopicsegmentation_torch.models import registry
    from reference import train as RT

    for config, mix in CELLS[1::2]:
        tc = tiny_cell(config, mix).config["tagger"]
        tagger = registry.build(tc["architecture"], harness.tagger_config(tc),
                                torch.Generator().manual_seed(SEED))
        want = type(tagger).from_jax_params(
            {k: v for k, v in __import__("mtsbench.weights", fromlist=["to_numpy"]).to_numpy(
                RT.initial_params(tc, SEED)).items()})
        for name, p in tagger.named_parameters():
            torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=0)


# -- faults planted in the timed path -------------------------------------------------

@pytest.mark.parametrize("config,mix", CELLS[1::2])
def test_unchanged_state_fails(monkeypatch, config, mix):
    from multimodaltopicsegmentation_torch.train import loop

    monkeypatch.setattr(loop.Optimizer, "step", lambda self, closure=None: None)
    r = run(tiny_cell(config, mix))
    assert not r["correct"] and r["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("config,mix", CELLS[1::2])
def test_half_batch_fails(monkeypatch, config, mix):
    from multimodaltopicsegmentation_torch.train import loop

    whole = loop.tagger_loss

    def half(tagger, extra_kind=""):
        loss_of = whole(tagger, extra_kind)

        def halved(batch, generator):
            keep = max(1, int((batch["src_lengths"] > 0).sum()) // 2)
            b = dict(batch)
            for key in ("src_tokens", "tgt_tokens", "src_lengths"):
                b[key] = batch[key][:keep]
            return loss_of(b, generator)
        return halved

    monkeypatch.setattr(loop, "tagger_loss", half)
    r = run(tiny_cell(config, mix))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("config,mix", CELLS[1::2])
def test_altered_validation_loss_fails(monkeypatch, config, mix):
    from multimodaltopicsegmentation_torch.train import loop

    real = loop.Trainer._eval_loss
    monkeypatch.setattr(loop.Trainer, "_eval_loss", lambda self, batch: real(self, batch) * 1.001)
    r = run(tiny_cell(config, mix))
    assert not r["correct"] and r["checks"]["val_gap"]["value"] > r["checks"]["val_gap"]["limit"]


def test_train_window_counts_the_epochs_fit_returns(monkeypatch):
    cell = tiny_cell("transformer_longdoc", "train_1s")
    from mtsbench.spec import load_benchmark

    cell.per_layer = [m for m in load_benchmark()["per_layer"]
                      if "transformer_longdoc.train_1s" in m["workloads"]]
    seen = {}
    real = harness.Run.add_work

    def add_work(self, kernel, fn, *args):  # the launches the roofline reader holds to the counters
        seen[kernel] = seen.get(kernel, 0) + 1
        return real(self, kernel, fn, *args)

    monkeypatch.setattr(harness.Run, "add_work", add_work)
    r = run(cell, traced=True)
    assert r["correct"] and r["attempted"] >= 1
    assert {"epoch_ms_median.train", "mfu.train"} <= set(r["metrics"])
    # each epoch: 3 training batches (7 documents in 3s) with K2, K4, K3 and one
    # validation batch with K2, in each of the tagger's 2 layers
    epochs = r["attempted"] * cell.traffic["epochs_per_fit"]
    assert seen == {"flash_attention._flash_fwd": epochs * 4 * 2,
                    "flash_attention._flash_dq": epochs * 3 * 2,
                    "flash_attention._flash_dkv": epochs * 3 * 2}


def test_altered_embedding_fails(monkeypatch):
    from multimodaltopicsegmentation_torch.ops import pooling

    real = pooling.pool

    def altered(frames, seg_ids, n_units, variant):
        out = real(frames, seg_ids, n_units, variant)
        out[n_units // 2] += 1e-2 * out[n_units // 2].abs().max()
        return out

    monkeypatch.setattr(pooling, "pool", altered)
    r = run(tiny_cell("w2v2base_bilstm", "predict_audio"))
    assert not r["correct"] and r["checks"]["emb_gap"]["value"] > r["checks"]["emb_gap"]["limit"]


@pytest.mark.parametrize("config,mix,cls", [
    ("w2v2base_bilstm", "predict_audio", "BiLSTMTagger"),
    ("transformer_longdoc", "predict_1s", "TransformerSegmenter")])
def test_altered_tag_fails(monkeypatch, config, mix, cls):
    from multimodaltopicsegmentation_torch.models import taggers, transformers

    klass = getattr(taggers, cls, None) or getattr(transformers, cls)
    real = klass.decode

    def flipped(self, x, lengths, threshold, **kw):
        logits, tags = real(self, x, lengths, threshold, **kw)
        tags = tags.clone()
        b = int(torch.argmax(lengths))
        u = int(torch.argmax(logits[b, : int(lengths[b]), 0].abs()))  # the clearest unit
        tags[b, u] = ~tags[b, u]
        return logits, tags

    monkeypatch.setattr(klass, "decode", flipped)
    r = run(tiny_cell(config, mix))
    assert not r["correct"] and r["checks"]["tag_flips"]["value"] > 0


def test_altered_logits_fail(monkeypatch):
    from multimodaltopicsegmentation_torch.models import transformers

    real = transformers.TransformerSegmenter.decode

    def shifted(self, x, lengths, threshold, **kw):
        logits, tags = real(self, x, lengths, threshold, **kw)
        return logits + 1e-2, tags

    monkeypatch.setattr(transformers.TransformerSegmenter, "decode", shifted)
    r = run(tiny_cell("transformer_longdoc", "predict_1s"))
    assert not r["correct"] and r["checks"]["logit_gap"]["value"] > 5e-3


def test_reference_with_half_the_batch_fails():
    cell = tiny_cell("w2v2base_bilstm", "train_sentences")
    r = harness.run_cell(cell, SEED, 0.5, False, "cpu", fault="half_batch")
    assert not r["correct"], r["checks"]


# -- the timeline's reading ----------------------------------------------------------

def test_timeline_busy_gaps_and_attribution():
    span = trace.SPAN_PREFIX + "decode"
    host = [(0, 100, span, 7, 1, 0), (10, 60, "aten::_cudnn_rnn", 7, 2, 0),
            (12, 13, "cudaLaunchKernel", 7, 0, 501), (70, 90, "aten::mm", 7, 3, 0),
            (71, 72, "cudaLaunchKernel", 7, 0, 502)]
    device = [(20, 30, "rnn_kernel", 2, (501, 0)), (25, 40, "rnn_kernel", 2, (0, 0)),
              (80, 85, "gemm", 3, (502, 0))]
    tl = trace.Timeline.from_events(device, host, thread_id=7)
    assert tl.busy_s == pytest.approx((20 + 5) / 1e9)
    assert tl.kernel_time()["rnn_kernel"] == (pytest.approx(25 / 1e9), 2)
    assert tl.launched_under(lambda n: n.startswith("aten::_cudnn_rnn")) == pytest.approx(25 / 1e9)
    assert tl.idle_gaps() == [["decode: aten::_cudnn_rnn", pytest.approx(40 / 1e9)]]
    assert tl.launched_under(lambda n: n == "aten::nothing") is None
    assert np.isclose(tl.matching(lambda n: n == "gemm")[0], 5e-9)
