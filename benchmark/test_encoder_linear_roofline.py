"""`encoder_linear_roofline`: by hand on a synthetic trace, the frozen FLOP
count against the model FLOPs of the yardstick, and nothing from a program
without the kernel or with counts that disagree."""
import json
import os
from types import SimpleNamespace

import pytest

from mtsbench import roofline
from mtsbench.spec import metric_reader

HERE = os.path.dirname(os.path.abspath(__file__))
READ = "encoder_linear_roofline"
KERNEL = "void (anonymous namespace)::linear_tf32x3_kernel(CUtensorMap_st, CUtensorMap_st)"


def encoder(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)["encoder"]


class Timeline:
    def __init__(self, events):
        self.events = events  # [(name, seconds)]

    def matching(self, pred):
        hits = [s for name, s in self.events if pred(name)]
        return sum(hits), len(hits)


def fake_run(enc, units, events, launches):
    cell = SimpleNamespace(config={"encoder": enc}, traffic={"interval_s": 1})
    return SimpleNamespace(cell=cell, completions=[(1.0, u, 0.0) for u in units],
                           timeline=Timeline(events), launches=launches)


@pytest.mark.parametrize("name, per_unit", [("w2v2base_bilstm", 8.363e9),
                                             ("wavlm_large_bilstm", 29.652e9)])
def test_linear_flops_of_a_unit(name, per_unit):
    from metrics.encoder_linear_roofline import unit_linear_flops

    enc = encoder(name)
    flops = unit_linear_flops(enc, 16000)
    assert flops == pytest.approx(per_unit, rel=1e-3)
    # the linears are the dense part of the yardstick's model FLOPs: what is
    # left is the convolutions and the attention's scores
    assert flops < roofline.wav2vec2_unit_flops(enc, 16000)


def test_roofline_by_hand():
    from metrics.encoder_linear_roofline import unit_linear_flops

    enc = encoder("w2v2base_bilstm")
    run = fake_run(enc, [300, 700], [(KERNEL, 0.05), (KERNEL, 0.05), ("other", 1.0)],
                   {"linear_tf32x3.linear_tf32x3": 2})
    want = 100.0 * 1000 * unit_linear_flops(enc, 16000) / roofline.F32_ACCURATE_FLOP_PER_S / 0.1
    assert metric_reader(READ)(run) == pytest.approx(want)


def test_nothing_to_read():
    enc = encoder("wavlm_large_bilstm")
    read = metric_reader(READ)
    events = [(KERNEL, 0.05), (KERNEL, 0.05)]
    # a program without the kernel or its counter (the parent of the kernel)
    assert read(fake_run(enc, [100], [("sm80_xmma_gemm", 1.0)], {})) is None
    # counts that disagree
    assert read(fake_run(enc, [100], events, {"linear_tf32x3.linear_tf32x3": 3})) is None
    # no trace, no finished document
    run = fake_run(enc, [100], events, {"linear_tf32x3.linear_tf32x3": 2})
    run.timeline = None
    assert read(run) is None
    assert read(fake_run(enc, [], events, {"linear_tf32x3.linear_tf32x3": 2})) is None
