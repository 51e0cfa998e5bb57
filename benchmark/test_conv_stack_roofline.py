"""`conv_stack_roofline`: by hand on a planted trace, the frozen FLOP count
against the conv terms of the yardstick's model FLOPs, and nothing from a
program without the kernel or with counts that disagree."""
import json
import os
from types import SimpleNamespace

import pytest

from mtsbench import roofline
from mtsbench.spec import metric_reader

HERE = os.path.dirname(os.path.abspath(__file__))
READ = "conv_stack_roofline"
KERNEL = ("void (anonymous namespace)::conv_tf32x3_kernel(CUtensorMap_st, CUtensorMap_st, "
          "CUtensorMap_st, float const*, float*, int, int, (anonymous namespace)::ConvSteps, int)")
LINEAR = "void (anonymous namespace)::linear_tf32x3_kernel(CUtensorMap_st, CUtensorMap_st)"
COUNTER = "conv_tf32x3.conv_tf32x3"


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


@pytest.mark.parametrize("name", ["w2v2base_bilstm", "wavlm_large_bilstm"])
def test_conv_flops_are_the_yardsticks_conv_terms(name):
    from metrics.conv_stack_roofline import unit_conv_flops

    enc = encoder(name)
    flops = unit_conv_flops(enc, 16000)
    # 2 k 512 512 T_out for T_out = 1599, 799, 399, 199 (k 3), 99, 49 (k 2)
    assert flops == 2 * 512 * 512 * (3 * (1599 + 799 + 399 + 199) + 2 * (99 + 49))
    assert flops == pytest.approx(4.867e9, rel=1e-3)
    # the yardstick without its layers: the conv stack, the projection and the
    # positional conv; less those two and conv layer 0 it is this count
    stack = roofline.wav2vec2_unit_flops({**enc, "num_hidden_layers": 0}, 16000)
    D, c, t0, t = enc["hidden_size"], enc["conv_dim"], 3199, 49
    rest = (2 * c[-1] * D * t + 2 * D * (D // enc["num_conv_pos_embedding_groups"])
            * enc["num_conv_pos_embeddings"] * t + 2 * c[0] * enc["conv_kernel"][0] * t0)
    assert flops == stack - rest


def test_roofline_by_hand():
    from metrics.conv_stack_roofline import unit_conv_flops

    enc = encoder("wavlm_large_bilstm")
    run = fake_run(enc, [300, 700], [(KERNEL, 0.02), (KERNEL, 0.03), (LINEAR, 1.0),
                                     ("sm80_xmma_fprop_implicit_gemm", 1.0)], {COUNTER: 2})
    want = 100.0 * 1000 * unit_conv_flops(enc, 16000) / roofline.F32_ACCURATE_FLOP_PER_S / 0.05
    assert metric_reader(READ)(run) == pytest.approx(want)


def test_nothing_to_read():
    enc = encoder("w2v2base_bilstm")
    read = metric_reader(READ)
    events = [(KERNEL, 0.02), (KERNEL, 0.02)]
    # a program without the kernel or its counter (the parent of the kernel)
    assert read(fake_run(enc, [100], [("sm80_xmma_fprop_implicit_gemm", 1.0)], {})) is None
    assert read(fake_run(enc, [100], [(LINEAR, 1.0)], {"linear_tf32x3.linear_tf32x3": 1})) is None
    # counts that disagree, or a counter with no kernel in the trace
    assert read(fake_run(enc, [100], events, {COUNTER: 3})) is None
    assert read(fake_run(enc, [100], [(LINEAR, 1.0)], {COUNTER: 2})) is None
    # no trace, no finished document
    run = fake_run(enc, [100], events, {COUNTER: 2})
    run.timeline = None
    assert read(run) is None
    assert read(fake_run(enc, [], events, {COUNTER: 2})) is None
