"""w2v-BERT 2.0's dense products at their float32-accurate floor over their
device time: the FLOPs of the feature projection and of each conformer
layer's linears over the valid units the traced window finished (one unit is
one row of `interval_s` seconds; mtsbench.readers.mfu counts the same units),
at 165 TFLOP/s (mtsbench.roofline.floor_s), over the device time of the
program's 3xTF32 linear kernel (`linear_tf32x3_kernel`). Nothing when the
trace's count of that kernel and the program's launch counter
`linear_tf32x3.linear_tf32x3` disagree, or when neither has a launch.

The linears' FLOPs of one unit of t frames (t = (1 + (samples - 400) // 160)
// 2, the Kaldi fbank's frames stacked in pairs), frozen here: the projection
2 C D t (C = 160, D the hidden size) and, per layer, 14 D^2 t (Q, K and V 6,
out 2, the pointwise convolutions D -> 2D 4 and D -> D 2) + 8 D F t (two FFNs
of width F)."""
from mtsbench import roofline

COUNTER = "linear_tf32x3.linear_tf32x3"
SR = 16000


def unit_linear_flops(enc: dict, samples: int) -> float:
    t = ((samples - 400) // 160 + 1) // 2 if samples >= 400 else 0
    D, F = enc["hidden_size"], enc["intermediate_size"]
    per_layer = 14 * D * D * t + 8 * D * F * t
    return float(2 * enc["feature_projection_input_dim"] * D * t
                 + enc["num_hidden_layers"] * per_layer)


def read(run):
    launches = run.launches.get(COUNTER)
    if run.timeline is None or not launches or not run.completions:
        return None
    secs, n = run.timeline.matching(lambda name: "linear_tf32x3_kernel" in name)
    if n != launches or secs <= 0:
        return None
    units = sum(c[1] for c in run.completions)
    samples = int(SR * run.cell.traffic.get("interval_s", 1))
    flops = units * unit_linear_flops(run.cell.config["encoder"], samples)
    return 100.0 * roofline.floor_s(flops, 0.0) / secs
