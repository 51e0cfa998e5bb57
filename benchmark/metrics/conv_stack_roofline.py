"""Conv layers 1.. of the encoder's feature stack at their float32-accurate
floor over their device time: the FLOPs of those layers over the valid units
the traced window finished (one unit is one row of `interval_s` seconds;
mtsbench.readers.mfu counts the same units), at 165 TFLOP/s
(mtsbench.roofline.floor_s), over the device time of the program's
channels-last 3xTF32 conv kernel (`conv_tf32x3_kernel`). Nothing when the
trace's count of that kernel and the program's launch counter
`conv_tf32x3.conv_tf32x3` disagree, or when neither has a launch.

The FLOPs of one unit, frozen here: 2 k C_in C_out T_out for every conv
layer but the first (one input channel, off the kernel), T_out the layer's
frames over the unit's samples."""
from mtsbench import roofline

COUNTER = "conv_tf32x3.conv_tf32x3"
SR = 16000


def unit_conv_flops(enc: dict, samples: int) -> float:
    flops, t, c_in = 0, samples, 1
    for i, (c, k, s) in enumerate(zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"])):
        t = (t - k) // s + 1
        if i > 0:
            flops += 2 * k * c_in * c * t
        c_in = c
    return float(flops)


def read(run):
    launches = run.launches.get(COUNTER)
    if run.timeline is None or not launches or not run.completions:
        return None
    secs, n = run.timeline.matching(lambda name: "conv_tf32x3_kernel" in name)
    if n != launches or secs <= 0:
        return None
    units = sum(c[1] for c in run.completions)
    samples = int(SR * run.cell.traffic.get("interval_s", 1))
    flops = units * unit_conv_flops(run.cell.config["encoder"], samples)
    return 100.0 * roofline.floor_s(flops, 0.0) / secs
