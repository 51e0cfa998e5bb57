"""K1's floor over its device time: the bytes its launches must move at the
HBM rate (mtsbench.roofline.k1_bytes, per chunk of rows), over the device
time of `instance_norm_gelu_kernel` in the trace. Nothing when the trace,
the program's launch counter and the launches the harness recorded do not
agree on the count."""
from mtsbench import roofline

K1 = "instance_norm_gelu.instance_norm_gelu"


def read(run):
    work = run.work(K1)
    if run.timeline is None or not work:
        return None
    secs, n = run.timeline.matching(lambda name: "instance_norm_gelu" in name)
    if n != len(work) or run.launches.get(K1) != n or secs <= 0:
        return None
    return 100.0 * sum(roofline.floor_s(o, b) for o, b in work) / secs
