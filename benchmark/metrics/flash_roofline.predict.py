"""K2's floor over its device time in the predict loop: the banded work of
each launch at the float32-accurate tensor-core rate or its bytes at the HBM
rate, whichever is longer (mtsbench.roofline.k2_work), over the device time
of `flash_local_fwd_kernel`. Nothing when the counts disagree."""
from mtsbench import roofline

K2 = "flash_attention._flash_fwd"


def read(run):
    work = run.work(K2)
    if run.timeline is None or not work:
        return None
    secs, n = run.timeline.matching(lambda name: "flash_local_fwd" in name)
    if n != len(work) or run.launches.get(K2) != n or secs <= 0:
        return None
    return 100.0 * sum(roofline.floor_s(o, b) for o, b in work) / secs
