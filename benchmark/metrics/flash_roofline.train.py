"""The summed floors of K2, K4 and K3 over their summed device time in the
training window (mtsbench.roofline.k2_work, k4_work, k3_work; kernels
`flash_local_fwd_kernel`, `flash_local_dq_kernel`, `flash_local_dkv_kernel`).
Nothing when a kernel's count in the trace, the program's counter and the
launches the harness recorded disagree."""
from mtsbench import roofline

KERNELS = (("flash_attention._flash_fwd", "flash_local_fwd"),
           ("flash_attention._flash_dq", "flash_local_dq_kernel"),
           ("flash_attention._flash_dkv", "flash_local_dkv"))


def read(run):
    if run.timeline is None:
        return None
    floor, secs = 0.0, 0.0
    for key, name in KERNELS:
        work = run.work(key)
        s, n = run.timeline.matching(lambda k, name=name: name in k)
        if not work or n != len(work) or run.launches.get(key) != n:
            return None
        floor += sum(roofline.floor_s(o, b) for o, b in work)
        secs += s
    return 100.0 * floor / secs if secs > 0 else None
