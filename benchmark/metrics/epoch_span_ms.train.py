"""Mean host milliseconds of the window's `fit.epoch` spans (each from its
first step's enqueue to after the learning-rate step, ending with the
epoch's losses on the host; multimodaltopicsegmentation_torch/utils/
profiling.py): the epochs alone, without each fit's own set-up, copies and
checkpoint. Nothing when the program records no such span."""


def read(run):
    from multimodaltopicsegmentation_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    t0, t1 = run.t0 * 1e9, run.loop_end * 1e9
    ns = [r.end - r.start for r in spans() if r.name == "fit.epoch"
          and r.end is not None and t0 <= r.start and r.end <= t1]
    return sum(ns) / len(ns) / 1e6 if ns else None
