"""Readers shared by metrics of different cells (`metrics/<name>.py` names
one of these as its `read`). Each returns None when the run has nothing for
it to read."""
import statistics

from . import roofline


def rate(run):
    """Units of the work items (documents, fits) finished in the window over
    the seconds from the window's start to the last of them: all the work
    and all the time of the window, never a median of items."""
    return run.rate()


def glue_share(run):
    """Share of the predict loop's host time outside the benchmark's spans
    around the encoder's and the tagger's calls (each span ends when its
    outputs are on the host): unitization, loads, pooling, padding, copies
    and segments."""
    inside = sum(run.spans.get(k, 0.0) for k in ("encode", "decode"))
    if "decode" not in run.spans or not run.completions:
        return None
    total = run.completions[-1][0] - run.t0
    return 100.0 * (total - inside) / total


def decode_ms_per_kunit(run):
    """Host milliseconds of the tagger's `decode` (its span ends with the
    logits on the host) per thousand units tagged."""
    units = run.span_units.get("decode", 0)
    return 1e3 * run.spans["decode"] / (units / 1e3) if units else None


def idle_share(run):
    """Share of the traced window in which no operation ran on the device (the
    union of kernel, copy and set intervals in the profiler's timeline)."""
    if run.timeline is None:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s / run.loop_s())


def mfu(run):
    """Model FLOPs of the work the traced window finished (forward, and in
    training backward, over valid units; recomputation not counted;
    mtsbench.roofline) over the time to the last finish at the float32-accurate
    peak, 165 TFLOP/s (3 x TF32, 495 TFLOP/s at 700 W)."""
    if not run.completions:
        return None
    secs = run.completions[-1][0] - run.t0
    return 100.0 * run.flops_all() / (secs * roofline.F32_ACCURATE_FLOP_PER_S)


def epoch_ms_median(run):
    """Median over the window's fits of host milliseconds per epoch (a fit's
    time, from the call to its return, over the epochs its history holds):
    steps, validation and the fit's own set-up and checkpoint, a steadier
    statistic beside the rate."""
    values = run.samples.get("epoch_ms")
    return statistics.median(values) if values else None
