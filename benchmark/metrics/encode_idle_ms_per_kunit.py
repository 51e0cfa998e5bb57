"""Device-idle milliseconds per thousand units encoded, of the idle gaps
that began while one of the program's `mts.encode_document*` ranges was open
on the window's thread (the gap's start inside the range, as
`Timeline.idle_gaps` puts a gap down to what the host was doing), over the
units that the window's `encode_document` spans count
(multimodaltopicsegmentation_torch/utils/profiling.py). Nothing when the
program records no such span or range."""
import bisect

PREFIX = "mts.encode_document"


def _window_spans(run):
    from multimodaltopicsegmentation_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return []
    t0, t1 = run.t0 * 1e9, run.loop_end * 1e9
    return [r for r in spans() if r.end is not None and t0 <= r.start and r.end <= t1]


def read(run):
    tl = run.timeline
    if tl is None or not tl.device:
        return None
    units = sum(r.counts.get("units", 0) for r in _window_spans(run)
                if r.name == "encode_document")
    ranges = sorted((h[0], h[1]) for h in tl.host
                    if h[3] == tl.thread_id and h[2].startswith(PREFIX))
    if not units or not ranges:
        return None
    merged = []
    for a, b in ranges:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    idle_ns = 0
    for (_, b0), (a1, _) in zip(tl.busy_intervals, tl.busy_intervals[1:]):
        if a1 <= b0:
            continue
        i = bisect.bisect_right(starts, b0) - 1
        if i >= 0 and b0 < merged[i][1]:
            idle_ns += a1 - b0
    return (idle_ns / 1e6) / (units / 1e3)
