"""Share of the encoder's forward device time spent on w2v-BERT's
relative-key term: the device time of the kernels launched under the
program's `mts.encode_document.forward.rel_key` ranges (one a layer: q E^T
and its gather by clamped distance into the score bias) over that under
`mts.encode_document.forward` (`Timeline.launched_under`;
multimodaltopicsegmentation_torch/utils/profiling.py). Nothing when the trace
holds no such range."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    forward = tl.launched_under(lambda name: name == "mts.encode_document.forward")
    part = tl.launched_under(lambda name: name == "mts.encode_document.forward.rel_key")
    if not forward or part is None:
        return None
    return 100.0 * part / forward
