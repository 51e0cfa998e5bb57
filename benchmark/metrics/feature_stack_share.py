"""Share of the encoder's forward device time spent in its feature stack: the
device time of the kernels launched under the program's
`mts.encode_document.forward.features` ranges (the conv stack, its norms and
the feature projection) over that under `mts.encode_document.forward`
(`Timeline.launched_under`; multimodaltopicsegmentation_torch/utils/profiling.py).
Nothing when the trace holds no such range."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    forward = tl.launched_under(lambda name: name == "mts.encode_document.forward")
    features = tl.launched_under(lambda name: name == "mts.encode_document.forward.features")
    if not forward or features is None:
        return None
    return 100.0 * features / forward
