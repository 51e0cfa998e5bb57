"""Share of the encoder's forward device time spent on WavLM's relative
position bias: the device time of the kernels launched under the program's
`mts.encode_document.forward.rel_bias` range (the bias P, once a forward) and
its `mts.encode_document.forward.gate` ranges (each layer's gate and its
product with P) over that under `mts.encode_document.forward`
(`Timeline.launched_under`; multimodaltopicsegmentation_torch/utils/profiling.py).
Nothing when the trace holds none of the bias's ranges."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    forward = tl.launched_under(lambda name: name == "mts.encode_document.forward")
    parts = [tl.launched_under(lambda name, n=n: name == f"mts.encode_document.forward.{n}")
             for n in ("rel_bias", "gate")]
    if not forward or all(p is None for p in parts):
        return None
    return 100.0 * sum(p or 0.0 for p in parts) / forward
