"""Share of the encoder's forward device time spent in w2v-BERT's conv
modules: the device time of the kernels launched under the program's
`mts.encode_document.forward.conv_module` ranges (one a layer: LayerNorm, the
padded frames zeroed, the pointwise convolution D -> 2D, GLU, the causal
depthwise convolution, LayerNorm, swish, the pointwise convolution D -> D)
over that under `mts.encode_document.forward` (`Timeline.launched_under`;
multimodaltopicsegmentation_torch/utils/profiling.py). Nothing when the trace
holds no such range."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    forward = tl.launched_under(lambda name: name == "mts.encode_document.forward")
    part = tl.launched_under(lambda name: name == "mts.encode_document.forward.conv_module")
    if not forward or part is None:
        return None
    return 100.0 * part / forward
