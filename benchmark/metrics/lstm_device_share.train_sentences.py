"""Share of the traced window's device time spent in kernels that cuDNN's RNN
ops (`aten::_cudnn_rnn`, `aten::_cudnn_rnn_backward`, and ops inside them)
launched: the recurrence, forward and backward."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    lstm = tl.launched_under(lambda name: name.startswith("aten::_cudnn_rnn"))
    total = sum(s for s, _ in tl.kernel_time().values())
    if lstm is None or total <= 0:
        return None
    return 100.0 * lstm / total
