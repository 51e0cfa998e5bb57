"""What the harness counts for the BiLSTM tagger (cuDNN's LSTM: no kernel of
the program's own)."""
from mtsbench import roofline

KERNELS = ()


def kernels(train: bool):
    """The program's kernel libraries this tagger runs (built in set-up)."""
    return KERNELS


def flops(lengths, tc: dict, train: bool) -> float:
    """Model FLOPs over the valid units of `lengths`: forward, and in training
    twice that again for the backward."""
    f = roofline.lstm_flops(sum(lengths), tc["embedding_dim"], tc["hidden_dim"], tc["num_layers"])
    return 3 * f if train else f


def record_work(run, lengths, L: int, tc: dict, train: bool):
    """Launches of the program's own kernels for one padded batch: none."""


def batch_kwargs(tc: dict, cut) -> dict:
    """How the train CLI pads this tagger's batches: to a bucket length."""
    return {}
