"""What the harness counts for the long-document Transformer tagger: its
flash kernels (K2 forward; K4 and K3 backward) and model FLOPs."""
from mtsbench import roofline
from reference.taggers.Transformer import windows

K2, K4, K3 = "flash_attention._flash_fwd", "flash_attention._flash_dq", "flash_attention._flash_dkv"


def kernels(train: bool):
    """The program's kernel libraries this tagger runs (built in set-up)."""
    return ("flash_local_attention", "flash_local_attention_bwd") if train else (
        "flash_local_attention",)


def flops(lengths, tc: dict, train: bool) -> float:
    lengths = [int(n) for n in lengths if n > 0]
    fn = roofline.transformer_train_flops if train else roofline.transformer_flops
    return fn(lengths, tc["embedding_dim"], tc["hidden_dim"], tc["nheads"], windows(tc))


def record_work(run, lengths, L: int, tc: dict, train: bool):
    """One padded batch of `lengths` in L rows: each layer launches K2, and in
    training K4 and K3 for its backward."""
    H = tc["nheads"]
    Dh = tc["embedding_dim"] // H
    lengths = tuple(int(n) for n in lengths)
    for w in windows(tc):
        run.add_work(K2, roofline.k2_work, lengths, L, w // 2, H, Dh)
        if train:
            run.add_work(K4, roofline.k4_work, lengths, L, w // 2, H, Dh)
            run.add_work(K3, roofline.k3_work, lengths, L, w // 2, H, Dh)


def batch_kwargs(tc: dict, cut) -> dict:
    """How the train CLI pads a windowed tagger's batches: to its cut."""
    return {"truncate": True, "truncate_value": cut}
