"""The yardstick's arithmetic against hand counts at small shapes, and the
RadioNews length draw."""
import numpy as np
import pytest

from mtsbench import roofline, traffic


def test_banded_work_by_hand():
    # L 4, half 1, one document of 4 units: keys per query 2, 3, 3, 2 -> 10 pairs
    assert roofline.banded_work([4], 4, 1, 8, 1, 2) == 4 * 2 * 10
    # a document of 2 in 16 rows, half 1, block 8: pairs 2 + 2 + 1 (padding row 2
    # still sees key 1) = 5; rows from n + half = 3 on see no key: 2 blocks - 3 // 8
    # = 2 blocks of 3*8 rows of V
    assert roofline.banded_work([2], 16, 1, 8, 1, 2) == 4 * 2 * 5 + 2 * 3 * 8 * 2
    # heads multiply
    assert roofline.banded_work([4], 4, 1, 8, 3, 2) == 3 * 80


def test_banded_bytes_by_hand():
    # n = L = 4, half 1, H 1, Dh 2, lse: q of 4 rows, k and v of 4, O and lse of 4, lengths
    want = 4 + 4 * (4 * 2 + 2 * 4 * 2 + 4 * 2 + 4)
    assert roofline.banded_bytes([4], 4, 1, 8, 1, 2, True, 0, False) == want


def test_banded_pairs_and_backward_by_hand():
    assert roofline.banded_pairs([4, 2], 4, 1) == 10 + 4
    ops4, bytes4 = roofline.k4_work([4], 4, 1, 2, 2)
    ops3, bytes3 = roofline.k3_work([4], 4, 1, 2, 2)
    pairs = 2 * 10
    reads = (4 * 2 + 2) * (2 * 4) * 4 + 4
    assert (ops4, bytes4) == (6 * 2 * pairs, reads + 2 * 4 * 2 * 4)
    assert (ops3, bytes3) == (8 * 2 * pairs, reads + 2 * 2 * 4 * 2 * 4)


def test_k1_bytes_by_hand():
    assert roofline.k1_bytes(2, 3, 5) == 2 * 30 * 4 + 2 * 3 * 4 + 2 * 4


def test_floor_takes_the_longer_bound():
    assert roofline.floor_s(165e12, 0) == pytest.approx(1.0)
    assert roofline.floor_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.floor_s(165e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_wav2vec2_flops_by_hand():
    cfg = {"conv_dim": [4, 4], "conv_kernel": [3, 2], "conv_stride": [2, 2], "hidden_size": 6,
           "intermediate_size": 8, "num_conv_pos_embeddings": 2,
           "num_conv_pos_embedding_groups": 2, "num_hidden_layers": 1}
    # 11 samples -> 5 frames -> 2 frames
    conv = 2 * 4 * 1 * 3 * 5 + 2 * 4 * 4 * 2 * 2
    proj = 2 * 4 * 6 * 2
    pos = 2 * 6 * 3 * 2 * 2
    layer = 4 * 2 * 6 * 6 * 2 + 2 * 2 * 6 * 8 * 2 + 2 * 2 * 2 * 2 * 6
    assert roofline.wav2vec2_unit_flops(cfg, 11) == conv + proj + pos + layer


def test_wav2vec2_base_is_about_13_7_gflop_a_second():
    from mtsbench.spec import load_config

    flops = roofline.wav2vec2_unit_flops(load_config("w2v2base_bilstm")["encoder"], 16000)
    assert 13.5e9 < flops < 14.0e9


def test_lstm_and_transformer_flops_by_hand():
    # one unit, in 2, H 1, one bidirectional layer: 2 dirs x 2 x 4H x (2 + 1), head 2 x 2
    assert roofline.lstm_flops(1, 2, 1, 1) == 2 * 2 * 4 * 3 + 2 * 2
    # one document of 4 units, d 2, ff 3, 1 head, window 2 (half 1): 10 pairs
    dense = (4 * 2 * 2 * 2 + 2 * 2 * 2 * 3) * 4
    assert roofline.transformer_flops([4], 2, 3, 1, [2]) == dense + 4 * 2 * 10 + 2 * 2 * 4
    assert roofline.transformer_train_flops([4], 2, 3, 1, [2]) == 3 * dense + 12 * 2 * 10 \
        + 3 * 2 * 2 * 4


def test_radionews_lengths_are_the_record():
    records = traffic.load_records()
    assert len(records["documents"]) == 55
    train = traffic.documents({"sets": ["train"], "unit": "sentences"})
    assert len(train) == 34
    # the loader consumes the split's list from its end
    assert train[0][0] == records["split"]["train"][-1]
    seconds = traffic.documents({"sets": ["all"], "unit": "seconds", "order": "stride:23"})
    assert sorted(n for _, n in seconds) == sorted(int(r["seconds"])
                                                   for r in records["documents"].values())
    assert max(n for _, n in seconds) == 10979
    assert max(n for _, n in traffic.documents({"sets": ["all"], "unit": "seconds"}, 3600)) == 3600


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 3])
def test_draws_are_reproducible_from_the_seed(seed):
    a = traffic.rng(seed, "labels").random(5)
    b = traffic.rng(seed, "labels").random(5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, traffic.rng(seed + 1, "labels").random(5))
    assert traffic.sub_seed(seed, "weights") != traffic.sub_seed(seed, "audio")
    assert 0 <= traffic.sub_seed(seed, "weights") < 2 ** 63
    labels = traffic.boundary_labels(50, 5, traffic.rng(seed, "x"))
    assert labels == traffic.boundary_labels(50, 5, traffic.rng(seed, "x")) and labels[-1] == 0
    # the lengths do not depend on the seed: every seed asks for the same work
    spec = {"sets": ["all"], "unit": "seconds", "order": "stride:23"}
    assert traffic.documents(spec) == traffic.documents(spec)
