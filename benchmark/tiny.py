"""Tiny cells for the benchmark's CPU tests: every driver's whole run at
widths a test can hold (the cells' own widths run on the card)."""
import copy

from mtsbench.spec import Cell, load_benchmark, load_config, load_traffic

TINY_ENCODER = {"conv_dim": [16, 16], "conv_kernel": [10, 3], "conv_stride": [5, 2],
                "hidden_size": 24, "intermediate_size": 48, "num_attention_heads": 2,
                "num_hidden_layers": 2, "num_conv_pos_embeddings": 16,
                "num_conv_pos_embedding_groups": 2}
LOOSE = {"emb_gap": 1e-4, "logit_gap": 1e-4, "tag_flips": 0, "segment_mismatch": 0,
         "loss_gap": 1e-4, "val_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}


def cell(config_name: str, traffic_name: str) -> Cell:
    config = copy.deepcopy(load_config(config_name))
    traffic = copy.deepcopy(load_traffic(traffic_name))
    tagger = config["tagger"]
    if "encoder" in config:
        config["encoder"].update(TINY_ENCODER)
        tagger["embedding_dim"] = TINY_ENCODER["hidden_size"]
    else:
        tagger.update(embedding_dim=32, nheads=4, attention_window=6, max_position=4096)
        config["max_document_units"] = 40
    tagger.update(hidden_dim=8)
    kind = traffic["kind"]
    if kind == "predict_audio":
        traffic["documents"] = {"lengths": [3, 9, 6], "order": "loader"}
        traffic.update(encode_chunk=4, check_sample_units=5)
    elif kind == "predict_embeddings":
        traffic["documents"] = {"lengths": [30, 40, 7, 25, 12], "order": "loader"}
        traffic.update(batch_size=2)
    else:
        traffic["documents"].update(train={"lengths": [20, 33, 9, 15, 28, 40, 11]},
                                    valid={"lengths": [17, 26]})
        traffic.update(batch_size=3, epochs_per_fit=2, boundary_every=5)
    name = f"{config_name}.{traffic_name}"
    bench = load_benchmark()
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return Cell(name, config_name, traffic_name, 1, config, traffic, e2e, [], dict(LOOSE))
