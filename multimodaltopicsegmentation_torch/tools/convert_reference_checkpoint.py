#!/usr/bin/env python
"""Convert a reference-trained TextSegmenter checkpoint into a port checkpoint.

The JAX package's tools/convert_reference_checkpoint.py, numpy only, in the
port (which does not import that package): the same rules give the same
numpy pytree, the port's own `models/base.TaggerConfig` with the same fields
and the same architecture name; the taggers take the pytree through their
`from_jax_params`.

The reference trains `TextSegmenter` (a pytorch-lightning module wrapping the
tagger zoo, models/lightning_model.py:178-250) and saves
torch checkpoints whose `state_dict` carries keys like

    model.model.rnn.weight_ih_l0[_reverse]   (BiLSTM / BiRnnCrf towers)
    model.model1.rnn.* / model.model2.rnn.*  (BiLSTMLateFusion towers)
    model.classification.{weight,bias}       (sigmoid / softmax heads)
    model.crf.fc.{weight,bias}, model.crf.transitions

and, for the transformer family, the HF-model weights the reference wraps:

    model.model.model.*                      (Transformer_segmenter ->
                                              LongformerModel / BertModel)
    model.model.{i}.lstm.rnn.* / .transformer.model.*  (RecurrentLongT5 ->
                                              HF LongT5EncoderModel blocks)

This tool maps them onto the JAX-layout pytrees that the port's taggers
read (models/taggers.py, models/transformers.py) so a user holding
reference-trained weights can decode with cli/predict.py and get identical
boundaries.

The reference's own loader guesses the loss head by trying BinaryCrossEntropy
and falling back to CrossEntropy on KeyError (the reference's predict.py:227-256,
the two heads differ only in the classifier's output width). Here the same
decision is made deterministically from the classifier shape: out_features 1
-> sigmoid head (BinaryCrossEntropy decode), otherwise CrossEntropy.

Usage:
    python -m multimodaltopicsegmentation_torch.tools.convert_reference_checkpoint \
        REF.ckpt OUT.ckpt [--architecture BiLSTM] [--nheads 8] [--attention_window 120]

Everything else (hidden size, layers, bidirectionality, LSTM vs GRU,
embedding dims, tagset size) is inferred from the state_dict shapes.
"""
from __future__ import annotations

import argparse
import re
import sys


class _TrackedDict(dict):
    """state_dict wrapper recording which keys a conversion actually read, so
    unconsumed tensors (e.g. domain_learning=True `domain_classification.*`
    heads) are reported instead of silently dropped — the converted params
    would otherwise look like a complete round-trip when they are not."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


def _to_np(t):
    import numpy as np

    # copy=True: torch's .numpy() shares storage with the live parameter, so
    # without the copy the converted params would silently track later
    # in-place optimizer updates of the source module
    return np.array(t.detach().cpu().numpy() if hasattr(t, "detach") else t, copy=True)


def _strip_prefix(state_dict: dict) -> dict:
    """Accept both a Lightning `TextSegmenter` state_dict (keys under
    'model.') and a bare tagger state_dict."""
    if any(k.startswith("model.") for k in state_dict):
        return {k[len("model."):]: v for k, v in state_dict.items() if k.startswith("model.")}
    return dict(state_dict)


def infer_architecture(sd: dict) -> str:
    if any(".LocalSelfAttention." in k for k in sd):
        return "RecurrentLongT5"  # HF LongT5EncoderModel blocks (CRF.py:613-762)
    if any(k.startswith("model.model.encoder.layer.") for k in sd):
        # Transformer_segmenter wraps an HF LongformerModel (restricted=True,
        # the only reachable configuration: TextSegmenter never passes
        # `restricted`, lightning_model.py:212) or a BertModel
        return "Transformer"
    if any(re.match(r"model\.\d+\.(lstm|transformer)\.", k) for k in sd):
        # RecurrentLongformer's ModuleList of blocks (CRF.py:764-858) — the
        # LongT5 variant was caught above by its .LocalSelfAttention. keys
        return "RecurrentLongformer"
    if any(k.startswith("crf.") for k in sd):
        if any(k.startswith("model.transformer_encoder.") for k in sd):
            return "Transformer-CRF"
        return "biLSTMCRF"
    if any(k.startswith("model1.") for k in sd):
        return "BiLSTMLateFusion"
    if any(k.startswith("forward_dense.") for k in sd):
        return "SheikhBiLSTM"  # coherence scorer (models/CRF.py:980-1041)
    if any(k.startswith(("model_1.", "classification_1.")) for k in sd):
        return "SwitchBiLSTM"  # domain adaptation (models/CRF.py:1046-1270)
    if any(k.startswith("lstm.rnn.") for k in sd):
        return "SheikhBiLSTM"
    if any(k.startswith("lstm.") for k in sd):
        return "SimpleBiLSTM"  # bare nn.LSTM + `.classifier` head
    if any(k.startswith("layers.") for k in sd):
        return "MLP"
    return "BiLSTM"


def _rnn_geometry(sd: dict, prefix: str):
    """(num_layers, hidden, in_dim, bidirectional, is_lstm) from shapes."""
    w_ih0 = _to_np(sd[f"{prefix}.weight_ih_l0"])
    w_hh0 = _to_np(sd[f"{prefix}.weight_hh_l0"])
    hidden = w_hh0.shape[1]
    gates = w_hh0.shape[0] // hidden  # 4 = LSTM, 3 = GRU
    layers = 0
    while f"{prefix}.weight_ih_l{layers}" in sd:
        layers += 1
    return (
        layers,
        hidden,
        w_ih0.shape[1],
        f"{prefix}.weight_ih_l0_reverse" in sd,
        gates == 4,
    )


def _convert_rnn_stack(sd: dict, prefix: str, layers: int, bidirectional: bool,
                       is_lstm: bool) -> list:
    """torch nn.LSTM/GRU tensors -> the JAX layout's per-layer dicts
    (ops/rnn.py lstm_params/gru_params layouts; torch gate order kept)."""
    stack = []
    for k in range(layers):
        entry = {}
        dirs = [("", "fwd")] + ([("_reverse", "bwd")] if bidirectional else [])
        for suffix, key in dirs:
            w_ih = _to_np(sd[f"{prefix}.weight_ih_l{k}{suffix}"]).T
            w_hh = _to_np(sd[f"{prefix}.weight_hh_l{k}{suffix}"]).T
            b_ih = _to_np(sd[f"{prefix}.bias_ih_l{k}{suffix}"])
            b_hh = _to_np(sd[f"{prefix}.bias_hh_l{k}{suffix}"])
            # both cells keep b_ih/b_hh separate: the GRU needs b_hh inside
            # the reset product, and the LSTM needs the torch two-tensor
            # parametrization for optimizer-trajectory parity (each bias
            # receives the full gradient under Adam; see ops/rnn.py)
            entry[key] = {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
        stack.append(entry)
    return stack


def _linear(sd: dict, prefix: str) -> dict:
    return {"w": _to_np(sd[f"{prefix}.weight"]).T, "b": _to_np(sd[f"{prefix}.bias"])}


def convert_state_dict(state_dict: dict, architecture: str = None):
    """-> (params, TaggerConfig, architecture_name).

    Warns (stderr) when state_dict tensors are left unconsumed by the
    conversion — e.g. the `domain_classification.*` heads a
    domain_learning=True SwitchBiLSTM checkpoint carries, or SheikhBiLSTM's
    vestigial `classification` head. Decode is unaffected, but the converted
    params are then not a complete round-trip of the source.
    """
    sd = _TrackedDict(_strip_prefix(state_dict))
    architecture = architecture or infer_architecture(sd)
    out = _convert_state_dict(sd, architecture)
    leftover = sorted(set(sd) - sd.consumed)
    if leftover:
        print(
            f"[convert_reference_checkpoint] warning: {len(leftover)} state_dict "
            f"tensor(s) not used by the {out[2]} conversion (decode is "
            f"unaffected): {', '.join(leftover)}",
            file=sys.stderr,
        )
    return out


def _convert_state_dict(sd: dict, architecture: str):
    from ..models.base import TaggerConfig

    if architecture == "SimpleBiLSTM":
        # reference SimpleBiLSTM holds the nn.LSTM directly as `.lstm` and
        # the head as `.classifier` (models/CRF.py:895-915)
        layers, hidden, in_dim, bidir, is_lstm = _rnn_geometry(sd, "lstm")
        cls = _linear(sd, "classifier")
        cfg = TaggerConfig(
            embedding_dim=in_dim, hidden_dim=hidden, num_layers=layers,
            bidirectional=bidir, lstm=is_lstm, loss_fn="BinaryCrossEntropy",
        )
        params = {
            "rnn": _convert_rnn_stack(sd, "lstm", layers, bidir, is_lstm),
            "cls": cls,
        }
        return params, cfg, "SimpleBiLSTM"

    if architecture in ("BiLSTM", "LSTM"):
        layers, hidden, in_dim, bidir, is_lstm = _rnn_geometry(sd, "model.rnn")
        cls = _linear(sd, "classification")
        out = cls["w"].shape[1]
        cfg = TaggerConfig(
            embedding_dim=in_dim, hidden_dim=hidden, num_layers=layers,
            tagset_size=max(out, 2), bidirectional=bidir, lstm=is_lstm,
            loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
        )
        params = {
            "rnn": _convert_rnn_stack(sd, "model.rnn", layers, bidir, is_lstm),
            "cls": cls,
        }
        return params, cfg, "BiLSTM"

    if architecture == "BiLSTMLateFusion":
        layers, hidden, in1, bidir, is_lstm = _rnn_geometry(sd, "model1.rnn")
        _, _, in2, _, _ = _rnn_geometry(sd, "model2.rnn")
        cls = _linear(sd, "classification")
        out = cls["w"].shape[1]
        cfg = TaggerConfig(
            embedding_dim=in1, embedding_dim2=in2, hidden_dim=hidden,
            num_layers=layers, tagset_size=max(out, 2), bidirectional=bidir,
            lstm=is_lstm,
            loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
        )
        params = {
            "rnn1": _convert_rnn_stack(sd, "model1.rnn", layers, bidir, is_lstm),
            "rnn2": _convert_rnn_stack(sd, "model2.rnn", layers, bidir, is_lstm),
            "cls": cls,
        }
        return params, cfg, "BiLSTMLateFusion"

    if architecture in ("biLSTMCRF", "BiRnnCrf", "BiLSTM-CRF"):
        layers, hidden, in_dim, bidir, is_lstm = _rnn_geometry(sd, "model.rnn")
        trans = _to_np(sd["crf.transitions"])  # [C+2, C+2], T[i,j] = j -> i
        tagset = trans.shape[0] - 2
        cfg = TaggerConfig(
            embedding_dim=in_dim, hidden_dim=hidden, num_layers=layers,
            tagset_size=tagset, bidirectional=bidir, lstm=is_lstm,
            loss_fn="CrossEntropy",
        )
        params = {
            "rnn": _convert_rnn_stack(sd, "model.rnn", layers, bidir, is_lstm),
            "crf": {
                "fc_w": _to_np(sd["crf.fc.weight"]).T,
                "fc_b": _to_np(sd["crf.fc.bias"]),
                "transitions": trans,
            },
        }
        return params, cfg, "biLSTMCRF"

    if architecture == "MLP":
        # reference MLP keeps its hidden stack in `layers.{i}` and the head
        # as `classifier` (models/CRF.py:860-871)
        layers = []
        i = 0
        while f"layers.{i}.weight" in sd:
            layers.append(_linear(sd, f"layers.{i}"))
            i += 1
        cls = _linear(sd, "classifier")
        cfg = TaggerConfig(
            embedding_dim=layers[0]["w"].shape[0], hidden_dim=layers[0]["w"].shape[1],
            num_layers=i, loss_fn="BinaryCrossEntropy",
        )
        return {"layers": layers, "cls": cls}, cfg, "MLP"

    if architecture == "SheikhBiLSTM":
        # RNN wrapper stored as `lstm.rnn`, two projection heads
        # (models/CRF.py:985-990); `classification` exists in the state_dict
        # but is never used by loss/forward, so it is dropped here
        layers, hidden, in_dim, bidir, is_lstm = _rnn_geometry(sd, "lstm.rnn")
        cfg = TaggerConfig(
            embedding_dim=in_dim, hidden_dim=hidden, num_layers=layers,
            bidirectional=bidir, lstm=is_lstm, loss_fn="BinaryCrossEntropy",
        )
        params = {
            "rnn": _convert_rnn_stack(sd, "lstm.rnn", layers, bidir, is_lstm),
            "fwd_dense": _linear(sd, "forward_dense"),
            "bwd_dense": _linear(sd, "backward_dense"),
        }
        return params, cfg, "SheikhBiLSTM"

    if architecture == "SwitchBiLSTM":
        # two layouts (models/CRF.py:1062-1110): switch='lstm' has twin
        # towers `model_1`/`model_2` + one head; switch='dense' has one
        # tower `model` + twin heads `classification_1`/`classification_2`
        if any(k.startswith("model_1.") for k in sd):
            layers, hidden, in_dim, bidir, is_lstm = _rnn_geometry(sd, "model_1.rnn")
            cls = _linear(sd, "classification")
            out = cls["w"].shape[1]
            cfg = TaggerConfig(
                embedding_dim=in_dim, hidden_dim=hidden, num_layers=layers,
                tagset_size=max(out, 2), bidirectional=bidir, lstm=is_lstm,
                switch="lstm",
                loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
            )
            params = {
                "rnn1": _convert_rnn_stack(sd, "model_1.rnn", layers, bidir, is_lstm),
                "rnn2": _convert_rnn_stack(sd, "model_2.rnn", layers, bidir, is_lstm),
                "cls": cls,
            }
            return params, cfg, "SwitchBiLSTM"
        layers, hidden, in_dim, bidir, is_lstm = _rnn_geometry(sd, "model.rnn")
        cls1 = _linear(sd, "classification_1")
        cls2 = _linear(sd, "classification_2")
        out = cls1["w"].shape[1]
        cfg = TaggerConfig(
            embedding_dim=in_dim, hidden_dim=hidden, num_layers=layers,
            tagset_size=max(out, 2), bidirectional=bidir, lstm=is_lstm,
            switch="dense",
            loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
        )
        params = {
            "rnn": _convert_rnn_stack(sd, "model.rnn", layers, bidir, is_lstm),
            "cls1": cls1,
            "cls2": cls2,
        }
        return params, cfg, "SwitchBiLSTM"

    if architecture == "Transformer":
        return _convert_transformer_segmenter(sd)

    if architecture == "RecurrentLongT5":
        return _convert_recurrent_longt5(sd)

    if architecture in ("Transformer-CRF", "TransformerCRF"):
        raise ValueError(
            "the reference's TransformerCRF cannot produce checkpoints: its "
            "constructor passes batch_first/device/positional_encoding kwargs "
            "that NeuralArchitectures.Transformer.__init__ does not accept "
            "(TypeError at the reference's models/CRF.py:491 vs "
            "NeuralArchitectures.py:205), so no trained state_dict exists to "
            "convert"
        )

    if architecture in ("BiLSTMRestrictedMHA", "RecurrentLongformer"):
        return _convert_recurrent_longformer(sd)

    raise ValueError(
        f"no conversion rule for architecture {architecture!r}; supported: "
        "BiLSTM, BiLSTMLateFusion, biLSTMCRF, SimpleBiLSTM, MLP, "
        "SheikhBiLSTM, SwitchBiLSTM, Transformer, RecurrentLongT5, "
        "RecurrentLongformer"
    )


def _convert_transformer_segmenter(sd: dict):
    """Transformer_segmenter (models/CRF.py:508-610): `model.model` is a real
    HF LongformerModel (restricted=True — the only configuration TextSegmenter
    can build, lightning_model.py:212) or BertModel (restricted=False), plus a
    `classification` head. The HF-weight mapping mirrors the oracle transplant
    proven boundary-identical in the JAX package's tests (test_reference_oracle.py:439-533): with
    inputs_embeds, HF adds position_embeddings (Longformer ids offset by
    padding_idx+1 = 2; Bert ids start at 0) and the constant
    token_type_embeddings[0] before the embedding LayerNorm; both fold into
    the taggers' single positional table. nheads / attention_window are
    NOT recoverable from tensor shapes — TextSegmenter never saves
    hyperparameters, the reference re-supplies them at load time
    (predict.py:228-241) — so the reference CLI defaults (8 / 120,
    lightning_model.py:183-184) are assumed; pass --nheads/--attention_window
    to override."""
    from ..models.base import TaggerConfig

    m = "model.model"
    longformer = any(".attention.self.query_global." in k for k in sd)
    tok0 = _to_np(sd[f"{m}.embeddings.token_type_embeddings.weight"])[0]
    pos = _to_np(sd[f"{m}.embeddings.position_embeddings.weight"])
    if longformer:
        pos = pos[2:]  # Longformer position ids start at padding_idx+1 = 2
    enc = {
        "pos": pos + tok0,
        "ln_emb": {
            "scale": _to_np(sd[f"{m}.embeddings.LayerNorm.weight"]),
            "bias": _to_np(sd[f"{m}.embeddings.LayerNorm.bias"]),
        },
        "layers": [],
    }

    def ln(prefix):
        return {
            "scale": _to_np(sd[f"{prefix}.weight"]),
            "bias": _to_np(sd[f"{prefix}.bias"]),
        }

    i = 0
    while f"{m}.encoder.layer.{i}.attention.self.query.weight" in sd:
        p = f"{m}.encoder.layer.{i}"
        enc["layers"].append({
            "attn": {
                "q": _linear(sd, f"{p}.attention.self.query"),
                "k": _linear(sd, f"{p}.attention.self.key"),
                "v": _linear(sd, f"{p}.attention.self.value"),
                "o": _linear(sd, f"{p}.attention.output.dense"),
            },
            "ln1": ln(f"{p}.attention.output.LayerNorm"),
            "ff1": _linear(sd, f"{p}.intermediate.dense"),
            "ff2": _linear(sd, f"{p}.output.dense"),
            "ln2": ln(f"{p}.output.LayerNorm"),
        })
        i += 1
    cls = _linear(sd, "classification")
    out = cls["w"].shape[1]
    d_model = cls["w"].shape[0]
    d_ff = enc["layers"][0]["ff1"]["w"].shape[1]
    cfg = TaggerConfig(
        embedding_dim=d_model, hidden_dim=d_ff, num_layers=i,
        tagset_size=max(out, 2),
        # attention_window=0 encodes the dense (restricted=False BertModel)
        # variant; the registry builds TransformerSegmenter(restricted=False)
        attention_window=120 if longformer else 0,
        loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
    )
    return {"encoder": enc, "cls": cls}, cfg, "Transformer"


def _convert_recurrent_longt5(sd: dict):
    """RecurrentLongT5 (models/CRF.py:613-762): a ModuleList of
    [RNN-wrapped BiLSTM -> HF LongT5EncoderModel] blocks + classification.
    Mirrors the oracle transplant of the JAX tests (test_reference_oracle.py:579-611):
    T5 linears carry no biases, every layer shares block-0's
    relative_attention_bias, and RMSNorms have scale only. nheads and the
    local radius ARE recoverable here: the shared relative_attention_bias
    table is [num_buckets, nheads] with num_buckets = max(4, radius)
    (RestrictedTransformerLayer.py:155-156; `radius+1//4` == radius)."""
    from ..models.base import TaggerConfig

    blocks = []
    if "model.0.lstm.rnn.weight_ih_l0" not in sd:
        # routed here by '.LocalSelfAttention.' keys, but the nesting does
        # not match the reference's Lightning layout — fail with the same
        # curated message every other path gives, not a bare KeyError
        raise ValueError(
            "checkpoint has LongT5 LocalSelfAttention keys but no "
            "'model.{i}.lstm.rnn.*' block prefix; only reference "
            "RecurrentLongT5 TextSegmenter checkpoints "
            "(models/CRF.py:613-762, saved through Lightning) have a "
            "conversion rule"
        )
    i = 0
    while f"model.{i}.lstm.rnn.weight_ih_l0" in sd:
        b = f"model.{i}"
        stack = _convert_rnn_stack(sd, f"{b}.lstm.rnn", 1, True, True)

        def nob(name):
            import numpy as np

            # T5 linears carry no biases; the taggers' shared linear does
            w = _to_np(sd[name + ".weight"]).T
            return {"w": w, "b": np.zeros((w.shape[1],), w.dtype)}

        t = f"{b}.transformer.model.encoder"
        layers = []
        j = 0
        while f"{t}.block.{j}.layer.0.LocalSelfAttention.q.weight" in sd:
            p = f"{t}.block.{j}"
            layers.append({
                "attn": {
                    "q": nob(f"{p}.layer.0.LocalSelfAttention.q"),
                    "k": nob(f"{p}.layer.0.LocalSelfAttention.k"),
                    "v": nob(f"{p}.layer.0.LocalSelfAttention.v"),
                    "o": nob(f"{p}.layer.0.LocalSelfAttention.o"),
                },
                "ln1": {"scale": _to_np(sd[f"{p}.layer.0.layer_norm.weight"])},
                "wi": nob(f"{p}.layer.1.DenseReluDense.wi"),
                "wo": nob(f"{p}.layer.1.DenseReluDense.wo"),
                "ln2": {"scale": _to_np(sd[f"{p}.layer.1.layer_norm.weight"])},
            })
            j += 1
        rel = _to_np(
            sd[f"{t}.block.0.layer.0.LocalSelfAttention.relative_attention_bias.weight"]
        )
        blocks.append({
            "lstm": stack[0],
            "t5": {
                "layers": layers,
                "rel_bias": rel,
                "ln_final": {"scale": _to_np(sd[f"{t}.final_layer_norm.weight"])},
            },
        })
        i += 1

    _, hidden, in_dim, _, _ = _rnn_geometry(sd, "model.0.lstm.rnn")
    cls = _linear(sd, "classification")
    out = cls["w"].shape[1]
    num_buckets, nheads = rel.shape
    cfg = TaggerConfig(
        embedding_dim=in_dim, hidden_dim=hidden, num_layers=i,
        tagset_size=max(out, 2), nheads=nheads,
        # radius < 4 is not distinguishable from radius == num_buckets == 4;
        # reference configs use radius >= 4 (default 127, CRF.py:618)
        attention_window=num_buckets,
        loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
    )
    return {"blocks": blocks, "cls": cls}, cfg, "RecurrentLongT5"


def _convert_recurrent_longformer(sd: dict):
    """RecurrentLongformer / BiLSTMRestrictedMHA (models/CRF.py:764-858): a
    ModuleList of [RNN-wrapped BiLSTM -> vendored "noffn" LongformerLayer]
    blocks, an optional trailing RNN (last_bilstm=True, the TextSegmenter
    default), and `classification`. The vendored layer ships as 3.10
    bytecode only; its state_dict layout and forward glue were recovered by
    direct bytecode decoding (the JAX package's tools/pyc310.py, receipts in
    its test_reference_pyc_glue.py): the layer holds ONLY
    `attention.self.{query,key,value}` plus HF's never-executed
    `{query,key,value}_global` projections (reported as unconsumed), no
    SelfOutput/FFN/LayerNorm. separate_forward_backward is recovered from
    the query projection's width (== hidden_dim, vs 2*hidden_dim for the
    fused path). nheads / attention_window are NOT recoverable from tensor
    shapes — the reference re-supplies them at load time (predict.py:228-241)
    — so the reference CLI defaults (8 / 120) are assumed; pass
    --nheads/--attention_window to override."""
    from ..models.base import TaggerConfig

    if "model.0.lstm.rnn.weight_ih_l0" not in sd:
        raise ValueError(
            "checkpoint has RecurrentLongformer-shaped keys but no "
            "'model.{i}.lstm.rnn.*' block prefix; only reference "
            "RecurrentLongformer TextSegmenter checkpoints "
            "(models/CRF.py:764-858, saved through Lightning) have a "
            "conversion rule"
        )
    blocks = []
    i = 0
    while f"model.{i}.lstm.rnn.weight_ih_l0" in sd:
        b = f"model.{i}"
        stack = _convert_rnn_stack(sd, f"{b}.lstm.rnn", 1, True, True)
        a = f"{b}.transformer.model.attention.self"
        blocks.append({
            "lstm": stack[0],
            "attn": {
                "q": _linear(sd, f"{a}.query"),
                "k": _linear(sd, f"{a}.key"),
                "v": _linear(sd, f"{a}.value"),
            },
        })
        i += 1

    _, hidden, in_dim, _, _ = _rnn_geometry(sd, "model.0.lstm.rnn")
    attn_dim = blocks[0]["attn"]["q"]["w"].shape[0]
    if attn_dim != hidden:  # == 2*hidden for the fused (sep_fb=False) path
        raise ValueError(
            "this RecurrentLongformer checkpoint was trained with "
            "separate_forward_backward=False (attention width == 2*hidden); "
            "TextSegmenter only builds the default sep_fb=True configuration "
            "(lightning_model.py:215-216) and the registry mirrors it — "
            "pass the params to models.transformers.RecurrentLongformer("
            "cfg, separate_forward_backward=False) directly"
        )
    params = {"blocks": blocks}
    if f"model.{i}.rnn.weight_ih_l0" in sd:  # last_bilstm tail
        params["final_lstm"] = _convert_rnn_stack(
            sd, f"model.{i}.rnn", 1, True, True
        )[0]
    cls = _linear(sd, "classification")
    params["cls"] = cls
    out = cls["w"].shape[1]
    cfg = TaggerConfig(
        embedding_dim=in_dim, hidden_dim=hidden, num_layers=i,
        tagset_size=max(out, 2), nheads=8, attention_window=120,
        loss_fn="CrossEntropy" if out > 1 else "BinaryCrossEntropy",
    )
    # the TextSegmenter dispatch name (lightning_model.py:215), which is what
    # results.txt records and the registry resolves
    return params, cfg, "BiLSTMRestrictedMHA"


def load_torch_checkpoint(path: str, architecture: str = None):
    """Read a torch/Lightning checkpoint file -> (params, cfg, arch)."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    if not isinstance(state_dict, dict) or not any(
        re.search(r"weight_ih_l0|encoder\.(layer|block)\.0\.", k)
        for k in state_dict
    ):
        raise ValueError(f"{path!r} does not look like a TextSegmenter checkpoint")
    return convert_state_dict(state_dict, architecture)


def convert_checkpoint(in_path: str, out_path: str, architecture: str = None,
                       nheads: int = None, attention_window: int = None):
    import dataclasses

    from ..train import checkpoints as ckpt_lib

    params, cfg, arch = load_torch_checkpoint(in_path, architecture)
    # Transformer checkpoints do not record nheads/attention_window (the
    # reference re-supplies them at load time); let the user override the
    # assumed CLI defaults
    overrides = {}
    if nheads is not None:
        overrides["nheads"] = nheads
    if attention_window is not None:
        overrides["attention_window"] = attention_window
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ckpt_lib.save(out_path, params, cfg, arch, extra={"converted_from": in_path})
    return params, cfg, arch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help="reference torch/Lightning checkpoint")
    ap.add_argument("output", help="port checkpoint to write (the JAX package's format)")
    ap.add_argument("--architecture", default=None,
                    help="override the architecture inferred from the keys")
    ap.add_argument("--nheads", type=int, default=None,
                    help="attention heads for Transformer checkpoints (not "
                         "recorded in the state_dict; reference default 8)")
    ap.add_argument("--attention_window", type=int, default=None,
                    help="base attention window for Transformer checkpoints "
                         "(not recorded in the state_dict; reference default "
                         "120)")
    args = ap.parse_args(argv)
    _, cfg, arch = convert_checkpoint(args.input, args.output, args.architecture,
                                      args.nheads, args.attention_window)
    print(f"converted {args.input} -> {args.output} ({arch}, "
          f"D={cfg.embedding_dim}, H={cfg.hidden_dim}, layers={cfg.num_layers}, "
          f"loss={cfg.loss_fn})")


if __name__ == "__main__":
    main()
