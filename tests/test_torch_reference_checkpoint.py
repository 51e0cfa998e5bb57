"""The port's reference-checkpoint converter
(tools/convert_reference_checkpoint.py) and the predict CLI's fallback onto
it, against the JAX package's converter and predict CLI.

Reference-layout Lightning checkpoints (`{"state_dict": {"model." + key:
tensor}}`) are made for every architecture the converter handles: the
torch stand-ins of tests/test_reference_interop.py for BiLSTM (BCE and CE
heads), GRU, unidirectional LSTM, SimpleBiLSTM, late fusion and biLSTMCRF;
for MLP, SheikhBiLSTM, SwitchBiLSTM (both layouts), Transformer (HF
Longformer and BERT names), RecurrentLongT5 and RecurrentLongformer the
names the JAX converter reads, shaped from a port tagger, plus the tensors a
reference checkpoint carries that no rule reads (the Longformer's global
projections, Sheikh's vestigial head). Every tensor is numpy-seeded.

Each converts with both packages to the same architecture name, the same
config fields, leaf-for-leaf equal pytrees and the same stderr warning; the
JAX tagger on the JAX pytree and the port tagger on the port pytree then
give logits within 1e-5 and identical tags (CRF paths). The refusals raise
the JAX converter's messages, and the port's predict CLI serves a reference
checkpoint with JAX's results.pkl."""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.cli import predict as JP
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.tools import convert_reference_checkpoint as JC
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_torch.cli import predict as PP
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.tools import convert_reference_checkpoint as PC
from multimodaltopicsegmentation_torch.train import checkpoints as port_ckpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

D, H = 16, 8


# ---- torch stand-ins with the reference's module attribute names ----------
class RefRNN(nn.Module):
    def __init__(self, d, h, layers, bidirectional=True, lstm=True):
        super().__init__()
        self.rnn = (nn.LSTM if lstm else nn.GRU)(d, h, num_layers=layers, batch_first=True,
                                                 bidirectional=bidirectional)


class RefBiLSTM(nn.Module):
    def __init__(self, out=1, lstm=True, layers=2, bidirectional=True):
        super().__init__()
        self.model = RefRNN(D, H, layers, bidirectional, lstm)
        self.classification = nn.Linear((2 if bidirectional else 1) * H, out)


class RefLateFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.model1 = RefRNN(D, H, 1)
        self.model2 = RefRNN(6, H, 1)
        self.classification = nn.Linear(4 * H, 1)


class RefCRF(nn.Module):
    def __init__(self, in_features, num_tags):
        super().__init__()
        self.fc = nn.Linear(in_features, num_tags + 2)
        self.transitions = nn.Parameter(torch.zeros(num_tags + 2, num_tags + 2))


class RefBiRnnCrf(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = RefRNN(D, H, 2)
        self.crf = RefCRF(2 * H, 2)


class RefSimpleBiLSTM(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(D, H, 1, bidirectional=True, batch_first=True)
        self.classifier = nn.Linear(2 * H, 1)


def _random(sd, seed):
    """Every tensor redrawn from a seeded numpy generator (CRF walls kept)."""
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy((0.4 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
           for k, v in sd.items()}
    for k, v in out.items():
        if k.endswith("crf.transitions"):
            v[-2, :] = -1e4
            v[:, -1] = -1e4
    return out


def _port_sd(architecture, **kw):
    cfg = dict(embedding_dim=D, hidden_dim=H, num_layers=2, loss_fn="BinaryCrossEntropy")
    cfg.update(kw)
    return registry.build(architecture, TaggerConfig(**cfg),
                          torch.Generator().manual_seed(0)).state_dict()


def _transformer(longformer, dim=D):
    """HF Longformer (position ids from padding_idx + 1 = 2, one token type,
    global projections) or BertModel names for TransformerSegmenter."""
    sd = _port_sd("Transformer", nheads=8, attention_window=120, embedding_dim=dim)
    out = {}
    for k, v in sd.items():
        if k.endswith("embeddings.position_table"):
            rows = v.shape[0] + (2 if longformer else 0)
            out["model.model.embeddings.position_embeddings.weight"] = torch.zeros(rows, dim)
            out["model.model.embeddings.token_type_embeddings.weight"] = \
                torch.zeros(1 if longformer else 2, dim)
            continue
        out[k] = v
        if longformer and k.endswith("attention.self.query.weight"):
            for g in ("query_global", "key_global", "value_global"):
                out[k.replace("query.weight", f"{g}.weight")] = v
                out[k.replace("query.weight", f"{g}.bias")] = torch.zeros(v.shape[0])
    return out


def _recurrent_longt5():
    sd = _port_sd("RecurrentLongT5", nheads=2, attention_window=8)
    return {k: v for k, v in sd.items() if not (".transformer." in k and k.endswith(".bias"))}


def _recurrent_longformer():
    sd = dict(_port_sd("BiLSTMRestrictedMHA", hidden_dim=16))
    for k in [k for k in sd if k.endswith("attention.self.query.weight")]:
        for g in ("query_global", "key_global", "value_global"):
            sd[k.replace("query.weight", f"{g}.weight")] = sd[k]
    return sd


def _sheikh():
    sd = dict(_port_sd("SheikhBiLSTM"))
    sd["classification.weight"], sd["classification.bias"] = torch.zeros(1, 2 * H), torch.zeros(1)
    return sd


# (id, reference state dict before the Lightning prefix, inferred architecture)
CASES = [
    ("BiLSTM-BCE", lambda: RefBiLSTM(out=1).state_dict(), "BiLSTM"),
    ("BiLSTM-CE", lambda: RefBiLSTM(out=2).state_dict(), "BiLSTM"),
    ("GRU", lambda: RefBiLSTM(lstm=False, layers=1).state_dict(), "BiLSTM"),
    ("unidirectional", lambda: RefBiLSTM(layers=1, bidirectional=False).state_dict(), "BiLSTM"),
    ("SimpleBiLSTM", lambda: RefSimpleBiLSTM().state_dict(), "SimpleBiLSTM"),
    ("BiLSTMLateFusion", lambda: RefLateFusion().state_dict(), "BiLSTMLateFusion"),
    ("biLSTMCRF", lambda: RefBiRnnCrf().state_dict(), "biLSTMCRF"),
    ("MLP", lambda: _port_sd("MLP"), "MLP"),
    ("SheikhBiLSTM", _sheikh, "SheikhBiLSTM"),
    ("SwitchBiLSTM-dense", lambda: _port_sd("SwitchBiLSTM", switch="dense"), "SwitchBiLSTM"),
    ("SwitchBiLSTM-lstm", lambda: _port_sd("SwitchBiLSTM", switch="lstm"), "SwitchBiLSTM"),
    ("Transformer-Longformer", lambda: _transformer(True), "Transformer"),
    ("Transformer-BERT", lambda: _transformer(False), "Transformer"),
    ("RecurrentLongT5", _recurrent_longt5, "RecurrentLongT5"),
    ("RecurrentLongformer", _recurrent_longformer, "RecurrentLongformer"),
]
IDS = [c[0] for c in CASES]
WARNS = {"SheikhBiLSTM", "Transformer-Longformer", "RecurrentLongformer"}


def _lightning(sd, seed, path):
    sd = _random({"model." + k: v for k, v in sd.items()}, seed)
    torch.save({"state_dict": sd, "hyper_parameters": {}}, path)
    return sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree) for leaf in _leaves(t, f"{prefix}[{i}]")]
    return [(prefix, np.asarray(tree))]


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def _convert_both(sd, capsys, architecture=None):
    capsys.readouterr()
    want = JC.convert_state_dict(sd, architecture)
    want_err = capsys.readouterr().err
    got = PC.convert_state_dict(sd, architecture)
    got_err = capsys.readouterr().err
    assert got_err == want_err
    return want, got, got_err


def _batch(architecture, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([17, 9, 1], np.int32)
    return {"x": rng.standard_normal((3, 17, D)).astype(np.float32), "lengths": lengths,
            "x2": rng.standard_normal((3, 17, 6)).astype(np.float32),
            "domain": np.array([1, 0, 1], np.int32)}


def _decode_jax(name, cfg, params, b):
    arch = jax_registry.build(name, cfg)
    x, lengths = jnp.asarray(b["x"]), jnp.asarray(b["lengths"])
    if name == "SwitchBiLSTM":
        return arch.decode(params, x, lengths, jnp.asarray(b["domain"]), 0.5)
    if name == "BiLSTMLateFusion":
        return arch.decode(params, x, lengths, 0.5, x2=jnp.asarray(b["x2"]))
    return arch.decode(params, x, lengths, 0.5)


def _decode_port(name, cfg, params, b):
    tagger = registry.build(name, cfg)
    tagger.load_state_dict(type(tagger).from_jax_params(params))
    x, lengths, x2, dom = (torch.from_numpy(b[k]) for k in ("x", "lengths", "x2", "domain"))
    with torch.no_grad():
        if name == "SwitchBiLSTM":
            return tagger.eval().decode(x, lengths, dom, 0.5)
        if name == "BiLSTMLateFusion":
            return tagger.eval().decode(x, lengths, 0.5, x2=x2)
        return tagger.eval().decode(x, lengths, 0.5)


@pytest.mark.parametrize("case,make,inferred", CASES, ids=IDS)
def test_conversion_and_logits_equal_jax(tmp_path, capsys, case, make, inferred):
    path = str(tmp_path / "ref.ckpt")
    sd = _lightning(make(), seed=IDS.index(case), path=path)
    stripped = PC._strip_prefix(sd)
    assert PC.infer_architecture(stripped) == JC.infer_architecture(stripped) == inferred

    (jparams, jcfg, jname), (params, cfg, name), err = _convert_both(sd, capsys)
    assert name == jname
    assert isinstance(cfg, TaggerConfig) and _fields(cfg) == _fields(jcfg)
    assert bool(err) == (case in WARNS)
    got, want = _leaves(params), _leaves(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), p

    b = _batch(name, seed=IDS.index(case))
    want_scores, want_tags = _decode_jax(jname, jcfg, jax.tree.map(jnp.asarray, jparams), b)
    scores, tags = _decode_port(name, cfg, params, b)
    want_scores, want_tags = np.asarray(want_scores), np.asarray(want_tags)
    if name == "biLSTMCRF":  # one Viterbi score per document, tags are the paths
        np.testing.assert_allclose(scores.numpy(), want_scores, atol=1e-5, rtol=1e-6)
    else:
        for i, n in enumerate(b["lengths"]):
            np.testing.assert_allclose(scores.numpy()[i, :n], want_scores[i, :n], atol=1e-5,
                                       rtol=0)
    for i, n in enumerate(b["lengths"]):
        np.testing.assert_array_equal(tags.numpy()[i, :n].astype(int),
                                      want_tags[i, :n].astype(int))


def _fused_recurrent_longformer():
    sd = _recurrent_longformer()
    for k in [k for k in sd if ".attention.self." in k]:
        sd[k] = torch.zeros((32, 32) if k.endswith("weight") else (32,))
    return sd


REFUSALS = [
    ("Transformer-CRF", lambda: RefBiLSTM().state_dict(), "Transformer-CRF"),
    ("unknown", lambda: RefBiLSTM().state_dict(), "Nope"),
    ("LongT5 without blocks",
     lambda: {"model.x.LocalSelfAttention.q.weight": torch.zeros(4, 4),
              "model.encoder.block.0.x": torch.zeros(1)}, None),
    ("fused RecurrentLongformer", _fused_recurrent_longformer, None),
    ("not a TextSegmenter", lambda: {"head.weight": torch.zeros(2, 2)}, None),
    # both loaders look for recurrent or encoder keys, which an MLP has not:
    # its state dict converts through convert_state_dict only
    ("MLP file", lambda: _port_sd("MLP"), None),
]


@pytest.mark.parametrize("case,make,architecture", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_refusals_equal_jax(tmp_path, case, make, architecture):
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {"model." + k: v for k, v in make().items()}}, path)
    with pytest.raises(ValueError) as want:
        JC.load_torch_checkpoint(path, architecture)
    with pytest.raises(ValueError) as got:
        PC.load_torch_checkpoint(path, architecture)
    if case == "Transformer-CRF":  # the JAX message names the reference's path on its host
        cut = "(TypeError at "
        assert str(got.value).split(cut)[0] == str(want.value).split(cut)[0]
        assert "models/CRF.py:491 vs NeuralArchitectures.py:205" in str(got.value)
    else:
        assert str(got.value) == str(want.value)


def test_convert_checkpoint_main_writes_jax_readable_file(tmp_path, capsys):
    src = str(tmp_path / "ref.ckpt")
    _lightning(_transformer(True), seed=21, path=src)
    out, jout = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    PC.main([src, out, "--nheads", "4", "--attention_window", "16"])
    assert "converted" in capsys.readouterr().out
    jparams, jcfg, jname = JC.convert_checkpoint(src, jout, None, 4, 16)
    for loader in (port_ckpt.load, jax_ckpt.load):
        params, cfg, name, extra = loader(out)
        assert name == jname == "Transformer" and extra == {"converted_from": src}
        assert (cfg.nheads, cfg.attention_window) == (4, 16) == (jcfg.nheads, jcfg.attention_window)
        for (p, a), (_, b) in zip(_leaves(params), _leaves(jparams)):
            assert np.array_equal(a, b), p


def _one_jax_device(monkeypatch):
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])


def _served_reference(tmp_path, sd, architecture, dim=D):
    """A reference-layout checkpoint of `sd` (redrawn), its results.txt and
    five [n, dim] embedding files, the head's bias set so that the first
    file's median unit scores 0.5 (random heads score one side of it).
    -> predict's arguments for them."""
    ckpt = str(tmp_path / "best_model")
    sd = _lightning(sd, seed=31, path=ckpt)
    hyp = tmp_path / "results.txt"
    hyp.write_text(f"Sentence encoder: CNN\nNeural architecture: {architecture}\n"
                   f"Hidden units: {H}\nNumber of layers: 2\n")
    emb = tmp_path / "emb"
    emb.mkdir()
    rng = np.random.default_rng(32)
    for d, n in enumerate((40, 23, 9, 31, 5)):
        np.save(emb / f"doc{d}.npy", rng.standard_normal((n, dim)).astype(np.float32))
    params, cfg, name = PC.convert_state_dict(sd)
    tagger = registry.build(name, cfg)
    tagger.load_state_dict(type(tagger).from_jax_params(params))
    x = torch.from_numpy(np.load(emb / "doc0.npy"))[None]
    with torch.no_grad():
        sd["model.classification.bias"] -= tagger.eval().scores(x, torch.tensor([40])).median()
    torch.save({"state_dict": sd, "hyper_parameters": {}}, ckpt)
    return ["-ef", str(emb), "-hyp", str(hyp), "-model", ckpt, "-bs", "4", "-rjs", "-th", "0.5"]


@pytest.mark.parametrize("case", ["BiLSTM-BCE", "Transformer-Longformer"])
def test_predict_serves_reference_checkpoint_as_jax(tmp_path, monkeypatch, case):
    _one_jax_device(monkeypatch)
    _, make, architecture = CASES[IDS.index(case)]
    common = _served_reference(tmp_path, make(), architecture)
    JP.cli_main(common + ["-exp", str(tmp_path / "jax")])
    got = PP.cli_main(common + ["-exp", str(tmp_path / "port"), "--device", "cpu"])
    results = []
    for exp in ("jax", "port"):
        with open(tmp_path / exp / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[1] == results[0]
    assert got == [results[0][f"doc{d}.npy"] for d in range(5)]
    assert 0 < sum(map(sum, got)) < sum(map(len, got))


@pytest.mark.cuda
@pytest.mark.parametrize("case,make,k2", [
    ("BiLSTM-BCE", lambda: RefBiLSTM(out=1).state_dict(), 0),
    # 8 heads of 64 / 8 = 8 dims: the flash kernel takes head dims in multiples of 4
    ("Transformer-Longformer", lambda: _transformer(True, dim=64), 4)])
def test_cuda_predict_serves_reference_checkpoint_as_the_cpu(tmp_path, case, make, k2):
    """A reference-layout checkpoint through predict's converter fallback on
    the card: the results.pkl of the CPU; the Transformer's two layers over
    the two chunks of -bs 4 launch K2 4 times."""
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    architecture = case.split("-")[0]
    common = _served_reference(tmp_path, make(), architecture,
                               64 if architecture == "Transformer" else D)
    FA._flash_fwd.launches = 0
    got = PP.cli_main(common + ["-exp", str(tmp_path / "card"), "--device", "cuda"])
    assert FA._flash_fwd.launches == k2
    want = PP.cli_main(common + ["-exp", str(tmp_path / "cpu"), "--device", "cpu"])
    results = []
    for exp in ("card", "cpu"):
        with open(tmp_path / exp / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[0] == results[1] and got == want
    assert 0 < sum(map(sum, got)) < sum(map(len, got))


def test_predict_names_both_formats_when_neither_loads(tmp_path):
    bad = tmp_path / "garbage"
    bad.write_bytes(b"not a checkpoint")
    hyp = tmp_path / "results.txt"
    hyp.write_text("Sentence encoder: CNN\nNeural architecture: BiLSTM\n")
    with pytest.raises(RuntimeError, match="neither a checkpoint of this package nor a "
                                           "convertible reference torch checkpoint"):
        PP.Predictor(str(hyp), str(bad), device="cpu")
    assert os.path.exists(bad)
