"""Port BiLSTM tagger (models/taggers.py over ops/rnn.py) against the JAX
package's `BiLSTMTagger.decode`, and checkpoint interchange both ways."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.models.taggers import BiLSTMTagger as JaxBiLSTM
from multimodaltopicsegmentation_tpu.tools.convert_reference_checkpoint import convert_state_dict
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.models.taggers import BiLSTMTagger
from multimodaltopicsegmentation_torch.train import checkpoints as ckpt


def _cfgs(**kw):
    base = dict(embedding_dim=12, hidden_dim=8, num_layers=2, loss_fn="FocalLoss")
    base.update(kw)
    return JaxTaggerConfig(**base), TaggerConfig(**base)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 9, 12)).astype(np.float32)
    lengths = np.array([9, 5, 0, 1], np.int32)
    return x, lengths


def _port(params, cfg):
    m = BiLSTMTagger(cfg)
    m.load_state_dict(BiLSTMTagger.from_jax_params(jax.tree.map(np.asarray, params)))
    return m.eval()


@pytest.mark.parametrize("cell,loss_fn,bidirectional", [
    ("lstm", "FocalLoss", True), ("gru", "FocalLoss", True),
    ("lstm", "CrossEntropy", True), ("lstm", "BinaryCrossEntropy", False),
])
def test_scores_and_tags_match_jax(cell, loss_fn, bidirectional):
    jcfg, cfg = _cfgs(lstm=cell == "lstm", loss_fn=loss_fn, bidirectional=bidirectional)
    arch = JaxBiLSTM(jcfg)
    params = arch.init(jax.random.PRNGKey(0))
    x, lengths = _batch()
    want_scores, want_tags = arch.decode(params, jnp.asarray(x), jnp.asarray(lengths), 0.5)
    with torch.no_grad():
        scores, tags = _port(params, cfg).decode(torch.from_numpy(x), torch.from_numpy(lengths), 0.5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-5)
    np.testing.assert_array_equal(tags.numpy(), np.asarray(want_tags))


def test_legacy_fused_lstm_bias():
    jcfg, cfg = _cfgs()
    arch = JaxBiLSTM(jcfg)
    params = jax.tree.map(np.asarray, arch.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    for layer in params["rnn"]:
        for d in layer.values():
            d["b_ih"] = rng.standard_normal(d["b_ih"].shape).astype(np.float32)
            d["b"] = d.pop("b_ih") + d.pop("b_hh")
    x, lengths = _batch(1)
    want, _ = arch.decode(params, jnp.asarray(x), jnp.asarray(lengths), 0.5)
    with torch.no_grad():
        got, _ = _port(params, cfg).decode(torch.from_numpy(x), torch.from_numpy(lengths), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_state_dict_through_reference_converter():
    """The port's state_dict under the reference Lightning prefix converts
    with the JAX package's converter and scores the same there."""
    _, cfg = _cfgs(loss_fn="BinaryCrossEntropy")
    port = BiLSTMTagger(cfg, torch.Generator().manual_seed(0)).eval()
    params, jcfg, name = convert_state_dict({f"model.{k}": v for k, v in port.state_dict().items()})
    assert name == "BiLSTM" and jcfg.hidden_dim == 8 and jcfg.num_layers == 2
    x, lengths = _batch(2)
    want, _ = JaxBiLSTM(jcfg).decode(params, jnp.asarray(x), jnp.asarray(lengths), 0.5)
    with torch.no_grad():
        got, _ = port.decode(torch.from_numpy(x), torch.from_numpy(lengths), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_checkpoints_interchange(tmp_path):
    """A JAX-written checkpoint (its dtype pickled as a jax.numpy global)
    loads into the port, and a port-written one loads into JAX."""
    jcfg, cfg = _cfgs()
    arch = JaxBiLSTM(jcfg)
    params = arch.init(jax.random.PRNGKey(2))
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save(path, params, jcfg, "BiLSTM")
    got_params, got_cfg, name, extra = ckpt.load(path)
    assert name == "BiLSTM" and extra == {}
    assert dataclasses.replace(got_cfg, dtype=torch.float32) == cfg

    port = registry.build(name, got_cfg)
    port.load_state_dict(BiLSTMTagger.from_jax_params(got_params))
    out = str(tmp_path / "port.ckpt")
    ckpt.save(out, port.to_jax_params(), got_cfg, name)
    back, back_cfg, back_name, _ = jax_ckpt.load(out)
    assert back_name == "BiLSTM" and back_cfg == jcfg
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_name_grammar():
    name = ckpt.checkpoint_name(3, 0.12345, 0.4)
    assert name == jax_ckpt.checkpoint_name(3, 0.12345, 0.4)
    assert ckpt.parse_checkpoint_name(name) == jax_ckpt.parse_checkpoint_name(name)
    t, loss = ckpt.parse_checkpoint_name("final=0.500.ckpt")
    assert t == 0.5 and np.isnan(loss)


def test_registry_refuses_unported_architectures():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.build("Transformer", TaggerConfig())
