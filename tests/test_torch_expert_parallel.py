"""The port's expert parallelism (parallel/expert.py) on 2 gloo ranks on
the CPU against the JAX package's single-device SwitchBiLSTM('lstm'): one
LSTM tower per rank, combined by a masked all-reduce whose backward is the
identity. Logits, loss and the step's gradients (towers summed over the
ranks, the head from index 0) to 1e-4, which a doubled gradient would miss
by a factor 2; each rank's own backward touches only its tower and the
head; the Trainer turns the mode on by itself and equals the one-process
Trainer; `split_towers` / `join_towers` carry the JAX parameters.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_dist_workers as W
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.parallel import expert as EX
from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks
from multimodaltopicsegmentation_torch.train.loop import Trainer

pytestmark = pytest.mark.torch_distributed

TOL = 1e-4
CFG = dict(embedding_dim=32, hidden_dim=16, num_layers=2, loss_fn="FocalLoss", switch="lstm")
B, L = 5, 24
LENGTHS = np.array([24, 13, 0, 20, 7], np.int32)
FIT_LENGTHS = np.array([24, 13, 5, 20, 7], np.int32)  # test() scores every document
DOMAINS = np.array([1, 0, 1, 1, 0], np.int32)


def _inputs(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, 32)).astype(np.float32)
    tags = (rng.random((B, L)) < 0.2).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    return x, tags


@pytest.fixture(scope="module")
def experts(tmp_path_factory):
    jarch = jax_registry.build("SwitchBiLSTM", JaxTaggerConfig(**CFG))
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(0)))
    x, tags = _inputs(0)
    fx, ftags = _inputs(1, FIT_LENGTHS)
    fit_batch = {"src_tokens": fx, "tgt_tokens": ftags, "src_lengths": FIT_LENGTHS,
                 "domain": DOMAINS, "n_real": B}
    out = str(tmp_path_factory.mktemp("expert"))
    spawn_ranks(W.expert_case, 2, (out, CFG, params, x, LENGTHS, tags, DOMAINS, fit_batch),
                "cpu", timeout=300, store_dir=out)
    return jarch, params, x, tags, fit_batch, W.load(out, 2)


def test_expert_logits_loss_and_gradients_match_jax(experts):
    jarch, params, x, tags, _, ranks = experts
    xs, ls, ts, ds = (jnp.asarray(a) for a in (x, LENGTHS, tags, DOMAINS))
    want_logits = np.asarray(jarch.scores(params, xs, ls, ds))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jarch.loss(p, xs, ls, ts, ds))(params)
    port = registry.build("SwitchBiLSTM", TaggerConfig(**CFG))
    want_grads = registry.grads_from_jax(port, jax.tree.map(np.asarray, want_grads))
    valid = np.arange(L)[None, :] < LENGTHS[:, None]
    for r in ranks:
        np.testing.assert_allclose(r["logits"][valid], want_logits[valid], atol=TOL, rtol=0)
        assert r["loss"] == pytest.approx(float(want_loss), abs=TOL)
        for name, g in want_grads.items():
            np.testing.assert_allclose(r["grads"][name], g.numpy(), atol=TOL, rtol=0,
                                       err_msg=name)
    # before the sync, a rank's backward reached its own tower and the head only
    for r, (mine, other) in zip(ranks, (("model_1", "model_2"), ("model_2", "model_1"))):
        assert any(n.startswith(mine) for n in r["local"])
        assert not any(n.startswith(other) for n in r["local"])
        assert any(n.startswith("classification") for n in r["local"])


def test_expert_trainer_turns_on_and_equals_one_process(experts, tmp_path):
    _, _, _, _, fit_batch, ranks = experts
    trainer = Trainer("SwitchBiLSTM", TaggerConfig(**CFG), lr=1e-3, max_epochs=3,
                      check_dir=str(tmp_path), seed=0, device="cpu")
    assert trainer.expert_mesh is None  # one process: the dense towers
    _, history = trainer.fit([fit_batch], [fit_batch])
    test, _, _ = trainer.test(trainer.params, [fit_batch])
    for r in ranks:
        assert r["expert"]
        for a, b in zip(r["history"], history):
            for key in ("training_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], abs=1e-5)
        assert r["test"] == test


def test_split_and_join_towers_carry_the_jax_parameters():
    jarch = jax_registry.build("SwitchBiLSTM", JaxTaggerConfig(**CFG))
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(1)))
    towers, shared = EX.split_towers(params)
    assert towers[0] is params["rnn1"] and towers[1] is params["rnn2"]
    assert set(shared) == {"cls"}
    assert jax.tree.structure(EX.join_towers(towers, shared)) == jax.tree.structure(params)
    dense = registry.build("SwitchBiLSTM", TaggerConfig(**{**CFG, "switch": "dense"}))
    with pytest.raises(ValueError, match="switch='lstm' towers"):
        EX._check(dense, None)
