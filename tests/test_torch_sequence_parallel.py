"""The port's sequence parallelism (parallel/sequence.py) on 2 and 4 gloo
ranks on the CPU against the JAX package's single-device Transformer: each
rank holds L/n units and exchanges a halo of window/2 per layer along a
line of ranks.

The flash route is forced in the ranks (the plain versions of K2/K4/K3,
which read the mask as a prefix length, as the kernels do), so that a halo
mask that is no prefix would show; ragged lengths include a document that
ends inside shard 0, before the next shard's start. Logits on valid units,
the loss and its gradients to 1e-4; `Trainer(sequence_shards=n)` equal to
the one-process Trainer (1e-5), and `train_fit -sqs 2` on two ranks writes
the one-process CLI's results.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_workers as W
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.ops import attention as TA
from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks
from multimodaltopicsegmentation_torch.train.loop import Trainer
from synth import make_synthetic_corpus

pytestmark = pytest.mark.torch_distributed

TOL = 1e-4
CFG = dict(embedding_dim=32, hidden_dim=16, num_layers=2, nheads=4, attention_window=8,
           loss_fn="FocalLoss")  # pyramidal windows 16, 8: halos of 8, then 4
B, L = 4, 64
LENGTHS = np.array([64, 20, 41, 3], np.int32)  # 20 and 3 end inside shard 0


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, CFG["embedding_dim"])).astype(np.float32)
    tags = (rng.random((B, L)) < 0.2).astype(np.float32)
    tags[np.arange(L)[None, :] >= LENGTHS[:, None]] = -1.0
    return x, tags


@pytest.fixture(scope="module", params=[2, 4])
def sharded(request, tmp_path_factory):
    n = request.param
    jarch = jax_registry.build("Transformer", JaxTaggerConfig(**CFG))
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(0)))
    x, tags = _inputs()
    fit_x, fit_tags = _inputs(1)
    fit_batch = {"src_tokens": fit_x[:, :61], "tgt_tokens": fit_tags[:, :61],
                 "src_lengths": np.minimum(LENGTHS, 61), "n_real": B}  # the Trainer pads 61
    out = str(tmp_path_factory.mktemp(f"seq{n}"))
    spawn_ranks(W.sequence_case, n, (out, CFG, params, x, LENGTHS, tags, True, fit_batch),
                "cpu", timeout=300, store_dir=out)
    return n, jarch, params, x, tags, fit_batch, W.load(out, n)


def test_sharded_logits_loss_and_gradients_match_jax(sharded):
    n, jarch, params, x, tags, _, ranks = sharded
    xs, ls, ts = jnp.asarray(x), jnp.asarray(LENGTHS), jnp.asarray(tags)
    want_logits = np.asarray(jarch.scores(params, xs, ls))
    want_loss, want_grads = jax.value_and_grad(lambda p: jarch.loss(p, xs, ls, ts))(params)
    port = registry.build("Transformer", TaggerConfig(**CFG))
    want_grads = registry.grads_from_jax(port, jax.tree.map(np.asarray, want_grads))
    valid = np.arange(L)[None, :] < LENGTHS[:, None]
    for r in ranks:  # every rank holds the gathered logits and the summed gradients
        np.testing.assert_allclose(r["logits"][valid], want_logits[valid], atol=TOL, rtol=0)
        assert r["loss"] == pytest.approx(float(want_loss), abs=TOL)
        assert set(r["grads"]) == set(want_grads)
        for name, g in want_grads.items():
            np.testing.assert_allclose(r["grads"][name], g.numpy(), atol=TOL, rtol=0,
                                       err_msg=name)
    # gloo takes CPU tensors as they are: only CUDA tensors are staged through the host
    assert ranks[0]["halo_bytes"] == 0


def test_sequence_sharded_trainer_equals_one_process(sharded, tmp_path, monkeypatch):
    n, _, _, _, _, fit_batch, ranks = sharded
    monkeypatch.setattr(TA, "flash_attention_active", lambda where: True)
    trainer = Trainer("Transformer", TaggerConfig(**CFG), lr=1e-3, max_epochs=3,
                      check_dir=str(tmp_path), seed=0, device="cpu")
    _, history = trainer.fit([fit_batch], [fit_batch])
    test, _, scores = trainer.test(trainer.params, [fit_batch])
    for r in ranks:
        for a, b in zip(r["history"], history):
            assert a["epoch"] == b["epoch"]
            for key in ("training_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], abs=1e-5)
        assert r["test"] == test
        for a, b in zip(r["scores"], scores):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_train_cli_sequence_shards_writes_the_one_process_results(tmp_path, monkeypatch):
    """`train_fit -sqs 2` on two ranks and on one process (no shards): the
    same results.txt and a best checkpoint within 1e-4."""
    from multimodaltopicsegmentation_torch.cli import train_fit
    from multimodaltopicsegmentation_torch.train import checkpoints as ckpt

    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=6, dim=30)
    argv = ["-arc", "Transformer", "-enc", "CNN", "-ef", emb_dir, "-lf", lab_file, "-split",
            split, "-nl", "2", "-nh", "2", "-window", "4", "-hu", "16", "-bs", "3", "-max", "2",
            "-lr", "1e-3", "-loss", "FocalLoss", "--device", "cpu"]
    spawn_ranks(W.run_cli, 2, ("multimodaltopicsegmentation_torch.cli.train_fit",
                               argv + ["-exp", str(tmp_path / "sharded"), "-sqs", "2"],
                               str(tmp_path)), "cpu", timeout=300, store_dir=str(tmp_path))
    cwd = os.getcwd()
    try:
        train_fit.cli_main(argv + ["-exp", str(tmp_path / "one")])
    finally:
        os.chdir(cwd)
    texts = [[ln for ln in open(tmp_path / e / "results.txt").read().splitlines()
              if not ln.startswith("Results for experiment")] for e in ("sharded", "one")]
    assert texts[0] == texts[1] and any(ln.startswith("Mean Pk obtained is") for ln in texts[0])
    got, want = (ckpt.load(str(tmp_path / e / "checkpoints" / "best_model"))[0]
                 for e in ("sharded", "one"))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_halo_checks():
    from multimodaltopicsegmentation_torch.parallel import sequence as SQ

    with pytest.raises(ValueError, match="halo"):
        SQ.halo_exchange(torch.zeros(1, 1, 4, 2), 5, None)
    seg = registry.build("Transformer", TaggerConfig(**CFG))
    with pytest.raises(ValueError, match="widest window 16 exceeds shard length 4"):
        SQ._check(seg, 8, 2)
    with pytest.raises(ValueError, match="do not split"):
        SQ._check(seg, 9, 2)
    # prefix masks of the extended windows
    m = SQ._extended_mask(torch.tensor([64, 20, 0]), 32, 8, 40, torch.float32)
    assert m.sum(1).tolist() == [40, 0, 0]
    m = SQ._extended_mask(torch.tensor([64, 20]), 0, 0, 40, torch.float32)
    assert m.sum(1).tolist() == [40, 20]
