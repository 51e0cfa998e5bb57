"""The port's pipeline parallelism (parallel/pipeline.py) on gloo ranks on
the CPU against the JAX package's single-device Transformer: GPipe over S
contiguous stages of the encoder layers (2 stages of 1 layer, 4 stages of
1 layer, 2 stages of 2 layers), one microbatch per document, the schedule
written by hand. The loss, its gradients and the pipelined logits to 1e-4;
`Trainer(pipeline_stages=S)` equal to the one-process Trainer (losses
1e-5, parameters 1e-4); `train_fit -pps 2` on two ranks writes the
one-process CLI's results.
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
from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks
from multimodaltopicsegmentation_torch.parallel.pipeline import stage_layers
from multimodaltopicsegmentation_torch.train.loop import Trainer
from synth import make_synthetic_corpus

pytestmark = pytest.mark.torch_distributed

TOL = 1e-4
B, L = 4, 32
LENGTHS = np.array([32, 25, 9, 17], np.int32)


def _cfg(layers):
    return dict(embedding_dim=32, hidden_dim=16, num_layers=layers, nheads=4,
                attention_window=4, loss_fn="FocalLoss")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, 32)).astype(np.float32)
    tags = (rng.random((B, L)) < 0.2).astype(np.float32)
    tags[np.arange(L)[None, :] >= LENGTHS[:, None]] = -1.0
    return x, tags


@pytest.fixture(scope="module", params=[(2, 2), (4, 4), (2, 4)], ids=lambda p: f"S{p[0]}-L{p[1]}")
def piped(request, tmp_path_factory):
    n, layers = request.param
    jarch = jax_registry.build("Transformer", JaxTaggerConfig(**_cfg(layers)))
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(0)))
    x, tags = _inputs(0)
    fx, ftags = _inputs(1)
    fit_batch = {"src_tokens": fx, "tgt_tokens": ftags, "src_lengths": LENGTHS, "n_real": B}
    out = str(tmp_path_factory.mktemp(f"pipe{n}_{layers}"))
    spawn_ranks(W.pipeline_case, n, (out, _cfg(layers), params, x, LENGTHS, tags, B, fit_batch),
                "cpu", timeout=300, store_dir=out)
    return layers, jarch, params, x, tags, fit_batch, W.load(out, n)


def test_pipelined_loss_gradients_and_logits_match_jax(piped):
    layers, jarch, params, x, tags, _, ranks = piped
    xs, ls, ts = jnp.asarray(x), jnp.asarray(LENGTHS), jnp.asarray(tags)
    want_loss, want_grads = jax.value_and_grad(lambda p: jarch.loss(p, xs, ls, ts))(params)
    want_logits = np.asarray(jarch.scores(params, xs, ls))
    port = registry.build("Transformer", TaggerConfig(**_cfg(layers)))
    want_grads = registry.grads_from_jax(port, jax.tree.map(np.asarray, want_grads))
    valid = np.arange(L)[None, :] < LENGTHS[:, None]
    for r in ranks:  # the stages' gradients, summed: every parameter's, on every rank
        assert r["loss"] == pytest.approx(float(want_loss), abs=TOL)
        assert set(r["grads"]) == set(want_grads)
        for name, g in want_grads.items():
            np.testing.assert_allclose(r["grads"][name], g.numpy(), atol=TOL, rtol=0,
                                       err_msg=name)
        np.testing.assert_allclose(r["logits"][valid], want_logits[valid], atol=TOL, rtol=0)


def test_pipelined_trainer_equals_one_process(piped, tmp_path):
    layers, _, _, _, _, fit_batch, ranks = piped
    trainer = Trainer("Transformer", TaggerConfig(**_cfg(layers)), lr=1e-3, max_epochs=3,
                      check_dir=str(tmp_path), seed=0, device="cpu")
    _, history = trainer.fit([fit_batch], [fit_batch])
    for r in ranks:
        for a, b in zip(r["history"], history):
            for key in ("training_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], abs=1e-5)
        for g, w in zip(jax.tree.leaves(r["params"]), jax.tree.leaves(trainer.params)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_stage_layers():
    assert [list(stage_layers(4, 2, s)) for s in range(2)] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="do not split over 3 stages"):
        stage_layers(4, 3, 0)


def test_train_cli_pipeline_stages_writes_the_one_process_results(tmp_path):
    from multimodaltopicsegmentation_torch.cli import train_fit
    from multimodaltopicsegmentation_torch.train import checkpoints as ckpt

    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=6, dim=30)
    argv = ["-arc", "Transformer", "-enc", "CNN", "-ef", emb_dir, "-lf", lab_file, "-split",
            split, "-nl", "2", "-nh", "2", "-window", "4", "-hu", "16", "-bs", "3", "-max", "2",
            "-lr", "1e-3", "-loss", "FocalLoss", "--device", "cpu"]
    spawn_ranks(W.run_cli, 2, ("multimodaltopicsegmentation_torch.cli.train_fit",
                               argv + ["-exp", str(tmp_path / "piped"), "-pps", "2"],
                               str(tmp_path)), "cpu", timeout=300, store_dir=str(tmp_path))
    cwd = os.getcwd()
    try:
        train_fit.cli_main(argv + ["-exp", str(tmp_path / "one")])
    finally:
        os.chdir(cwd)
    texts = [[ln for ln in open(tmp_path / e / "results.txt").read().splitlines()
              if not ln.startswith("Results for experiment")] for e in ("piped", "one")]
    assert texts[0] == texts[1]
    got, want = (ckpt.load(str(tmp_path / e / "checkpoints" / "best_model"))[0]
                 for e in ("piped", "one"))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card_match_one_rank(tmp_path):
    """Two stages of one layer sharing the card (gloo) against the one-rank
    tagger and Trainer on it: the loss, its gradients and the pipelined
    logits to 1e-4, each stage's flash launches (its layer over 4
    microbatches in the loss and again in the logits: 8 K2, 4 K4, 4 K3),
    and `Trainer(pipeline_stages=2)`'s history (1e-5) and parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _cfg(2)
    port = registry.build("Transformer", TaggerConfig(**cfg), torch.Generator().manual_seed(0))
    x, tags = _inputs(0)
    fx, ftags = _inputs(1)
    fit_batch = {"src_tokens": fx, "tgt_tokens": ftags, "src_lengths": LENGTHS, "n_real": B}
    out = str(tmp_path / "ranks")
    os.makedirs(out)
    W.spawn_on_one_card(W.pipeline_case, 2, (out, cfg, port.to_jax_params(), x, LENGTHS, tags,
                                             B, fit_batch), out)
    dev = torch.device("cuda")
    model = port.to(dev)
    xs, ls, ts = (torch.as_tensor(a).to(dev) for a in (x, LENGTHS, tags))
    logits = model.scores(xs, ls).detach().cpu().numpy()
    loss = model.loss(xs, ls, ts)
    loss.backward()
    trainer = Trainer("Transformer", TaggerConfig(**cfg), lr=1e-3, max_epochs=3,
                      check_dir=str(tmp_path / "one"), seed=0, device="cuda")
    _, history = trainer.fit([fit_batch], [fit_batch])
    valid = np.arange(L)[None, :] < LENGTHS[:, None]
    for r in W.load(out, 2):
        assert r["loss"] == pytest.approx(loss.item(), abs=TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][name], p.grad.cpu().numpy(), atol=TOL, rtol=0,
                                       err_msg=name)
        np.testing.assert_allclose(r["logits"][valid], logits[valid], atol=TOL, rtol=0)
        assert r["launches"] == (8, 4, 0, 4)
        for a, b in zip(r["history"], history):
            for key in ("training_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], abs=1e-5)
        for g, w in zip(jax.tree.leaves(r["params"]), jax.tree.leaves(trainer.params)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_train_cli_pipeline_stages_under_torchrun_writes_the_one_process_results(tmp_path):
    """`train_fit -pps 2` under torchrun, two stages sharing the card (each
    joins by env://, backend gloo), against the one-process CLI on the card:
    the same results.txt and a best checkpoint within 1e-4."""
    from multimodaltopicsegmentation_torch.cli import train_fit
    from multimodaltopicsegmentation_torch.train import checkpoints as ckpt

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # ecapa's 192 dims: 2 heads of 96, a head dim the flash kernel takes
    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=6, dim=192)
    argv = ["-arc", "Transformer", "-enc", "ecapa", "-ef", emb_dir, "-lf", lab_file, "-split",
            split, "-nl", "2", "-nh", "2", "-window", "4", "-hu", "16", "-bs", "3", "-max", "2",
            "-lr", "1e-3", "-loss", "FocalLoss", "--device", "cuda"]
    out = W.torchrun_on_one_card("multimodaltopicsegmentation_torch.cli.train_fit",
                                 argv + ["-exp", str(tmp_path / "piped"), "-pps", "2"])
    assert out.count("backend gloo") == 2
    cwd = os.getcwd()
    try:
        train_fit.cli_main(argv + ["-exp", str(tmp_path / "one")])
    finally:
        os.chdir(cwd)
    texts = [[ln for ln in open(tmp_path / e / "results.txt").read().splitlines()
              if not ln.startswith("Results for experiment")] for e in ("piped", "one")]
    assert texts[0] == texts[1]
    got, want = (ckpt.load(str(tmp_path / e / "checkpoints" / "best_model"))[0]
                 for e in ("piped", "one"))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
