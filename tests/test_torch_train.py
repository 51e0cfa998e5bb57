"""The port's training path against the JAX package on the CPU: the same
numpy-seeded batches and the same weights (carried over with
`from_jax_params`, gradients with `registry.grads_from_jax`) through both,
TF32 off, dropout 0 (the two frameworks cannot draw the same masks).

- tagger `loss` values and parameter gradients, 1e-4 (float32 summation
  order through two layers and the recurrences), on ragged lengths with a
  zero-length row, through the blocked attention path and through the flash
  entries' plain versions;
- rematerialisation: a checkpointed layer that drops gives the gradients of
  the unchecked one, and the policy keeps remat on off the card;
- 20-step trajectories of BiLSTM + focal + Adam and of Transformer + SGD +
  clipping against the JAX Trainer's step: losses and final parameters 1e-4;
- `PlateauScheduler`, early stop and the snapshot's file name, decision for
  decision, on a scripted loss sequence;
- `Trainer.test` / `search_threshold` / `predict` on a shared checkpoint,
  `eval/metrics` on random segmentations, `train/data` array for array;
- the train CLI end to end on the synthetic corpus with `--device cpu`, its
  checkpoint served by both predict CLIs;
- the tagger zoo: both train CLIs from the same first weights on
  `-arc biLSTMCRF` and on late fusion (`-enc2 -ef2`) write the same
  results.txt metrics, each predict CLI serves both checkpoints alike, and
  `test` / `search_threshold` / `predict` agree for the CRFs, SwitchBiLSTM,
  late fusion and SheikhBiLSTM.
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.eval import metrics as JM
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_tpu.train import data as JD
from multimodaltopicsegmentation_tpu.train import loop as JLoop
from multimodaltopicsegmentation_torch.eval import metrics as TM
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models import transformers as TT
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.ops import attention as TA
from multimodaltopicsegmentation_torch.train import checkpoints as ckpt
from multimodaltopicsegmentation_torch.train import data as TD
from multimodaltopicsegmentation_torch.train import loop as TLoop
from synth import make_synthetic_corpus  # tests/synth.py: pytest puts this file's directory on sys.path

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4


def _cfgs(**kw):
    base = dict(embedding_dim=16, hidden_dim=16, num_layers=2, nheads=4, attention_window=4,
                loss_fn="FocalLoss")
    base.update(kw)
    return JaxTaggerConfig(**base), TaggerConfig(**base)


def _batch(seed=0, B=4, L=21, D=16, lengths=(21, 13, 0, 6), boundary_p=0.2):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths[:B], np.int32)
    tags = (rng.random((B, L)) < boundary_p).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    return {"src_tokens": rng.standard_normal((B, L, D)).astype(np.float32),
            "tgt_tokens": tags, "src_lengths": lengths, "n_real": B}


def _jax_params(arch, seed=0):
    return jax.tree.map(np.asarray, arch.init(jax.random.PRNGKey(seed)))


def _port(architecture, cfg, params):
    port = registry.build(architecture, cfg)
    port.load_state_dict(type(port).from_jax_params(params))
    return port


def _compare_loss_and_grads(architecture, jcfg, cfg, batch, jarch=None, atol=ATOL):
    jarch = jarch or jax_registry.build(architecture, jcfg)
    params = _jax_params(jarch)
    x, lengths, tags = (jnp.asarray(batch[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens"))
    want, want_grads = jax.value_and_grad(
        lambda p: jarch.loss(p, x, lengths, tags, rng=None))(params)
    port = _port(architecture, cfg, params)
    got = port.loss(*(torch.from_numpy(batch[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens")))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=atol)
    carried = registry.grads_from_jax(port, jax.tree.map(np.asarray, want_grads))
    assert list(carried) == [n for n, _ in port.named_parameters()]
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), carried[name].numpy(), atol=atol, err_msg=name)


@pytest.mark.parametrize("loss_fn", ["FocalLoss", "BinaryCrossEntropy", "CrossEntropy"])
def test_bilstm_loss_and_gradients_match_jax(loss_fn):
    jcfg, cfg = _cfgs(loss_fn=loss_fn)
    _compare_loss_and_grads("BiLSTM", jcfg, cfg, _batch())


@pytest.mark.parametrize("architecture,window", [
    ("Transformer", 4), ("Transformer", 0), ("Transformer", 16),
    ("RecurrentLongT5", 4), ("RecurrentLongT5", 8),
    ("RecurrentLongformer", 4), ("BiLSTMRestrictedMHA", 8)])
def test_transformer_tagger_loss_and_gradients_match_jax(architecture, window):
    """window 0 is the port's encoding of the dense Transformer (JAX:
    `TransformerSegmenter(cfg, restricted=False)`)."""
    jcfg, cfg = _cfgs(attention_window=window)
    jarch = None
    if window == 0:
        from multimodaltopicsegmentation_tpu.models.transformers import TransformerSegmenter

        jarch = TransformerSegmenter(dataclasses.replace(jcfg, attention_window=4), restricted=False)
    _compare_loss_and_grads(architecture, jcfg, cfg, _batch(), jarch)


@pytest.mark.parametrize("architecture", ["Transformer", "RecurrentLongT5", "RecurrentLongformer"])
def test_tagger_gradients_through_the_flash_entries_match_jax(architecture, monkeypatch):
    """With the dispatch switched to the flash route (on the CPU: the plain
    versions of K2 and of K4, K5, K3 behind the autograd entries) the taggers'
    gradients still equal JAX's: a length-masked loss sends no cotangent that
    the zero gradient of padded query rows would change."""
    monkeypatch.setattr(TA, "flash_attention_active", lambda where: True)
    jcfg, cfg = _cfgs(attention_window=8)
    _compare_loss_and_grads(architecture, jcfg, cfg, _batch())


# -- dropout and rematerialisation ---------------------------------------------


@pytest.mark.parametrize("architecture", ["Transformer", "RecurrentLongT5"])
@pytest.mark.parametrize("flash", [False, True])
def test_checkpointed_dropped_layer_gives_the_unchecked_gradients(architecture, flash, monkeypatch):
    if flash:
        monkeypatch.setattr(TA, "flash_attention_active", lambda where: True)
    _, cfg = _cfgs(attention_window=8, dropout_in=0.3, dropout_out=0.2)
    batch = _batch(seed=1)
    args = [torch.from_numpy(batch[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens")]
    results = []
    for remat in (False, True):
        port = registry.build(architecture, cfg, torch.Generator().manual_seed(0))
        for m in port.modules():
            if isinstance(m, (TT.BertStyleEncoder, TT.LongT5Encoder)):
                m.remat = remat
        g = torch.Generator().manual_seed(5)
        loss = port.loss(*args, generator=g)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in port.parameters()], g.get_state()))
        flags = [m.last_remat for m in port.modules()
                 if isinstance(m, (TT.BertStyleEncoder, TT.LongT5Encoder))]
        assert flags and all(f is remat for f in flags)
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == l1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    # the recomputation leaves the generator where the forward left it
    assert torch.equal(s0, s1)
    # and dropout did act: the loss differs from the loss without a generator
    port = registry.build(architecture, cfg, torch.Generator().manual_seed(0))
    assert abs(port.loss(*args).item() - l0) > 1e-6


def test_validation_runs_without_dropout():
    _, cfg = _cfgs(dropout_in=0.5, dropout_out=0.5)
    batch = _batch(seed=2)
    args = [torch.from_numpy(batch[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens")]
    for architecture in ("BiLSTM", "Transformer", "RecurrentLongT5", "RecurrentLongformer"):
        port = registry.build(architecture, cfg, torch.Generator().manual_seed(0))
        clean = port.loss(*args).item()
        assert port.loss(*args).item() == clean  # no generator: deterministic
        g = torch.Generator().manual_seed(1)
        assert port.loss(*args, generator=g).item() != clean
        with torch.no_grad():
            logits, _ = port.decode(args[0], args[1], 0.5)
            torch.testing.assert_close(logits, port.scores(args[0], args[1]), atol=0, rtol=0)


def test_dense_transformer_and_noffn_block_drop_at_the_hf_default():
    """dropout flags 0, and still the dense Transformer and the bare
    local-MHA block drop their attention weights at 0.1 in training."""
    _, cfg = _cfgs(attention_window=0)
    batch = _batch(seed=3)
    args = [torch.from_numpy(batch[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens")]
    dense = registry.build("Transformer", cfg, torch.Generator().manual_seed(0))
    assert dense.model.model.attn_drop == 0.1 and dense.model.model.windows is None
    assert dense.loss(*args, generator=torch.Generator().manual_seed(1)).item() != \
        dense.loss(*args).item()
    _, cfg = _cfgs(attention_window=4)
    hybrid = registry.build("RecurrentLongformer", cfg, torch.Generator().manual_seed(0))
    assert hybrid.loss(*args, generator=torch.Generator().manual_seed(1)).item() != \
        hybrid.loss(*args).item()
    restricted = registry.build("Transformer", cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    assert restricted.loss(*args, generator=g).item() == restricted.loss(*args).item()
    assert torch.equal(g.get_state(), state)  # all rates 0: nothing drawn


def test_auto_remat_policy_off_the_card():
    """Off the card the blocked path stores banded scores: remat stays on,
    unless forced; nothing is checkpointed outside training."""
    assert TT._auto_remat("cpu", 10, 3600, 768, 256, 8, [240, 120]) is True
    _, cfg = _cfgs()
    batch = _batch()
    args = [torch.from_numpy(batch[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens")]
    port = registry.build("Transformer", cfg, torch.Generator().manual_seed(0))
    port.loss(*args).backward()
    assert port.model.model.last_remat is True
    with torch.no_grad():
        port.loss(*args)
    assert port.model.model.last_remat is False
    port.scores(args[0], args[1])
    assert port.model.model.last_remat is False
    port.model.model.remat = False  # the encoder's override
    port.loss(*args)
    assert port.model.model.last_remat is False


@pytest.mark.cuda
@pytest.mark.parametrize("architecture", ["Transformer", "RecurrentLongT5", "RecurrentLongformer"])
def test_cuda_checkpointed_dropped_layers_match_and_launch_once_more(architecture):
    """On the card: with dropout on, a rematerialised run gives the unchecked
    run's loss and gradients (the 0/1 tiles are drawn again from the
    generator's state), and launches the forward kernel once more per
    checkpointed flash layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    _, cfg = _cfgs(embedding_dim=64, hidden_dim=32, attention_window=16, dropout_in=0.2,
                   dropout_out=0.1)
    batch = _batch(seed=4, B=4, L=150, D=64, lengths=(150, 90, 0, 33))
    args = [torch.from_numpy(batch[k]).cuda() for k in ("src_tokens", "src_lengths", "tgt_tokens")]
    results = []
    for remat in (False, True):
        port = registry.build(architecture, cfg, torch.Generator().manual_seed(0)).cuda()
        encoders = [m for m in port.modules()
                    if isinstance(m, (TT.BertStyleEncoder, TT.LongT5Encoder))]
        for m in encoders:
            m.remat = remat
        FA._flash_fwd.launches = FA._flash_dkv.launches = 0
        loss = port.loss(*args, generator=torch.Generator(device="cuda").manual_seed(5))
        loss.backward()
        torch.cuda.synchronize()
        results.append((loss.item(), [p.grad.clone() for p in port.parameters()],
                        FA._flash_fwd.launches, FA._flash_dkv.launches))
    (l0, g0, fwd0, dkv0), (l1, g1, fwd1, dkv1) = results
    assert l0 == l1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    checkpointed = 2 if encoders else 0  # the bare local-MHA blocks are never checkpointed
    assert (fwd0, dkv0, dkv1) == (2, 2, 2) and fwd1 == 2 + checkpointed


# -- optimizer and trajectories ------------------------------------------------------


def test_clip_by_global_norm_equals_optax():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = TLoop.clip_by_global_norm_(params, max_norm)
        np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in grads)),
                                   rtol=1e-6)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), atol=1e-7)


def _trajectory(architecture, optimizer, clip, lr, tmp_path, steps=20, **cfg_kw):
    jcfg, cfg = _cfgs(**cfg_kw)
    batches = [_batch(seed=s, lengths=(21, 13, 9, 6)) for s in (0, 1)]
    jt = JLoop.Trainer(architecture, jcfg, lr=lr, optimizer=optimizer, gradient_clipping=clip,
                       check_dir=str(tmp_path / "j"))
    params = _jax_params(jt.arch, seed=1)
    jt.tx = JLoop.make_optimizer(optimizer, lr, clip)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = jt.tx.init(jparams)
    step = jt._train_step()
    want = []
    for i in range(steps):
        b = batches[i % 2]
        jparams, opt_state, loss = step(jparams, opt_state, jnp.asarray(b["src_tokens"]),
                                        jnp.asarray(b["src_lengths"]), jnp.asarray(b["tgt_tokens"]),
                                        None, {})
        want.append(float(loss))

    tt = TLoop.Trainer(architecture, cfg, lr=lr, optimizer=optimizer, gradient_clipping=clip,
                       check_dir=str(tmp_path / "t"), device="cpu")
    tt._setup(params)
    dev_batches = TLoop.batches_to_device(batches, "cpu")
    got = [tt._train_step(dev_batches[i % 2]).item() for i in range(steps)]
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[-1] < got[0]
    final = tt.tagger.to_jax_params()
    flat_w, tree_w = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    flat_g, tree_g = jax.tree.flatten(final)
    assert tree_w == tree_g
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_bilstm_focal_adam_trajectory_matches_jax(tmp_path):
    """The paper's replication config at a small width: 20 Adam(eps 1e-7) steps."""
    _trajectory("BiLSTM", "Adam", 0.0, 1e-3, tmp_path)


def test_transformer_sgd_clipping_trajectory_matches_jax(tmp_path):
    """20 steps of SGD(momentum .9, weight decay 1e-4) under a clip that bites."""
    _trajectory("Transformer", "SGD", 0.05, 1e-2, tmp_path)


# -- the epoch loop's decisions ---------------------------------------------------------


def _scripted(values):
    it = iter(values)
    return lambda: next(it)


def test_fit_decisions_match_jax_on_a_scripted_loss_sequence(tmp_path, monkeypatch):
    """Plateau LR, early stop and the snapshot's name decide on the monitored
    loss alone: feed both loops one scripted sequence of validation losses
    (three improvements, a NaN, then a plateau long enough to cut the rate
    and to stop) and compare history, rates, stopping epoch and file name."""
    val = [0.9, 0.5, 0.30004, float("nan")] + [0.30003] * 12 + [0.2] + [0.25] * 20
    jcfg, cfg = _cfgs(num_layers=1)
    batches = [_batch(lengths=(21, 13, 9, 6))]

    jt = JLoop.Trainer("BiLSTM", jcfg, lr=1e-2, max_epochs=40, patience=14,
                       check_dir=str(tmp_path / "j"))
    j_val, j_lrs = _scripted(val), []
    monkeypatch.setattr(jt, "_train_step", lambda params=None: (
        lambda p, o, *a: (p, o, jnp.asarray(1.0, jnp.float32))))
    monkeypatch.setattr(jt, "_eval_loss", lambda: (lambda *a: jnp.asarray(j_val(), jnp.float32)))
    set_lr = JLoop._set_lr
    monkeypatch.setattr(JLoop, "_set_lr", lambda s, lr: (j_lrs.append(lr), set_lr(s, lr))[1])
    _, j_hist = jt.fit(batches, batches)

    tt = TLoop.Trainer("BiLSTM", cfg, lr=1e-2, max_epochs=40, patience=14,
                       check_dir=str(tmp_path / "t"), device="cpu")
    t_val, t_lrs = _scripted(val), []
    monkeypatch.setattr(tt, "_train_step", lambda batch: torch.tensor(1.0))
    monkeypatch.setattr(tt, "_eval_loss", lambda batch: torch.tensor(t_val()))
    set_lr_t = tt._set_lr
    monkeypatch.setattr(tt, "_set_lr", lambda lr: (t_lrs.append(lr), set_lr_t(lr))[1])
    _, t_hist = tt.fit(batches, batches)

    assert len(t_hist) == len(j_hist) and len(t_hist) < 40  # stopped early, at the same epoch
    for a, b in zip(t_hist, j_hist):
        assert a["epoch"] == b["epoch"] and a["training_loss"] == b["training_loss"]
        assert (np.isnan(a["val_loss"]) and np.isnan(b["val_loss"])) or \
            a["val_loss"] == pytest.approx(b["val_loss"], abs=1e-7)
    assert t_lrs == pytest.approx(j_lrs) and min(t_lrs) < 1e-2  # the rate was cut
    assert os.path.basename(tt.best_model_path) == os.path.basename(jt.best_model_path)
    assert os.path.exists(tt.best_model_path)
    assert tt.opt.param_groups[0]["lr"] == pytest.approx(t_lrs[-1])
    _, _, arch, extra = ckpt.load(tt.best_model_path)
    _, _, jarch, jextra = jax_ckpt.load(jt.best_model_path)
    assert arch == jarch == "BiLSTM" and extra["epoch"] == jextra["epoch"] == 16


def test_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(0)
    values = np.abs(rng.standard_normal(80)).tolist() + [float("inf")] * 15
    a, b = TLoop.PlateauScheduler(0.01), JLoop.PlateauScheduler(0.01)
    assert [a.step(v) for v in values] == [b.step(v) for v in values]


def test_fit_snapshot_survives_the_non_finite_tripwire(tmp_path, monkeypatch):
    _, cfg = _cfgs(num_layers=1)
    batches = [_batch(lengths=(21, 13, 9, 6))]
    tt = TLoop.Trainer("BiLSTM", cfg, max_epochs=5, monitor="training_loss",
                       check_dir=str(tmp_path / "ck"), device="cpu")
    losses = _scripted([0.7, 0.6, float("nan")])
    monkeypatch.setattr(tt, "_train_step", lambda batch: torch.tensor(losses()))
    with pytest.raises(FloatingPointError, match="non-finite training loss nan at epoch 2"):
        tt.fit(batches)
    assert os.path.basename(tt.best_model_path) == \
        "checkpoint-epoch=01-val_loss=0.6000-threshold=0.50.ckpt"
    assert os.path.exists(tt.best_model_path)
    # with the tripwire off the loop trains through it
    tt = TLoop.Trainer("BiLSTM", cfg, max_epochs=3, monitor="training_loss",
                       check_dir=str(tmp_path / "ck2"), device="cpu", detect_anomaly=False)
    losses = _scripted([0.7, float("nan"), 0.5])
    monkeypatch.setattr(tt, "_train_step", lambda batch: torch.tensor(losses()))
    _, hist = tt.fit(batches)
    assert len(hist) == 3 and tt.best_model_path.endswith("epoch=02-val_loss=0.5000-threshold=0.50.ckpt")


def test_trainer_refuses_what_is_not_ported_and_a_missing_card(tmp_path):
    """Without ranks the parallel modes fail the JAX Trainer's checks, with
    its messages; a "model" mesh axis needs a process group and a rank count
    it divides."""
    from multimodaltopicsegmentation_torch.parallel import mesh as PM

    _, cfg = _cfgs()
    switch = dataclasses.replace(cfg, switch="lstm")
    for arch, c, kw, msg in (
            ("BiLSTM", cfg, dict(pipeline_stages=2), "applies to the Transformer architecture"),
            ("Transformer", cfg, dict(pipeline_stages=3), "does not split over 3 pipeline"),
            ("Transformer", cfg, dict(pipeline_stages=2), "needs that many devices, have 1"),
            ("Transformer", cfg, dict(sequence_shards=2), "needs that many devices, have 1"),
            ("Transformer", dataclasses.replace(cfg, attention_window=0),
             dict(sequence_shards=2), "needs LOCAL attention"),
            ("Transformer", cfg, dict(sequence_shards=2, pipeline_stages=2), "needs that many"),
            ("BiLSTM", cfg, dict(expert_parallel=True), "applies to SwitchBiLSTM"),
            ("SwitchBiLSTM", switch, dict(expert_parallel=True), "needs 2 devices, have 1")):
        with pytest.raises(ValueError, match=msg):
            TLoop.Trainer(arch, c, device="cpu", **kw)
    # alone, SwitchBiLSTM('lstm') trains its dense form
    assert TLoop.Trainer("SwitchBiLSTM", switch, device="cpu").expert_mesh is None
    import torch_dist_workers as W

    W.check_model_axis_refusals(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TLoop.Trainer("BiLSTM", cfg)  # the default device is cuda


def test_fit_trains_with_dropout_and_reinitialises_from_the_seed(tmp_path):
    _, cfg = _cfgs(dropout_in=0.1, dropout_out=0.1, attention_window=8)
    batches = [_batch(seed=s, lengths=(21, 13, 9, 6)) for s in (0, 1)]
    tt = TLoop.Trainer("Transformer", cfg, lr=1e-3, max_epochs=3, check_dir=str(tmp_path / "ck"),
                       device="cpu")
    params, hist = tt.fit(batches, batches[:1])
    assert len(hist) == 3 and all(np.isfinite(h["training_loss"]) for h in hist)
    params2, hist2 = tt.fit(batches, batches[:1])
    assert hist2 == hist  # same seed, same weights, same dropout draws
    saved, scfg, arch, _ = ckpt.load(tt.best_model_path)
    assert arch == "Transformer" and scfg.dropout_in == 0.1


# -- test / search_threshold / predict ---------------------------------------------------------


def _shared_checkpoint(tmp_path, architecture, loss_fn):
    jcfg, cfg = _cfgs(loss_fn=loss_fn, attention_window=8)
    jarch = jax_registry.build(architecture, jcfg)
    params = _jax_params(jarch, seed=2)
    params["cls"]["w"] = params["cls"]["w"] * 20.0  # spread the scores: both tags occur
    path = str(tmp_path / "shared.ckpt")
    jax_ckpt.save(path, params, jcfg, architecture)
    return path, jcfg, cfg


def _eval_batches():
    out = []
    for seed, lengths in ((5, (40, 33, 25)), (6, (40, 12, 31))):
        b = _batch(seed=seed, B=3, L=40, lengths=lengths, boundary_p=0.15)
        b["tgt_tokens"][b["tgt_tokens"] < 0] = -1.0
        out.append(b)
    return out


@pytest.mark.parametrize("metric", ["Pk", "F1", "WD", "b", "scaiano"])
@pytest.mark.parametrize("architecture,loss_fn", [("BiLSTM", "FocalLoss"),
                                                  ("Transformer", "CrossEntropy")])
def test_trainer_test_and_search_threshold_match_jax(tmp_path, metric, architecture, loss_fn):
    path, jcfg, cfg = _shared_checkpoint(tmp_path, architecture, loss_fn)
    batches = _eval_batches()
    jt = JLoop.Trainer(architecture, jcfg, metric=metric, threshold=0.0, use_end_boundary=True)
    tt = TLoop.Trainer(architecture, cfg, metric=metric, threshold=0.0, use_end_boundary=True,
                       device="cpu")
    jparams = jax_ckpt.load(path)[0]
    tparams = ckpt.load(path)[0]
    want, want_docs, want_scores = jt.test(jparams, batches)
    got, got_docs, got_scores = tt.test(tparams, batches)
    assert got["threshold"] == want["threshold"] == 0.5  # the 0.0 -> 0.5 quirk
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert got_docs == want_docs and len(got_docs) == 6
    for a, b in zip(got_scores, want_scores):
        np.testing.assert_allclose(a, b, atol=ATOL)
    assert tt.search_threshold(tparams, batches) == pytest.approx(
        jt.search_threshold(jparams, batches))
    assert tt.predict(tparams, batches, 0.4) == jt.predict(jparams, batches, 0.4)


def test_trainer_test_thresholds_and_zero_baseline(tmp_path):
    path, jcfg, cfg = _shared_checkpoint(tmp_path, "BiLSTM", "FocalLoss")
    params = ckpt.load(path)[0]
    batches = _eval_batches()
    assert TLoop.Trainer("BiLSTM", cfg, device="cpu").test(params, batches)[0]["threshold"] == 0.4
    assert TLoop.Trainer("BiLSTM", cfg, threshold=0.3, device="cpu").test(
        params, batches)[0]["threshold"] == 0.3
    jz = JLoop.Trainer("BiLSTM", jcfg, zero_baseline=True, threshold=0.7)
    tz = TLoop.Trainer("BiLSTM", cfg, zero_baseline=True, threshold=0.7, device="cpu")
    want, got = jz.test(jax_ckpt.load(path)[0], batches), tz.test(params, batches)
    assert got[0] == want[0] and got[1] == want[1] and got[0]["threshold"] == 0.4
    assert all(not s.any() for s in got[2])


def test_metrics_equal_on_random_segmentations():
    rng = np.random.default_rng(0)
    for n in (5, 12, 40, 150):
        for _ in range(6):
            ref = (rng.random(n) < 0.2).astype(int).tolist()
            hyp = (rng.random(n) < 0.25).astype(int).tolist()
            assert TM.compute_Pk(hyp, ref) == JM.compute_Pk(hyp, ref)
            assert TM.boundary_f1(ref, hyp) == JM.boundary_f1(ref, hyp)
            assert TM.win_pr(hyp, ref) == JM.win_pr(hyp, ref)
            assert TM.b_measure(hyp, ref) == JM.b_measure(hyp, ref)
            assert TM.get_boundaries(ref) == JM.get_boundaries(ref)
            try:
                want = JM.compute_window_diff(hyp, ref)
            except AssertionError:
                with pytest.raises(AssertionError):
                    TM.compute_window_diff(hyp, ref)
            else:
                assert TM.compute_window_diff(hyp, ref) == want


def _assert_same_docs(a, b):
    assert len(a) == len(b)
    for (e1, l1, n1), (e2, l2, n2) in zip(a, b):
        np.testing.assert_array_equal(e1, e2)
        assert list(l1) == list(l2) and n1 == n2


@pytest.mark.parametrize("kwargs", [dict(split=True), dict(k_folds=3),
                                    dict(split=True, mask_inner_sentences=True)],
                         ids=["split", "kfold", "masked"])
def test_data_loading_and_batches_equal_the_jax_package(tmp_path, kwargs):
    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path), n_docs=9, dim=12)
    kwargs = dict(kwargs)
    if kwargs.pop("split", False):
        kwargs["split"] = split
    want = JD.load_dataset_from_precomputed(emb_dir, lab_file, **kwargs)
    got = TD.load_dataset_from_precomputed(emb_dir, lab_file, **kwargs)
    assert len(got) == len(want)
    for f_got, f_want in zip(got, want):
        assert len(f_got) == len(f_want)
        for s_got, s_want in zip(f_got, f_want):
            _assert_same_docs(s_got, s_want)
    docs = got[0][0]
    for pad_kwargs in (dict(crf=False), dict(crf=True, truncate=True, truncate_value=50),
                       dict(crf=False, sort_by_length=True), dict(crf=True, domain_adapt=True)):
        b_want = list(JD.batches(want[0][0], 4, **pad_kwargs))
        b_got = list(TD.batches(docs, 4, **pad_kwargs))
        assert len(b_got) == len(b_want)
        for x, y in zip(b_got, b_want):
            assert x.keys() == y.keys() and x["ids"] == y["ids"] and x["n_real"] == y["n_real"]
            for k in ("src_tokens", "tgt_tokens", "src_lengths", "domain"):
                np.testing.assert_array_equal(x[k], y[k])
                assert x[k].dtype == y[k].dtype
    folds = TD.cross_validation_split(list(range(10)), num_folds=5)
    assert folds == JD.cross_validation_split(list(range(10)), num_folds=5)


# -- the CLI end to end --------------------------------------------------------------------------


def _run_train_cli(argv):
    from multimodaltopicsegmentation_torch.cli import train_fit

    cwd = os.getcwd()
    try:
        return train_fit.cli_main(argv)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("architecture,extra", [
    ("BiLSTM", ["-hs", "-huss", "16", "-nlss", "1", "2", "-diss", "0.0", "-doss", "0.1"]),
    ("Transformer", ["-hu", "16", "-nl", "1", "-nh", "2", "-window", "8", "-sth", "-gc", "1.0",
                     "-opt", "SGD"]),
])
def test_train_cli_end_to_end_and_both_predict_clis(tmp_path, monkeypatch, architecture, extra):
    """train_fit on the synthetic corpus with --device cpu: results.txt, logs,
    the JSON artefacts and a checkpoint that both predict CLIs serve with
    identical results.pkl."""
    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict
    from multimodaltopicsegmentation_torch.cli import train_fit
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as torch_predict

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=10, dim=30)
    exp = str(tmp_path / "exp")
    out = _run_train_cli([
        "-exp", exp, "-arc", architecture, "-enc", "CNN", "-ef", emb_dir, "-lf", lab_file,
        "-lr", "1e-2", "-bs", "4", "-max", "4", "-vp", "0.2", "-pat", "3", "-loss", "FocalLoss",
        "-s_last", "-ar", "-as", "-split", split, "--device", "cpu"] + extra)
    lines = out[0] if isinstance(out, tuple) else out
    txt = open(os.path.join(exp, "results.txt")).read()
    for needle in ("Mean Pk obtained is", "Mean F1 obtained is", "Mean WD obtained is",
                   f"Neural architecture: {architecture}", "Sentence encoder: CNN"):
        assert needle in txt
    assert any(line.startswith("Mean Pk obtained is") for line in lines)
    assert "Training started all right" in open(os.path.join(exp, "logs")).read()
    best = os.path.join(exp, "checkpoints", "best_model")
    assert os.path.exists(best)
    with open(os.path.join(exp, "all_scores.json")) as f:
        assert len(json.load(f)) == 1  # one test document
    with open(os.path.join(exp, "all_results.json")) as f:
        assert all("Pk" in v for v in json.load(f).values())
    if "-hs" in extra:
        rows = open(os.path.join(exp, "Pk_fit_results.csv")).read().splitlines()
        assert rows[0] == ",1,2" and len(rows) == 2 and rows[1].startswith("0,")
        assert "Results for model with 16 hidden units, 2 layers" in \
            open(os.path.join(exp, "logs")).read()
    else:
        assert "Threshold search: best=" in open(os.path.join(exp, "logs")).read()

    # the checkpoint is the JAX pickle format: both packages load it
    params, cfg, arch, _ = ckpt.load(best)
    jparams, jcfg, jarch, _ = jax_ckpt.load(best)
    assert arch == jarch == architecture and cfg.embedding_dim == jcfg.embedding_dim == 30
    results = {}
    for name, predict in (("jax", jax_predict), ("torch", torch_predict)):
        out_dir = str(tmp_path / f"pred_{name}")
        predict(["-ef", emb_dir, "-hyp", os.path.join(exp, "results.txt"), "-model", best,
                 "-exp", out_dir, "-rjs"] + (["--device", "cpu"] if name == "torch" else []))
        with open(os.path.join(out_dir, "results.pkl"), "rb") as f:
            results[name] = pickle.load(f)
    assert results["torch"] == results["jax"] and len(results["torch"]) == 10


def test_train_cli_defaults_to_cuda_and_refuses_unported_flags(tmp_path):
    from multimodaltopicsegmentation_torch.cli import train_fit

    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=6, dim=30)
    base = ["-arc", "BiLSTM", "-enc", "CNN", "-ef", emb_dir, "-lf", lab_file, "-split", split]
    assert train_fit.build_parser().parse_args(base).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run_train_cli(base + ["-exp", str(tmp_path / "e0")])
        assert not os.path.exists(tmp_path / "e0")
    # the parallel flags run JAX's up-front checks before the folder exists
    for flags, msg in ((["-pps", "2"], "--pipeline_stages applies to -a Transformer"),
                       (["-sqs", "2"], "--sequence_shards applies to -a Transformer"),
                       (["--expert_parallel", "on"], "--expert_parallel on applies to"),
                       (["-arc", "Transformer", "-pps", "2"], "needs that many devices, have 1"),
                       (["-arc", "Transformer", "-sqs", "2", "-window", "0"],
                        "needs local attention"),
                       (["-de", "-sqs", "2"], "--device_epochs is exclusive")):
        with pytest.raises(SystemExit, match=msg):
            _run_train_cli(base + ["-exp", str(tmp_path / "e1"), "--device", "cpu"] + flags)
    assert not os.path.exists(tmp_path / "e1")
    with pytest.raises(ValueError, match="No architecture named"):
        _run_train_cli(base[2:] + ["-arc", "LateFusion", "-exp", str(tmp_path / "e2"),
                                   "--device", "cpu"])
    assert not os.path.exists(tmp_path / "e2")
    # late fusion, refused until its slice, now trains with its second modality
    emb2 = _second_modality(emb_dir, str(tmp_path / "corpus" / "embeddings2"))
    _run_train_cli(base[2:] + ["-arc", "BiLSTMLateFusion", "-enc2", "CNN", "-ef2", emb2,
                               "-exp", str(tmp_path / "e3"), "-hu", "8", "-max", "2", "-bs", "4",
                               "--device", "cpu"])
    txt = open(os.path.join(tmp_path / "e3", "results.txt")).read()
    assert "Second sentence encoder: CNN" in txt and "Mean Pk obtained is" in txt
    params, cfg, arch, _ = ckpt.load(os.path.join(tmp_path / "e3", "checkpoints", "best_model"))
    assert arch == "BiLSTMLateFusion" and (cfg.embedding_dim, cfg.embedding_dim2) == (30, 30)


def _second_modality(emb_dir, out_dir, seed=7):
    """A second modality for late fusion: the same file names and unit counts
    as `emb_dir`, 30-dim features of their own (`-enc2 CNN`)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir)
    for name in sorted(os.listdir(emb_dir)):
        n = len(np.load(os.path.join(emb_dir, name)))
        np.save(os.path.join(out_dir, name), rng.standard_normal((n, 30)).astype(np.float32))
    return out_dir


def _jax_first_weights(monkeypatch):
    """The port's Trainer starts from the weights the JAX Trainer draws for the
    same seed (its `fit` splits PRNGKey(seed) once), so that both train CLIs
    follow one trajectory."""
    build = TLoop.Trainer._build

    def _build(self):
        build(self)
        fields = {f.name: getattr(self.cfg, f.name) for f in dataclasses.fields(self.cfg)
                  if f.name != "dtype"}
        jarch = jax_registry.build(self.arch_name, JaxTaggerConfig(**fields))
        k_init = jax.random.split(jax.random.PRNGKey(self.seed))[1]
        params = jax.tree.map(np.asarray, jarch.init(k_init))
        self.tagger.load_state_dict(type(self.tagger).from_jax_params(params))

    monkeypatch.setattr(TLoop.Trainer, "_build", _build)


@pytest.mark.parametrize("architecture", ["biLSTMCRF", "BiLSTMLateFusion"])
def test_both_train_clis_agree_and_serve_each_others_checkpoints(tmp_path, monkeypatch,
                                                                 architecture):
    """Both packages' train CLIs on the synthetic corpus from the same first
    weights write the same results.txt metrics; each package's predict CLI
    serves both checkpoints with identical results.pkl."""
    from multimodaltopicsegmentation_tpu.cli import predict as jax_predict
    from multimodaltopicsegmentation_tpu.cli import train_fit as jax_train_fit
    from multimodaltopicsegmentation_torch.cli import predict as torch_predict

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    _jax_first_weights(monkeypatch)
    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=10, dim=30)
    extra, extra_predict = [], []
    if architecture == "BiLSTMLateFusion":
        emb2 = _second_modality(emb_dir, str(tmp_path / "corpus" / "embeddings2"))
        extra, extra_predict = ["-enc2", "CNN", "-ef2", emb2], ["-ef2", emb2]
    argv = ["-arc", architecture, "-enc", "CNN", "-ef", emb_dir, "-lf", lab_file, "-lr", "1e-2",
            "-hu", "8", "-nl", "1", "-bs", "4", "-max", "3", "-pat", "3", "-split", split,
            "-ar", "-as"] + extra
    exps = {"jax": str(tmp_path / "exp_jax"), "torch": str(tmp_path / "exp_torch")}
    cwd = os.getcwd()
    try:
        jax_train_fit.cli_main(argv + ["-exp", exps["jax"]])
    finally:
        os.chdir(cwd)
    _run_train_cli(argv + ["-exp", exps["torch"], "--device", "cpu"])

    texts = {}
    for name, exp in exps.items():
        lines = open(os.path.join(exp, "results.txt")).read().split("\n")
        texts[name] = [ln for ln in lines if ln and not ln.startswith("Results for experiment")]
    assert texts["torch"] == texts["jax"]
    assert any(ln.startswith("Mean Pk obtained is") for ln in texts["torch"])
    assert ("Second sentence encoder: CNN" in texts["torch"]) == (architecture == "BiLSTMLateFusion")
    with open(os.path.join(exps["jax"], "all_scores.json")) as f, \
            open(os.path.join(exps["torch"], "all_scores.json")) as g:
        want, got = json.load(f), json.load(g)
    assert want.keys() == got.keys()
    for k in want:
        # a Viterbi score sums over a document's units: relative 1e-5 after training
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=1e-5)

    results = {}
    for trained, exp in exps.items():
        for served_by, predict in (("jax", jax_predict.cli_main), ("torch", torch_predict.cli_main)):
            out = str(tmp_path / f"pred_{trained}_{served_by}")
            predict(["-ef", emb_dir, "-hyp", os.path.join(exp, "results.txt"), "-model",
                     os.path.join(exp, "checkpoints", "best_model"), "-exp", out, "-rjs"]
                    + extra_predict + (["--device", "cpu"] if served_by == "torch" else []))
            with open(os.path.join(out, "results.pkl"), "rb") as f:
                results[trained, served_by] = pickle.load(f)
    assert len(results["torch", "torch"]) == 10
    for key, r in results.items():
        assert r == results["jax", "jax"], key


@pytest.mark.parametrize("architecture,kw", [
    ("biLSTMCRF", dict(loss_fn="CrossEntropy")),
    ("Transformer-CRF", dict(loss_fn="CrossEntropy", nheads=2)),
    ("SwitchBiLSTM", dict(switch="dense", loss_fn="FocalLoss")),
    ("SwitchBiLSTM", dict(switch="lstm", loss_fn="CrossEntropy")),
    ("BiLSTMLateFusion", dict(embedding_dim2=6, loss_fn="FocalLoss")),
    ("SheikhBiLSTM", dict(loss_fn="BinaryCrossEntropy")),
])
def test_trainer_test_and_search_threshold_match_jax_across_the_zoo(tmp_path, architecture, kw):
    """`test`, `search_threshold` and `predict` of both Trainers on one
    checkpoint: a CRF stores one Viterbi score per document and searches no
    threshold (0.5, nan); SwitchBiLSTM reads each batch's domain flags, late
    fusion its second modality."""
    jcfg, cfg = _cfgs(**kw)
    params = _jax_params(jax_registry.build(architecture, jcfg), seed=2)
    path = str(tmp_path / "shared.ckpt")
    jax_ckpt.save(path, params, jcfg, architecture)
    batches = _eval_batches()
    rng = np.random.default_rng(9)
    for b in batches:
        b["domain"] = np.array([1, 0, 1], np.int32)
        b["src_tokens2"] = rng.standard_normal(b["src_tokens"].shape[:2] + (6,)).astype(np.float32)
        if registry.is_crf(architecture):
            b["tgt_tokens"][b["tgt_tokens"] < 0] = 0.0
    jt = JLoop.Trainer(architecture, jcfg)
    tt = TLoop.Trainer(architecture, cfg, device="cpu")
    jparams, tparams = jax_ckpt.load(path)[0], ckpt.load(path)[0]
    want, want_docs, want_scores = jt.test(jparams, batches)
    got, got_docs, got_scores = tt.test(tparams, batches)
    assert got == pytest.approx(want, abs=1e-9) and got_docs == want_docs
    assert [s.shape for s in got_scores] == [s.shape for s in want_scores]
    for a, b in zip(got_scores, want_scores):
        np.testing.assert_allclose(a, b, atol=ATOL)
    want_th, got_th = jt.search_threshold(jparams, batches), tt.search_threshold(tparams, batches)
    if registry.is_crf(architecture):
        assert all(s.shape == (1,) for s in got_scores)
        assert got_th[0] == want_th[0] == 0.5 and np.isnan(got_th[1]) and np.isnan(want_th[1])
    else:
        assert got_th == pytest.approx(want_th)
    assert tt.predict(tparams, batches, 0.4) == jt.predict(jparams, batches, 0.4)
