"""Device-resident epoch windows of the port (train/device_fit.py) on the CPU.

The windows run the host loop's own train step and make its decisions on the
device, so on one device the two give the same history: losses to 1e-6 (they
are equal, one op sequence and one generator), the same stopping epoch,
snapshot name and parameters, the same plateau rates, at nonzero dropout.
Against the JAX package's `Trainer(device_epochs=True)` at dropout 0, from
the JAX first weights: histories to 1e-5 and the same decisions. The
optimizer with its rate on the device against `torch.optim.Adam` / `SGD`:
losses to 1e-6 over 30 steps. Mirrors tests/test_device_epochs.py.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_tpu.train import loop as JLoop
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models import transformers as TT
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.ops import attention as TA
from multimodaltopicsegmentation_torch.ops import rnn as rnn_lib
from multimodaltopicsegmentation_torch.train import checkpoints as ckpt
from multimodaltopicsegmentation_torch.train import device_fit
from multimodaltopicsegmentation_torch.train import loop as TLoop

torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-6  # port windows against the port host loop
JAX_ATOL = 1e-5  # against the JAX package


def _batch(seed, B=4, L=24, dim=16, boundary_p=0.15, domain=None, double=False):
    rng = np.random.default_rng(seed)
    lengths = np.array([L, L - 3, L - 9, 5][:B], np.int32)
    tags = (rng.random((B, L)) < boundary_p).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    b = {"src_tokens": rng.standard_normal((B, L, dim)).astype(np.float32),
         "tgt_tokens": tags, "src_lengths": lengths, "n_real": B}
    if domain is not None:
        b["domain"] = np.full((B,), domain, np.int32)
    if double:
        b["src_tokens2"] = rng.standard_normal((B, L, dim)).astype(np.float32)
    return b


def _cfg(**kw):
    base = dict(embedding_dim=16, embedding_dim2=16, hidden_dim=8, num_layers=1,
                loss_fn="FocalLoss", dropout_in=0.2, dropout_out=0.3)
    base.update(kw)
    return TaggerConfig(**base)


def _fit(tmp_path, mode, arch, cfg, tb, vb, device="cpu", **kw):
    """mode "host" or "device"; "env" leaves the choice to MTS_DEVICE_EPOCHS."""
    tr = TLoop.Trainer(arch, cfg, check_dir=str(tmp_path / f"ck_{mode}"), device=device,
                       device_epochs={"host": False, "device": True}.get(mode), **kw)
    params, hist = tr.fit(tb, vb)
    return tr, params, hist


def _assert_same_fit(host, device, atol=ATOL):
    (tr_h, p_h, hist_h), (tr_d, p_d, hist_d) = host, device
    assert len(hist_h) == len(hist_d)
    for a, b in zip(hist_h, hist_d):
        assert a["epoch"] == b["epoch"]
        assert a["training_loss"] == pytest.approx(b["training_loss"], abs=atol)
        if a["val_loss"] is None:
            assert b["val_loss"] is None
        else:
            assert a["val_loss"] == pytest.approx(b["val_loss"], abs=atol, nan_ok=True)
    assert os.path.basename(tr_h.best_model_path) == os.path.basename(tr_d.best_model_path)
    assert tr_h.opt.param_groups[0]["lr"] == tr_d.opt.param_groups[0]["lr"]
    assert tr_h.opt.host_steps() == tr_d.opt.host_steps()
    assert torch.equal(tr_h.generator.get_state(), tr_d.generator.get_state())
    best_h, _, _, extra_h = ckpt.load(tr_h.best_model_path)
    best_d, _, _, extra_d = ckpt.load(tr_d.best_model_path)
    assert extra_h["epoch"] == extra_d["epoch"]
    for a, b in zip(jax.tree.leaves(best_h), jax.tree.leaves(best_d)):
        np.testing.assert_allclose(a, b, atol=atol)
    for a, b in zip(jax.tree.leaves(p_h), jax.tree.leaves(p_d)):
        np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("window", ["3", "25"])
def test_windows_match_host_loop_with_early_stop(tmp_path, monkeypatch, window):
    """patience 4 stops inside a window: the epochs after the stop are
    masked (parameters, moments, step counts and the generator set back),
    and the history ends where the host loop's `break` ends it."""
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", window)
    tb = [_batch(s) for s in range(3)]
    vb = [_batch(100), _batch(101, B=4)]
    host, device = (_fit(tmp_path, mode, "BiLSTM", _cfg(), tb, vb, lr=1e-2, max_epochs=25,
                         patience=4) for mode in ("host", "device"))
    _assert_same_fit(host, device)
    assert len(host[2]) < 25 and len(host[2]) % int(window) != 0  # stopped inside a window


def test_windows_match_host_loop_plateau_lr(tmp_path, monkeypatch):
    """Long enough for ReduceLROnPlateau(patience 10) to cut the rate on the
    device: the same rates and trajectory as the host loop's scheduler."""
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "7")
    cfg = _cfg(embedding_dim=8, hidden_dim=4)
    tb = [_batch(s, B=2, L=12, dim=8) for s in range(2)]
    vb = [_batch(7, B=2, L=12, dim=8, boundary_p=0.9)]  # a loss of another distribution
    host, device = (_fit(tmp_path, mode, "BiLSTM", cfg, tb, vb, lr=5e-2, max_epochs=30,
                         no_early_stop=True) for mode in ("host", "device"))
    _assert_same_fit(host, device)
    assert device[0].opt.param_groups[0]["lr"] < 5e-2  # the rate was cut
    assert float(device[0].opt.lr_t) == device[0].opt.param_groups[0]["lr"]


def test_windows_match_host_loop_without_valid_batches(tmp_path):
    cfg = _cfg(embedding_dim=8, hidden_dim=4, loss_fn="CrossEntropy")
    tb = [_batch(s, B=2, L=12, dim=8) for s in range(2)]
    host, device = (_fit(tmp_path, mode, "BiLSTM", cfg, tb, None, lr=1e-2, max_epochs=7,
                         monitor="training_loss", patience=2) for mode in ("host", "device"))
    _assert_same_fit(host, device)


@pytest.mark.parametrize("arch,extra", [("SwitchBiLSTM", "domain"),
                                        ("BiLSTMLateFusion", "double")])
def test_windows_match_host_loop_with_extra_inputs(tmp_path, arch, extra):
    """The domain flags and the second modality stack with the batches."""
    cfg = _cfg(embedding_dim=8, embedding_dim2=8, hidden_dim=4)
    kw = {"domain": 0} if extra == "domain" else {"double": True}
    tb = [_batch(s, B=2, L=12, dim=8, **kw) for s in range(2)]
    if extra == "domain":
        tb[1]["domain"][:] = 1
    vb = [_batch(9, B=2, L=12, dim=8, **kw)]
    host, device = (_fit(tmp_path, mode, arch, cfg, tb, vb, lr=1e-2, max_epochs=5)
                    for mode in ("host", "device"))
    _assert_same_fit(host, device)


def test_windows_match_host_loop_through_the_flash_entries(tmp_path, monkeypatch):
    """A Transformer with attention and layer dropout through the flash
    entries' plain versions (the route the card takes), early stop inside a
    window."""
    monkeypatch.setattr(TA, "flash_attention_active", lambda where: True)
    monkeypatch.setattr(TT, "_auto_remat", lambda *a, **k: False)  # the card's choice here
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "3")
    cfg = _cfg(hidden_dim=16, num_layers=1, nheads=2, attention_window=8)
    tb = [_batch(s) for s in range(2)]
    vb = [_batch(50)]
    host, device = (_fit(tmp_path, mode, "Transformer", cfg, tb, vb, lr=3e-2, max_epochs=8,
                         patience=2) for mode in ("host", "device"))
    _assert_same_fit(host, device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_step", [("Transformer", (2, 2, 0, 2)),
                                           ("RecurrentLongT5", (2, 0, 2, 2))])
def test_cuda_windows_match_host_loop(tmp_path, monkeypatch, arch, per_step):
    """On the card, with attention and layer dropout: the windows against the
    host loop, as on the CPU (history to 1e-6, decisions, parameters), with
    the same flash launches in both, (K2, K4, K5, K3) `per_step` a step and
    2 K2 a validation pass; the Transformer's windows enqueue without a
    synchronizing call (torch's sync debug mode "error" raises on one)."""
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "3")
    if arch == "Transformer":
        make = device_fit.make_fit_window

        def checked(*args, **kwargs):
            fit_window = make(*args, **kwargs)

            def run(*a):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fit_window(*a)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return run

        monkeypatch.setattr(device_fit, "make_fit_window", checked)
    cfg = _cfg(hidden_dim=16, num_layers=2, nheads=2, attention_window=8)
    tb = [_batch(s) for s in range(2)]
    vb = [_batch(50)]
    counters = (FA._flash_fwd, FA._flash_dq, FA._flash_dq_dbias, FA._flash_dkv)
    runs, launches = [], []
    for mode in ("host", "device"):
        for c in counters:
            c.launches = 0
        runs.append(_fit(tmp_path, mode, arch, cfg, tb, vb, device="cuda", lr=3e-2,
                         max_epochs=6, patience=20))
        launches.append(tuple(c.launches for c in counters))
    _assert_same_fit(*runs)
    epochs = len(runs[1][2])
    steps = epochs * len(tb)
    want = tuple(steps * n for n in per_step)
    assert launches[0] == launches[1] == (want[0] + epochs * len(vb) * 2,) + want[1:]


def test_detect_anomaly_replay(tmp_path):
    """NaN in train batch 1 of epoch 0: the host tripwire's message, and no
    snapshot (the raise comes before the first one)."""
    tb = [_batch(s, B=2, L=10, dim=8) for s in range(2)]
    tb[1]["src_tokens"][0, 0, 0] = np.nan
    tr = TLoop.Trainer("BiLSTM", _cfg(embedding_dim=8, hidden_dim=4), lr=1e-3, max_epochs=5,
                       check_dir=str(tmp_path / "ck"), device="cpu", device_epochs=True)
    with pytest.raises(FloatingPointError, match="non-finite training loss nan at epoch 0, batch 1"):
        tr.fit(tb, None)
    assert tr.best_model_path is None
    assert not os.listdir(tmp_path / "ck")


def test_ragged_batches_fall_back_to_the_host_loop(tmp_path, monkeypatch):
    """Ragged batches, which JAX's windows refuse (it falls back to its host
    loop), run in the port's windows over the host loop's own device batches
    and give the host loop's history and decisions."""
    monkeypatch.setenv("MTS_DEVICE_EPOCHS", "1")  # the switch JAX reads, too
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "2")
    cfg = _cfg(embedding_dim=8, hidden_dim=4)
    tb = [_batch(0, B=2, L=12, dim=8), _batch(1, B=4, L=20, dim=8)]
    vb = [_batch(2, B=2, L=9, dim=8), _batch(3, B=4, L=14, dim=8)]
    device = _fit(tmp_path, "env", "BiLSTM", cfg, tb, vb, lr=1e-2, max_epochs=5)
    assert device[0].device_epochs
    host = _fit(tmp_path, "host", "BiLSTM", cfg, tb, vb, lr=1e-2, max_epochs=5)
    _assert_same_fit(host, device)


def test_non_finite_monitored_value_names_the_snapshot_as_the_host_loop(tmp_path, monkeypatch):
    """A NaN valid batch with finite training losses: every monitored value
    is +inf, epoch 0 snapshots as `val_loss=9999.9999` in the windows, the
    host loop and the JAX host loop alike, and the patience stops the run.
    (JAX's own windows keep the name in float32, which rounds it to
    10000.0000.)"""
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "3")
    _jax_first_weights(monkeypatch)
    fields = dict(embedding_dim=8, hidden_dim=4, num_layers=1, loss_fn="FocalLoss")
    tb = [_batch(s, B=2, L=12, dim=8) for s in range(2)]
    vb = [_batch(9, B=2, L=12, dim=8)]
    vb[0]["src_tokens"][0, 0, 0] = np.nan
    kw = dict(lr=1e-2, max_epochs=8, patience=2)
    host, device = (_fit(tmp_path, mode, "BiLSTM", TaggerConfig(**fields), tb, vb, **kw)
                    for mode in ("host", "device"))
    _assert_same_fit(host, device)
    assert len(device[2]) == 3 and all(np.isnan(h["val_loss"]) for h in device[2])
    name = os.path.basename(device[0].best_model_path)
    assert name == ckpt.checkpoint_name(0, 9999.9999, 0.5)
    # the train CLI parses it (with "inf" in the name the parse raised)
    assert ckpt.parse_checkpoint_name(device[0].best_model_path)[0] == 0.5
    jt = JLoop.Trainer("BiLSTM", JaxTaggerConfig(**fields), check_dir=str(tmp_path / "j"), **kw)
    _, j_hist = jt.fit(tb, vb)
    assert len(j_hist) == len(device[2])
    for a, b in zip(device[2], j_hist):
        assert a["training_loss"] == pytest.approx(b["training_loss"], abs=JAX_ATOL)
    assert os.path.basename(jt.best_model_path) == name


def test_window_shorter_than_the_run_and_refit(tmp_path, monkeypatch):
    """max_epochs not a multiple of the window, then a refit with another
    max_epochs: it starts anew from the seed and equals the host loop."""
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "4")
    cfg = _cfg(embedding_dim=8, hidden_dim=4)
    tb = [_batch(s, B=2, L=12, dim=8) for s in range(2)]
    tr = TLoop.Trainer("BiLSTM", cfg, lr=1e-2, max_epochs=6, no_early_stop=True,
                       check_dir=str(tmp_path / "ck"), device="cpu", device_epochs=True)
    _, hist = tr.fit(tb, None)
    assert [h["epoch"] for h in hist] == list(range(6))
    tr.max_epochs = 9
    params, hist = tr.fit(tb, None)
    host = _fit(tmp_path, "host", "BiLSTM", cfg, tb, None, lr=1e-2, max_epochs=9,
                no_early_stop=True)
    _assert_same_fit(host, (tr, params, hist))


def test_unpack_window_layout():
    packed = np.arange(2 * (3 + 1 + 2), dtype=np.float32)
    packed[-4:] = [1, 0, 1, 1]
    tr, val, stops, ran = device_fit.unpack_window(packed, window=2, nb=3, nv=1)
    np.testing.assert_array_equal(tr, [[0, 1, 2], [3, 4, 5]])
    np.testing.assert_array_equal(val, [[6], [7]])
    assert stops.tolist() == [True, False] and ran.tolist() == [True, True]


def test_lengths_keep_their_packing_order():
    """The packing reads the order that batches_to_device attached to the
    lengths (no transfer on a card): outputs and gradients equal those of
    torch's pack_padded_sequence / pad_packed_sequence."""
    b = TLoop.batches_to_device([_batch(3, B=4, L=12, dim=8)], "cpu")[0]
    sorted_lengths, order = b["src_lengths"].host_packing
    assert sorted_lengths.tolist() == [12, 9, 5, 3] and order.tolist() == [0, 1, 3, 2]
    rnn = rnn_lib.RNNStack(8, 4, 1, generator=torch.Generator().manual_seed(0))
    outs, grads = [], []
    for lengths in (b["src_lengths"], b["src_lengths"].clone()):  # the clone has no order
        x = b["src_tokens"].clone().requires_grad_(True)
        y = rnn(x, lengths)
        (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
        outs.append(y.detach())
        grads.append(x.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_device_rate_optimizer_moves_the_trajectory_within_1e6(name):
    """The host loop's optimizer now reads its rate from the device: 30
    steps of a BiLSTM tagger stay within 1e-6 of torch.optim's."""
    cfg = _cfg(dropout_in=0.0, dropout_out=0.0)
    b = TLoop.batches_to_device([_batch(5)], "cpu")[0]
    losses = {}
    for which in ("port", "torch"):
        tagger = registry.build("BiLSTM", cfg, torch.Generator().manual_seed(0))
        if which == "port":
            opt = TLoop.make_optimizer(name, tagger.parameters(), 1e-2)
        elif name == "Adam":
            opt = torch.optim.Adam(tagger.parameters(), lr=1e-2, eps=1e-7)
        else:
            opt = torch.optim.SGD(tagger.parameters(), lr=1e-2, momentum=0.9, weight_decay=1e-4)
        losses[which] = []
        for _ in range(30):
            opt.zero_grad(set_to_none=True)
            loss = tagger.loss(b["src_tokens"], b["src_lengths"], b["tgt_tokens"])
            loss.backward()
            opt.step()
            losses[which].append(loss.item())
    np.testing.assert_allclose(losses["port"], losses["torch"], atol=1e-6)
    assert losses["port"][-1] < losses["port"][0]


def _jax_first_weights(monkeypatch):
    """The port's Trainer starts from the weights the JAX Trainer draws for
    the same seed (its fit splits PRNGKey(seed) once)."""
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


def test_windows_match_the_jax_device_epochs(tmp_path, monkeypatch):
    """Both packages' Trainer(device_epochs=True) at dropout 0 from JAX's
    first weights, early stop inside a window of 4: the same history to
    1e-5, the same stopping epoch and snapshot name, best weights to 1e-5."""
    monkeypatch.setenv("MTS_DEVICE_EPOCH_WINDOW", "4")
    _jax_first_weights(monkeypatch)
    fields = dict(embedding_dim=16, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    tb = [_batch(s) for s in range(2)]
    vb = [_batch(100)]
    kw = dict(lr=3e-2, max_epochs=14, patience=3)
    jt = JLoop.Trainer("BiLSTM", JaxTaggerConfig(**fields), check_dir=str(tmp_path / "j"),
                       device_epochs=True, **kw)
    _, j_hist = jt.fit(tb, vb)
    tt = TLoop.Trainer("BiLSTM", TaggerConfig(**fields), check_dir=str(tmp_path / "t"),
                       device="cpu", device_epochs=True, **kw)
    _, t_hist = tt.fit(tb, vb)
    assert len(t_hist) == len(j_hist) < 14
    for a, b in zip(t_hist, j_hist):
        assert a["training_loss"] == pytest.approx(b["training_loss"], abs=JAX_ATOL)
        assert a["val_loss"] == pytest.approx(b["val_loss"], abs=JAX_ATOL)
    assert os.path.basename(tt.best_model_path) == os.path.basename(jt.best_model_path)
    got, want = ckpt.load(tt.best_model_path)[0], jax_ckpt.load(jt.best_model_path)[0]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=JAX_ATOL)
