"""Training and evaluation runtime for one device (counterpart of the JAX
package's train/loop.py, which replaces the reference's pytorch-lightning
stack).

Observable behaviour, as there:

- Adam(eps=1e-7) or SGD(momentum .9, weight_decay 1e-4), optional clipping
  by the global gradient norm;
- ReduceLROnPlateau(factor .8, patience 10, relative threshold 1e-4) on the
  monitored loss, as a host-side scheduler that sets the optimizer's rate;
- early stop (patience, mode min) and a top-1 snapshot keyed on
  val_loss/training_loss with the reference's file-name grammar, written in
  a `finally` so that a crash mid-training still leaves it on disk;
- test-time decode thresholds: `threshold`, else 0.4, and the 0.0 -> 0.5 quirk;
- per-document Pk / F1 / WindowDiff (AssertionError -> Pk), or B-measure /
  WinPR, depending on `metric`;
- the validation loss is computed WITHOUT dropout.

Parameters cross the API as the JAX-layout pytree with numpy leaves (a
tagger's `to_jax_params()`), the form the checkpoints hold: `fit` returns it,
`test`, `search_threshold` and `predict` take it. Batches are copied to the
device once, before the epoch loop, and an epoch's losses are pulled to the
host in one transfer at its end.

`device_epochs=True` (or MTS_DEVICE_EPOCHS=1) runs whole windows of
MTS_DEVICE_EPOCH_WINDOW epochs (default 10) with the decisions on the device
and one transfer per window (train/device_fit.py), over the same device
batches as the host loop, ragged ones included.

Not ported yet (the constructor raises): `mesh`, `pipeline_stages`,
`sequence_shards`, `expert_parallel` (ROADMAP.md section 1 item 14).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from ..eval import metrics as M
from ..models import registry
from ..models.base import TaggerConfig
from ..ops import rnn as rnn_lib
from . import checkpoints as ckpt_lib


class Optimizer(torch.optim.Optimizer):
    """Adam (eps 1e-7), or ("SGD") SGD with momentum .9 and weight decay 1e-4
    added to the gradient, as the reference has them, whose learning rate is
    a float64 0-d tensor on the parameters' device, `lr_t`.

    A rate decided on the device (train/device_fit.py's plateau step) is read
    by the next step without a transfer; `torch.optim.Adam` takes a tensor
    rate only with `capturable=True`, which refuses CPU parameters. The host
    loop and the device windows step through this one class, so that the
    two follow one trajectory. The arithmetic is torch.optim.Adam's / SGD's
    (bias corrections from each parameter's host step count, in float64),
    except that the step size lr / (1 - beta1^t) is formed on the device in
    float64 and applied in float32 as p += -(step size) * (m / denom), where
    torch applies it as one addcdiv. `param_groups[0]["lr"]` mirrors the rate
    that the host last set."""

    BETAS = (0.9, 0.999)
    EPS = 1e-7
    MOMENTUM = 0.9
    WEIGHT_DECAY = 1e-4

    def __init__(self, name: str, params, lr: float):
        params = list(params)
        super().__init__(params, {"lr": lr})
        self.name = name
        self.lr_t = torch.full((), lr, dtype=torch.float64, device=params[0].device)

    def set_lr(self, lr: float):
        for group in self.param_groups:
            group["lr"] = lr
        self.lr_t.fill_(lr)

    def host_steps(self) -> list:
        """Each parameter's step count (host ints), for `rewind`."""
        return [self.state[p].get("step", 0) for g in self.param_groups for p in g["params"]]

    def rewind(self, steps: list):
        """Set the step counts back (train/device_fit.py: a masked epoch
        leaves the device state as it was but counts on the host)."""
        for p, n in zip((p for g in self.param_groups for p in g["params"]), steps):
            self.state[p]["step"] = n

    def state_tensors(self) -> list:
        """The device tensors a step updates: parameters, then moments or
        momentum buffers, in a fixed order."""
        out = [p for g in self.param_groups for p in g["params"]]
        for p in list(out):
            out += [v for k, v in sorted(self.state[p].items()) if isinstance(v, torch.Tensor)]
        return out

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        by_step = {}
        for p in params:
            st = self.state[p]
            st["step"] = st.get("step", 0) + 1
            by_step.setdefault(st["step"], []).append(p)
        for t, group in by_step.items():
            grads = [p.grad for p in group]
            if self.name == "SGD":
                self._sgd(group, grads)
            else:
                self._adam(group, grads, t)

    def _sgd(self, params, grads):
        grads = torch._foreach_add(grads, params, alpha=self.WEIGHT_DECAY)
        bufs = []
        for p, d in zip(params, grads):
            st = self.state[p]
            if "momentum_buffer" not in st:
                st["momentum_buffer"] = d.clone()
            else:
                st["momentum_buffer"].mul_(self.MOMENTUM).add_(d)
            bufs.append(st["momentum_buffer"])
        torch._foreach_add_(params, torch._foreach_mul(bufs, (-self.lr_t).float()))

    def _adam(self, params, grads, t: int):
        b1, b2 = self.BETAS
        for p in params:
            st = self.state[p]
            if "exp_avg" not in st:
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_lerp_(ms, grads, 1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_div_(denom, (1 - b2 ** t) ** 0.5)
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(ms, denom)
        torch._foreach_mul_(update, (self.lr_t / -(1 - b1 ** t)).float())
        torch._foreach_add_(params, update)


def make_optimizer(name: str, params, lr: float) -> Optimizer:
    """Adam with eps 1e-7, or ("SGD") SGD with momentum .9 and weight decay
    1e-4, as the reference has them, with the rate on the device."""
    return Optimizer(name, params, lr)


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so that their global L2 norm is at most
    `max_norm`: untouched below it, else g / norm * max_norm (no epsilon in
    the divisor, unlike `torch.nn.utils.clip_grad_norm_`). -> the norm before
    clipping, on the device; nothing is pulled to the host."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


class PlateauScheduler:
    """torch ReduceLROnPlateau(mode=min, factor, patience, rel threshold 1e-4)."""

    def __init__(self, lr: float, factor: float = 0.8, patience: int = 10):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad = 0

    def step(self, value: float) -> float:
        if value < self.best * (1 - 1e-4):
            self.best = value
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr *= self.factor
                self.bad = 0
        return self.lr


_DEVICE_KEYS = ("src_tokens", "tgt_tokens", "src_lengths", "domain", "src_tokens2")


def batches_to_device(batches: List[dict], device) -> List[dict]:
    """Copy each batch's arrays to the device ONCE, before the epoch loop
    (the domain flags and the second modality too, where a batch has them).
    The lengths keep their packing order (`ops.rnn.with_host_lengths`)."""
    out = []
    for batch in batches:
        db = dict(batch)
        for key in _DEVICE_KEYS:
            if key in batch:
                db[key] = torch.as_tensor(np.asarray(batch[key])).to(device)
        db["src_lengths"] = rnn_lib.with_host_lengths(
            db["src_lengths"], torch.as_tensor(np.asarray(batch["src_lengths"])))
        out.append(db)
    return out


class Trainer:
    """Single-model fit/test runner (one fold, one hyperparameter setting)."""

    def __init__(
        self,
        architecture: str,
        cfg: TaggerConfig,
        lr: float = 1e-3,
        optimizer: str = "Adam",
        max_epochs: int = 100,
        patience: int = 20,
        no_early_stop: bool = False,
        monitor: str = "val_loss",
        check_dir: str = "checkpoints",
        seed: int = 42,
        gradient_clipping: float = 0.0,
        metric: str = "Pk",
        threshold: Optional[float] = None,
        use_end_boundary: bool = False,
        zero_baseline: bool = False,
        mesh=None,
        detect_anomaly: bool = True,
        pipeline_stages: int = 0,
        sequence_shards: int = 0,
        expert_parallel: Optional[bool] = None,
        device_epochs: Optional[bool] = None,
        device="cuda",
    ):
        for name, asked, item in (
            ("mesh", mesh is not None, 14),
            ("pipeline_stages", bool(pipeline_stages and pipeline_stages > 1), 14),
            ("sequence_shards", bool(sequence_shards and sequence_shards > 1), 14),
            ("expert_parallel", expert_parallel is True, 14),
        ):
            if asked:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet: ROADMAP.md section 1 item {item}")
        self.device = resolve_device(device)
        self.arch_name = architecture
        self.cfg = cfg
        self.lr = lr
        self.optimizer_name = optimizer
        self.max_epochs = max_epochs
        self.patience = patience
        self.no_early_stop = no_early_stop
        self.monitor = monitor
        self.check_dir = check_dir
        self.seed = seed
        self.clip = gradient_clipping
        self.metric = metric
        self.threshold = threshold
        self.eb = use_end_boundary
        self.zero_baseline = zero_baseline
        # SwitchBiLSTM takes each batch's domain flags, late fusion its second modality
        self.domain = registry.is_domain_adapt(architecture)
        self.double = registry.is_double_input(architecture)
        # the non-finite-loss tripwire, the analogue of the reference's
        # always-on Lightning Trainer(detect_anomaly=True)
        self.detect_anomaly = detect_anomaly
        # device-resident epoch windows (train/device_fit.py)
        if device_epochs is None:
            device_epochs = os.environ.get("MTS_DEVICE_EPOCHS", "0") == "1"
        self.device_epochs = device_epochs
        self.best_model_path: Optional[str] = None
        self.opt = None
        self._build()

    def _build(self):
        """A new tagger from the seed. Weights are drawn on the CPU, so that
        one seed gives the card and the CPU the same model; dropout draws on
        the device."""
        init = torch.Generator().manual_seed(self.seed)
        self.tagger = registry.build(self.arch_name, self.cfg, init).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    # -- parameters across the API --------------------------------------------
    def _load(self, params):
        """Put a JAX-layout pytree into the tagger (None keeps what it holds)."""
        if params is not None:
            self.tagger.load_state_dict(type(self.tagger).from_jax_params(params))
            self.tagger.to(self.device)

    def _setup(self, params=None):
        """(Re)start training: weights from `params` if given, else drawn anew
        from the seed; a new optimizer."""
        if params is None:
            self._build()
        self._load(params)
        self.opt = make_optimizer(self.optimizer_name, list(self.tagger.parameters()), self.lr)

    def _set_lr(self, lr: float):
        self.opt.set_lr(lr)

    # -- one step ---------------------------------------------------------------
    def _loss(self, batch: dict, generator) -> torch.Tensor:
        args = (batch["src_tokens"], batch["src_lengths"], batch["tgt_tokens"])
        if self.domain:
            return self.tagger.loss(*args, batch["domain"], generator=generator)
        if self.double:
            return self.tagger.loss(*args, generator=generator, x2=batch["src_tokens2"])
        return self.tagger.loss(*args, generator=generator)

    def _train_step(self, batch: dict) -> torch.Tensor:
        """Forward with dropout, backward, clip, optimizer step -> the loss,
        detached and left on the device."""
        self.opt.zero_grad(set_to_none=True)
        loss = self._loss(batch, self.generator)
        loss.backward()
        if self.clip and self.clip > 0:
            clip_by_global_norm_(list(self.tagger.parameters()), self.clip)
        self.opt.step()
        return loss.detach()

    def _eval_loss(self, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return self._loss(batch, None)

    def _snapshot(self):
        return {k: v.detach().clone() for k, v in self.tagger.state_dict().items()}

    # -- device-resident epoch windows --------------------------------------------
    def _fit_device_epochs(self, train_batches, valid_batches):
        """fit() with the epoch loop's decisions on the device
        (train/device_fit.py): one packed pull per window of epochs. The
        history and the anomaly tripwire are replayed from the pulled
        losses; the snapshot is written in `finally` unless the tripwire
        fired before any epoch had improved."""
        from . import device_fit

        window = int(os.environ.get("MTS_DEVICE_EPOCH_WINDOW", "10"))
        nb, nv = len(train_batches), len(valid_batches or [])
        weights = [b.get("n_real", len(b["src_lengths"])) for b in valid_batches or []]
        self._setup()
        train_batches = batches_to_device(train_batches, self.device)
        valid_batches = batches_to_device(valid_batches, self.device) if nv else []
        fit_window = device_fit.make_fit_window(
            self, window=window, val_weights=weights, monitor_train=self.monitor == "training_loss",
            patience=self.patience, no_early_stop=self.no_early_stop)
        carry = device_fit.init_carry(list(self.tagger.parameters()), self.opt.lr_t)
        os.makedirs(self.check_dir, exist_ok=True)
        history, anomaly_epoch, mark = [], None, None
        try:
            e0, stopped = 0, False
            while e0 < self.max_epochs and not stopped:
                packed, marks = fit_window(carry, e0, self.max_epochs, train_batches, valid_batches)
                tr, val, stops, ran = device_fit.unpack_window(packed.cpu().numpy(), window, nb, nv)
                for i in range(window):
                    if not ran[i]:
                        break
                    epoch, mark = e0 + i, marks[i]
                    batch_losses = [float(x) for x in tr[i]]
                    if self.detect_anomaly and not all(np.isfinite(batch_losses)):
                        bad = int(np.flatnonzero(~np.isfinite(batch_losses))[0])
                        anomaly_epoch = epoch
                        raise FloatingPointError(
                            f"detect_anomaly: non-finite training loss {batch_losses[bad]} at "
                            f"epoch {epoch}, batch {bad} (arch={self.arch_name}, lr={self.lr}; "
                            f"pass detect_anomaly=False to train through it)")
                    history.append({"epoch": epoch, "training_loss": float(np.mean(batch_losses)),
                                    "val_loss": float(np.average(val[i], weights=weights))
                                    if nv else None})
                    if stops[i]:
                        stopped = True
                        break
                e0 += window
        finally:
            best_epoch, best_fname, best = torch.stack([
                carry["best_epoch"].double(), carry["best_fname"], carry["best"]]).tolist()
            best_epoch = int(best_epoch)
            if anomaly_epoch is None or best_epoch < anomaly_epoch:
                self.best_model_path = os.path.join(
                    self.check_dir, ckpt_lib.checkpoint_name(best_epoch, best_fname, 0.5))
                last = self._snapshot()
                with torch.no_grad():
                    for p, b in zip(self.tagger.parameters(), carry["best_params"]):
                        p.copy_(b)
                ckpt_lib.save(self.best_model_path, self.tagger.to_jax_params(), self.cfg,
                              self.arch_name, extra={"epoch": best_epoch, "monitored": best})
                self.tagger.load_state_dict(last)
        # where epochs after the stop were masked, the generator and the step
        # counts are set back to the end of the last epoch that ran
        if mark is not None:
            self.generator.set_state(mark[0])
            self.opt.rewind(mark[1])
        self.opt.set_lr(float(carry["lr"]))
        self.params = self.tagger.to_jax_params()
        self.history = history
        return self.params, history

    # -- fit --------------------------------------------------------------------
    def fit(self, train_batches: List[dict], valid_batches: Optional[List[dict]] = None):
        """-> (final params, history). The top-1 snapshot is written to
        `best_model_path` when the loop ends, however it ends."""
        if self.device_epochs:
            return self._fit_device_epochs(train_batches, valid_batches)
        self._setup()
        train_batches = batches_to_device(train_batches, self.device)
        valid_batches = batches_to_device(valid_batches, self.device) if valid_batches else None

        sched = PlateauScheduler(self.lr)
        best = float("inf")
        bad_epochs = 0
        best_snapshot = None
        best_extra = {}
        os.makedirs(self.check_dir, exist_ok=True)

        history = []
        try:
            for epoch in range(self.max_epochs):
                train_losses = [self._train_step(batch) for batch in train_batches]
                val_device, weights = [], []
                for batch in valid_batches or []:
                    val_device.append(self._eval_loss(batch))
                    weights.append(batch.get("n_real", len(batch["src_lengths"])))
                # one transfer per epoch for the training losses, one for the
                # validation losses; an empty fold keeps mean([]) -> nan
                batch_losses = torch.stack(train_losses).tolist() if train_losses else []
                if self.detect_anomaly and not all(np.isfinite(batch_losses)):
                    bad = int(np.flatnonzero(~np.isfinite(batch_losses))[0])
                    raise FloatingPointError(
                        f"detect_anomaly: non-finite training loss {batch_losses[bad]} at epoch "
                        f"{epoch}, batch {bad} (arch={self.arch_name}, lr={self.lr}; pass "
                        f"detect_anomaly=False to train through it)")
                train_loss = float(np.mean(batch_losses))
                val_loss = None
                if val_device:
                    val_loss = float(np.average(torch.stack(val_device).cpu().numpy(),
                                                weights=weights))

                monitored = train_loss if self.monitor == "training_loss" else val_loss
                if monitored is None:
                    monitored = train_loss
                history.append({"epoch": epoch, "training_loss": train_loss, "val_loss": val_loss})

                # top-1 snapshot on improvement (NaN counts as none, but the
                # first epoch always snapshots so that a best path exists);
                # it stays on the device until the loop ends
                if not np.isfinite(monitored):
                    monitored = float("inf")
                if monitored < best or best_snapshot is None:
                    best = monitored
                    bad_epochs = 0
                    best_snapshot = self._snapshot()
                    fname_val = monitored if np.isfinite(monitored) else 9999.9999
                    self.best_model_path = os.path.join(
                        self.check_dir, ckpt_lib.checkpoint_name(epoch, fname_val, 0.5))
                    best_extra = {"epoch": epoch, "monitored": monitored}
                else:
                    bad_epochs += 1
                    if not self.no_early_stop and bad_epochs >= self.patience:
                        break

                self._set_lr(sched.step(monitored))
        finally:
            if best_snapshot is not None:
                last = self._snapshot()
                self.tagger.load_state_dict(best_snapshot)
                ckpt_lib.save(self.best_model_path, self.tagger.to_jax_params(), self.cfg,
                              self.arch_name, extra=best_extra)
                self.tagger.load_state_dict(last)
        self.params = self.tagger.to_jax_params()
        self.history = history
        return self.params, history

    def save_final(self, params):
        """The reference's -s_last / no_validation path: final=0.500.ckpt."""
        path = os.path.join(self.check_dir, "final=0.500.ckpt")
        ckpt_lib.save(path, params, self.cfg, self.arch_name, extra={"final": True})
        self.best_model_path = path
        return path

    # -- decode -----------------------------------------------------------------
    def _decode(self, batch: dict, threshold: float):
        """-> (scores, tags) of one batch as numpy; the scores are the head's
        logits, or one Viterbi score per document for a CRF."""
        with torch.inference_mode():
            x, lengths = (torch.as_tensor(np.asarray(batch[k])).to(self.device)
                          for k in ("src_tokens", "src_lengths"))
            if self.domain:
                domains = torch.as_tensor(np.asarray(batch["domain"])).to(self.device)
                scores, tags = self.tagger.decode(x, lengths, domains, threshold)
            elif self.double:
                x2 = torch.as_tensor(np.asarray(batch["src_tokens2"])).to(self.device)
                scores, tags = self.tagger.decode(x, lengths, threshold, x2=x2)
            else:
                scores, tags = self.tagger.decode(x, lengths, threshold)
        return scores.cpu().numpy(), tags.cpu().numpy()

    # -- test -------------------------------------------------------------------
    def test(self, params, test_batches: List[dict]):
        """Per-document decode + metrics -> (the reference's results dict,
        per-document results, per-document scores)."""
        if self.zero_baseline:
            threshold = 0.4  # the reference hardcodes it for the never-predict baseline
        else:
            threshold = self.threshold if self.threshold is not None else 0.4
            if not threshold:
                threshold = 0.5
        self._load(params)

        per_doc, all_scores = [], []
        for batch in test_batches:
            if self.zero_baseline:
                scores_np = np.zeros(np.asarray(batch["src_tokens"]).shape[:2], np.float32)
                tags_np = np.zeros(scores_np.shape, bool)
            else:
                scores_np, tags_np = self._decode(batch, threshold)
            for i in range(batch.get("n_real", len(batch["src_lengths"]))):
                L = int(batch["src_lengths"][i])
                tag = tags_np[i][:L].astype(int).tolist()
                target = np.asarray(batch["tgt_tokens"][i][:L]).astype(int).tolist()
                if self.eb:
                    tag[-1] = 0
                    target[-1] = 0
                # the reference tests with batch size 1, so each dict of its
                # results is one DOCUMENT's own metrics
                if self.metric.lower() == "b":
                    p, r, f1, b = M.b_measure(tag, target)
                    doc = {"b_precision": p, "b_recall": r, "b_f1": f1,
                           "threshold": threshold, "test_loss": b}
                elif self.metric.lower() == "scaiano":
                    p, r, f1 = M.win_pr(tag, target)
                    doc = {"b_precision": p, "b_recall": r,
                           "threshold": threshold, "test_loss": f1}
                else:
                    pk = M.compute_Pk(tag, target)
                    f1 = M.boundary_f1(target, tag)
                    try:
                        wd = M.compute_window_diff(tag, target)
                    except AssertionError:
                        wd = pk
                    doc = {"Pk_loss": pk, "F1_loss": f1, "WD_loss": wd, "threshold": threshold}
                    if self.metric == "F1":
                        doc["test_loss"] = doc.pop("F1_loss")
                    elif self.metric == "WD":
                        doc["test_loss"] = doc.pop("WD_loss")
                    else:
                        doc["test_loss"] = doc.pop("Pk_loss")
                per_doc.append(doc)

                # the stored scores are what the decode consumed: raw head
                # logits, [L] for the sigmoid heads, [L, C] for CrossEntropy;
                # a CRF's one Viterbi score per document
                if scores_np.ndim == 3:
                    doc_scores = scores_np[i][:L] if scores_np.shape[-1] > 1 else scores_np[i][:L, 0]
                elif scores_np.ndim == 2:
                    doc_scores = scores_np[i][:L]
                else:
                    doc_scores = scores_np[i]
                all_scores.append(np.atleast_1d(np.asarray(doc_scores, np.float64)))

        # corpus aggregate = mean over documents
        results = {k: float(np.mean([d[k] for d in per_doc])) for k in per_doc[0]}
        results["threshold"] = threshold
        return results, per_doc, all_scores

    def search_threshold(self, params, valid_batches: List[dict]):
        """Search the decode threshold on validation documents over the
        reference's candidate grid {.05, .1, .2, .3, .4, .5, .6}, scored on
        the monitored metric -> (best threshold, its value)."""
        candidates = [0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
        self._load(params)
        docs = []
        for batch in valid_batches:
            scores, _ = self._decode(batch, 0.5)
            if scores.ndim == 1:
                # a CRF's one Viterbi score per document: no threshold to
                # search, the reference default stays
                return 0.5, float("nan")
            for i in range(batch.get("n_real", len(batch["src_lengths"]))):
                L = int(batch["src_lengths"][i])
                s = scores[i][:L]  # [L, C] head logits (C = 1 for the sigmoid heads)
                t = np.asarray(batch["tgt_tokens"][i][:L]).astype(int)
                # probabilities exactly as head_decode thresholds them
                if self.cfg.loss_fn == "CrossEntropy" and s.shape[-1] > 1:
                    e = np.exp(s - s.max(-1, keepdims=True))
                    prob = e[..., 1] / e.sum(-1)
                else:
                    prob = 1.0 / (1.0 + np.exp(-s[..., 0]))
                docs.append((prob, t))

        # Pk and WD minimise; F1, B-similarity and WinPR-F1 maximise
        minimize = self.metric in ("Pk", "WD")
        best_th, best_val = 0.5, float("inf") if minimize else -float("inf")
        for th in candidates:
            vals = []
            for prob, t in docs:
                pred = (prob > th).astype(int)
                if self.metric == "F1":
                    vals.append(M.boundary_f1(t.tolist(), pred.tolist()))
                elif self.metric == "WD":
                    try:
                        vals.append(M.compute_window_diff(pred.tolist(), t.tolist()))
                    except AssertionError:
                        vals.append(M.compute_Pk(pred.tolist(), t.tolist()))
                elif self.metric.lower() == "b":
                    vals.append(M.b_measure(pred.tolist(), t.tolist())[3])
                elif self.metric.lower() == "scaiano":
                    vals.append(M.win_pr(pred.tolist(), t.tolist())[2])
                else:
                    vals.append(M.compute_Pk(pred.tolist(), t.tolist()))
            v = float(np.mean(vals)) if vals else (1.0 if minimize else 0.0)
            if (minimize and v < best_val) or (not minimize and v > best_val):
                best_val, best_th = v, th
        return best_th, best_val

    def predict(self, params, batches: List[dict], threshold: float = 0.5):
        """Raw tag lists per document (the reference's predict_step)."""
        self._load(params)
        out = []
        for batch in batches:
            _, tags_np = self._decode(batch, threshold)
            for i in range(batch.get("n_real", len(batch["src_lengths"]))):
                L = int(batch["src_lengths"][i])
                out.append(tags_np[i][:L].astype(int).tolist())
        return out
