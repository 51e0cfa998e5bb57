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

Not ported yet (the constructor raises): `mesh`, `pipeline_stages`,
`sequence_shards`, `expert_parallel` (ROADMAP.md section 1 item 14) and
`device_epochs` (item 13).
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
from . import checkpoints as ckpt_lib


def make_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    """Adam with eps 1e-7, or ("SGD") SGD with momentum .9 and weight decay
    1e-4 (added to the gradient), as the reference has them."""
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=1e-4)
    return torch.optim.Adam(params, lr=lr, eps=1e-7)


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
    (the domain flags and the second modality too, where a batch has them)."""
    out = []
    for batch in batches:
        db = dict(batch)
        for key in _DEVICE_KEYS:
            if key in batch:
                db[key] = torch.as_tensor(np.asarray(batch[key])).to(device)
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
            ("device_epochs", bool(device_epochs), 13),
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
        for group in self.opt.param_groups:
            group["lr"] = lr

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

    # -- fit --------------------------------------------------------------------
    def fit(self, train_batches: List[dict], valid_batches: Optional[List[dict]] = None):
        """-> (final params, history). The top-1 snapshot is written to
        `best_model_path` when the loop ends, however it ends."""
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
