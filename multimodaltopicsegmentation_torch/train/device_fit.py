"""Device-resident fit: whole epoch WINDOWS with every decision made on the
device (counterpart of the JAX package's train/device_fit.py).

The host epoch loop (train/loop.py `Trainer.fit`) pulls each epoch's losses
to the host, because the plateau rate, the early stop and the top-1 snapshot
are decided there. Here the host only enqueues: a window of K epochs runs the
tagger's own train step over the batches, keeps the decisions in a carry of
0-d device tensors updated with `torch.where` (no `.item()`, no `.tolist()`),
and reads back once per window, one packed float32 vector

    [K*NB train losses | K*NV val losses | K stop flags | K ran flags]

split again by `unpack_window`. Torch has no `lax.scan`: the window is a host
loop that enqueues device work, and the learning rate is the optimizer's own
device tensor (`loop.Optimizer.lr_t`), which the plateau step rewrites in
place.

Semantics, decision for decision those of the host loop:

- monitored = the training loss, or the validation loss weighted by each
  batch's documents; a non-finite value counts as +inf, and a checkpoint
  name then carries NAN_FNAME;
- improvement: strictly below the best, and the first epoch always improves;
- early stop: `(not improved) and bad >= patience`; the stopping epoch skips
  the scheduler step, like the host loop's `break`;
- plateau: torch ReduceLROnPlateau(min, factor 0.8, patience 10, relative
  threshold 1e-4).

The decisions are computed in float64 on the device, as the host loop
computes them in Python floats from the same float32 losses.

Epochs after a stop inside a window (the device knows of the stop, the host
does not) still run, and are masked: their parameters, optimizer moments and
carry are put back with `torch.where`. The host knows that no stop can come
before epoch max(patience, 1), so it masks only the epochs after that one:
the cost is one copy and one select of the optimizer's tensors (parameters
and two moments) per such epoch, plus the compute of at most K - 1 wasted
epochs once per fit. The optimizer's host step counts and the dropout
generator, which a masked epoch moves on, are set back by the caller from the
marks the window returns (`Trainer._fit_device_epochs`).

The window takes the host loop's own device batches (`loop.batches_to_device`),
ragged ones included, and runs any tagger's train step, the flash-attention
kernels included.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

SCHED_FACTOR = 0.8
SCHED_PATIENCE = 10
SCHED_RTOL = 1e-4
NAN_FNAME = 9999.9999  # the host loop's file-name stand-in for a non-finite loss


def init_carry(params: List[torch.Tensor], lr_t: torch.Tensor) -> dict:
    """The window carry: 0-d device tensors and the best parameters. `lr` is
    the optimizer's own rate tensor. `best_params` starts as a copy of the
    parameters; epoch 0 always overwrites it."""
    dev = lr_t.device
    f64 = dict(dtype=torch.float64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    return {
        "lr": lr_t,
        "sched_best": torch.full((), math.inf, **f64),
        "sched_bad": torch.zeros((), **i64),
        "best": torch.full((), math.inf, **f64),
        "bad": torch.zeros((), **i64),
        "stopped": torch.zeros((), dtype=torch.bool, device=dev),
        "best_params": [p.detach().clone() for p in params],
        "best_epoch": torch.zeros((), **i64),
        "best_fname": torch.full((), NAN_FNAME, **f64),
    }


def make_fit_window(trainer, *, window: int, val_weights: Optional[list], monitor_train: bool,
                    patience: int, no_early_stop: bool):
    """-> fit_window(carry, epoch0, max_epochs, train_batches, valid_batches)
    -> (packed, marks). It enqueues epochs epoch0 .. epoch0 + window - 1 of
    `trainer`'s own `_train_step` / `_eval_loss` over the batches (device
    dicts), updates `carry` in place and returns the packed float32 vector
    (not yet read) and, per epoch, the host marks (dropout generator state,
    optimizer step counts) taken at its end. Epochs at or past `max_epochs`
    are not enqueued: they report NaN losses and ran = 0."""
    first_stop = max(patience, 1)  # the earliest epoch that can stop
    # made here, outside any window: a copy from the host waits for the card
    w = torch.tensor(val_weights, dtype=torch.float64, device=trainer.device) \
        if val_weights else None

    def fit_window(carry, epoch0: int, max_epochs: int, train_batches, valid_batches):
        params = list(trainer.tagger.parameters())
        dev = carry["lr"].device
        nb, nv = len(train_batches), len(valid_batches)
        nan = torch.full((nb + nv,), math.nan, dtype=torch.float32, device=dev)
        no = torch.zeros((), dtype=torch.bool, device=dev)
        pieces, marks = [], []
        for epoch in range(epoch0, epoch0 + window):
            if epoch >= max_epochs:
                pieces.append((nan[:nb], nan[nb:], no, no))
                continue
            masked = not no_early_stop and epoch > first_stop
            ran = ~carry["stopped"] if masked else None
            if masked:
                state = trainer.opt.state_tensors()
                with torch.no_grad():
                    before = [t.clone() for t in state]
            tr = torch.stack([trainer._train_step(b) for b in train_batches])
            marks.append((trainer.generator.get_state(), trainer.opt.host_steps()))
            if nv:
                val = torch.stack([trainer._eval_loss(b) for b in valid_batches])
            with torch.no_grad():
                stop, ran = _decide(carry, epoch, tr, val if nv else None, w, params,
                                    monitor_train, patience, no_early_stop, ran)
                if masked:
                    for t, t0 in zip(state, before):
                        t.copy_(torch.where(ran, t, t0))
                    tr = torch.where(ran, tr, math.nan)
                    val = torch.where(ran, val, math.nan) if nv else tr[:0]
                carry["stopped"] = carry["stopped"] | stop
            pieces.append((tr, val if nv else tr[:0], stop, ~no if ran is None else ran))
        packed = torch.cat([torch.cat([p[0] for p in pieces]), torch.cat([p[1] for p in pieces]),
                            torch.stack([p[2] for p in pieces]).float(),
                            torch.stack([p[3] for p in pieces]).float()])
        return packed, marks

    return fit_window


def _decide(carry, epoch, tr, val, w, params, monitor_train, patience, no_early_stop, ran):
    """One epoch's decisions on the carry (in place but for `stopped`), in
    float64 -> (stop, ran). `ran` is None where the epoch surely runs, else
    the device flag of an epoch that may come after a stop: where it is
    false, the carry stays as it was."""
    train_loss = tr.double().mean()
    monitored = train_loss if (monitor_train or val is None) else (val.double() * w).sum() / w.sum()
    monitored = torch.where(torch.isfinite(monitored), monitored, math.inf)

    # top-1 snapshot (host: `monitored < best or first epoch`)
    improved = monitored < carry["best"]
    if epoch == 0:
        improved = torch.ones_like(improved)
    if ran is not None:
        improved = improved & ran
    carry["best"] = torch.where(improved, monitored, carry["best"])
    bad = torch.where(improved, 0, carry["bad"] + 1)
    carry["bad"] = bad if ran is None else torch.where(ran, bad, carry["bad"])
    for b, p in zip(carry["best_params"], params):
        b.copy_(torch.where(improved, p, b))
    carry["best_epoch"] = torch.where(improved, epoch, carry["best_epoch"])
    fname = torch.where(torch.isfinite(monitored), monitored, NAN_FNAME)
    carry["best_fname"] = torch.where(improved, fname, carry["best_fname"])
    if no_early_stop:
        stop = torch.zeros_like(improved)
    else:
        stop = (~improved) & (carry["bad"] >= patience)
    if ran is not None:
        stop = stop & ran

    # plateau scheduler, skipped on the stopping epoch (and on a masked one)
    s_improved = monitored < carry["sched_best"] * (1 - SCHED_RTOL)
    s_best = torch.where(s_improved, monitored, carry["sched_best"])
    s_bad = torch.where(s_improved, 0, carry["sched_bad"] + 1)
    drop = s_bad > SCHED_PATIENCE
    lr = torch.where(drop, carry["lr"] * SCHED_FACTOR, carry["lr"])
    s_bad = torch.where(drop, 0, s_bad)
    hold = stop if ran is None else stop | ~ran
    carry["sched_best"] = torch.where(hold, carry["sched_best"], s_best)
    carry["sched_bad"] = torch.where(hold, carry["sched_bad"], s_bad)
    carry["lr"].copy_(torch.where(hold, carry["lr"], lr))
    return stop, ran


def unpack_window(packed, window: int, nb: int, nv: int):
    """Split the single pulled float32 vector back into per-epoch pieces.
    -> (train_losses [K, NB], val_losses [K, NV], stop [K], ran [K])."""
    packed = np.asarray(packed)
    tr = packed[: window * nb].reshape(window, nb)
    val = packed[window * nb: window * (nb + nv)].reshape(window, nv)
    stops = packed[window * (nb + nv): window * (nb + nv + 1)] > 0.5
    ran = packed[window * (nb + nv + 1):] > 0.5
    return tr, val, stops, ran
