"""Hyperparameter-grid training of one architecture over dropout rates
(counterpart of the JAX package's train/grid.py).

On the paper's grids only the dropout rates vary (hidden units and layer
counts are singletons, e.g. RadioNews-SBBC/run_radionews_unimodal.sh: `-huss
256 -nlss 2 -diss 0 0.2 0.5 -doss 0 0.2 0.5`). The JAX package trains such a
grid as one program vmapped over the configurations. The contract is JAX's:
configuration g equals a serial `Trainer` run of g with the same seed.

The port runs each configuration's own `Trainer.fit`, one after another, in
its configuration directory. The port's dropout draws from a stateful
generator and a rate-0 site draws nothing, so one generator shared by the
configurations (or a `vmap` over them) cannot reproduce the serial runs;
and stepping nine Trainers in lockstep was slower than nine serial fits on
one H100 (the cuDNN LSTM's step is bound by the host's launches, which one
Python thread makes either way; PERF.md section 6). A lockstep form
comes back only with a design that runs faster, such as one CUDA graph or
one LSTM launch over the configurations.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

from ..core.torch_setup import resolve_device
from ..models.base import TaggerConfig
from .loop import Trainer


class GridTrainer:
    """Train G (dropout_in, dropout_out) configurations of one architecture.
    Produces, per configuration, what a serial `Trainer` does: a history and
    a best-checkpoint path, in a configuration directory of `check_dir`."""

    # architectures whose parameter shapes do not depend on the dropout
    # rates; SimpleBiLSTM has no dropout (the reference's class has none
    # either), so its grid trains identical configurations, as serially
    SUPPORTED = ("BiLSTM", "BiLSTMLateFusion", "SimpleBiLSTM")

    def __init__(
        self,
        architecture: str,
        cfg: TaggerConfig,
        grid: List[Tuple[float, float]],
        lr: float = 1e-3,
        optimizer: str = "Adam",
        max_epochs: int = 100,
        patience: int = 20,
        no_early_stop: bool = False,
        monitor: str = "val_loss",
        check_dir: str = "checkpoints",
        seed: int = 42,
        gradient_clipping: float = 0.0,
        detect_anomaly: Optional[bool] = None,
        tag: str = "",
        mesh=None,
        device="cuda",
    ):
        if architecture not in self.SUPPORTED:
            raise ValueError(
                f"grid training supports {self.SUPPORTED}, not {architecture!r}")
        if mesh is not None:
            raise NotImplementedError(
                "GridTrainer(mesh=...) is not ported yet: ROADMAP.md section 1 item 14")
        self.device = resolve_device(device)
        self.arch_name = architecture
        self.cfg = cfg
        self.grid = [(float(d), float(o)) for d, o in grid]
        self.max_epochs = max_epochs
        self.check_dir = check_dir
        self.tag = tag
        if detect_anomaly is None:
            detect_anomaly = os.environ.get("MTS_DETECT_ANOMALY", "1") != "0"
        self.trainers = [
            Trainer(architecture, self._cfg_for(g), lr=lr, optimizer=optimizer,
                    max_epochs=max_epochs, patience=patience, no_early_stop=no_early_stop,
                    monitor=monitor, check_dir=self._config_dir(g), seed=seed,
                    gradient_clipping=gradient_clipping, detect_anomaly=detect_anomaly,
                    device=self.device)
            for g in range(len(self.grid))]
        self.best_model_paths: List[Optional[str]] = [None] * len(self.grid)
        self.histories: List[list] = [[] for _ in self.grid]
        # configuration g's parameters at its early stop (a serial run ends there)
        self._stop_params: List[Optional[dict]] = [None] * len(self.grid)

    def _config_dir(self, g: int) -> str:
        # `tag` keeps runs that share one check_dir apart (train_fit's folds)
        din, dout = self.grid[g]
        tag = f"{self.tag}_" if self.tag else ""
        return os.path.join(self.check_dir, f"grid_{tag}di{din:g}_do{dout:g}")

    def _cfg_for(self, g: int) -> TaggerConfig:
        din, dout = self.grid[g]
        return dataclasses.replace(self.cfg, dropout_in=din, dropout_out=dout)

    def fit(self, train_batches: List[dict], valid_batches: Optional[List[dict]] = None):
        """-> (final parameters per configuration, histories per
        configuration); each configuration's top-1 snapshot is written to
        `best_model_paths[g]` when its fit ends, however it ends."""
        for g, t in enumerate(self.trainers):
            try:
                params, self.histories[g] = t.fit(train_batches, valid_batches)
            finally:
                self.best_model_paths[g] = t.best_model_path
            if len(self.histories[g]) < self.max_epochs:
                self._stop_params[g] = params  # stopped early
        return [self.final_params(g) for g in range(len(self.grid))], self.histories

    def final_params(self, g: int):
        """Configuration g's final parameters: those of its own early stop if
        it stopped, else those after max_epochs."""
        if self._stop_params[g] is not None:
            return self._stop_params[g]
        return self.trainers[g].params

    def save_final(self, g: int) -> str:
        """The -s_last / no_validation artefact of configuration g."""
        self.best_model_paths[g] = self.trainers[g].save_final(self.final_params(g))
        return self.best_model_paths[g]
