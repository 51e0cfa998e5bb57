"""train: `train.loop.Trainer.fit` as the train CLI runs it, over batches
that `train.data.batches` makes from a corpus drawn from the seed (the
train CLI's padding for the configuration's tagger). The window calls
`fit` back to back, each fit of the mix's `epochs_per_fit` epochs with its
validation, and counts the epochs that `fit`'s returned history holds.

Set-up builds the one Trainer the window uses and drives it from the seed
through its first steps: a fit over the first k training batches for each
k up to the mix's `check_steps` (every fit starts again from the seed, so
these are the first k steps of every fit the window makes), then a fit of
one epoch over all of them, which runs every shape of the window once.

The check: against the plain reference in float64 (its own round-off in
float32 can reach 3e-4 of a leaf's gradient through the recurrence on some
seeds, where the program agrees with float64 to 1e-7), the mean training
loss after each of the first steps, the validation loss after each, the
first gradient as Adam holds it (its first moment after one step over 1 -
beta1), and the parameters' change over those steps, by leaf.
"""
from __future__ import annotations

import os
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

from mtsbench import traffic, weights
from mtsbench.harness import Run, sync, tagger_config
from mtsbench.harness import Driver as Base

BETA1 = 0.9  # Adam's first moment after one step is (1 - beta1) g


class Driver(Base):
    def prepare_inputs(self):
        from multimodaltopicsegmentation_torch.train.data import batches

        spec = self.traffic["documents"]
        cut = self.config.get("max_document_units")
        tc = self.tagger_cfg
        sets = {}
        g = torch.Generator(device=self.device).manual_seed(traffic.sub_seed(self.seed, "corpus"))
        r = traffic.rng(self.seed, "labels")
        for part in ("train", "valid"):
            docs = traffic.documents({**spec, **spec[part]}, cut)
            x = torch.randn(sum(n for _, n in docs), tc["embedding_dim"], generator=g,
                            device=self.device).cpu().numpy()
            starts = np.cumsum([0] + [n for _, n in docs])
            sets[part] = [(x[starts[i]:starts[i + 1]],
                           traffic.boundary_labels(n, self.traffic["boundary_every"], r),
                           f"{doc_id}.npy") for i, (doc_id, n) in enumerate(docs)]
        kw = self.arch.batch_kwargs(tc, cut)
        bs = self.traffic["batch_size"]
        self.train_batches = list(batches(sets["train"], min(bs, len(sets["train"])), **kw))
        self.valid_batches = list(batches(sets["valid"], min(bs, len(sets["valid"])), **kw))
        self.epoch_units = int(sum(int(np.sum(b["src_lengths"])) for b in self.train_batches))
        self.epoch_flops = sum(self.arch.flops([int(n) for n in b["src_lengths"]], tc, True)
                               for b in self.train_batches)
        self.trainer_seed = traffic.sub_seed(self.seed, "trainer")

    def setup(self):
        from multimodaltopicsegmentation_torch.train.loop import Trainer

        self.build_kernels(self.arch.kernels(True))
        self.phase("kernels")
        self.prepare_inputs()
        self.phase("inputs")
        tc = self.tagger_cfg
        self.trainer = Trainer(tc["architecture"], tagger_config(tc), lr=tc["lr"],
                               optimizer="Adam", max_epochs=1, patience=self.traffic["epochs_per_fit"],
                               no_early_stop=True, monitor="val_loss",
                               check_dir=os.path.join(self.tmp, "checkpoints"),
                               seed=self.trainer_seed, device=self.device)
        self.capture()
        self.trainer.max_epochs = self.traffic["epochs_per_fit"]
        self.phase("first steps")

    def capture(self):
        """The first steps, through the window's own call on its own batches,
        and one epoch over every batch."""
        trainer = self.trainer
        means, vals = [], []
        for k in range(1, self.traffic["check_steps"] + 1):
            params, history = trainer.fit(self.train_batches[:k], self.valid_batches)
            means.append(history[0]["training_loss"])
            vals.append(history[0]["val_loss"])
            if k == 1:  # an optimizer that kept no moment got no gradient
                grad1 = {n: trainer.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                         for n, p in trainer.tagger.named_parameters()}
                grad1 = {n: v.detach().cpu() for n, v in grad1.items()}
        self.captured = {"means": means, "val_losses": vals, "grad1": grad1,
                         "end": self._to_port_names(params)}
        trainer.fit(self.train_batches, self.valid_batches)
        sync(self.device)

    def window(self, run: Run):
        epochs_run = 0
        while time.perf_counter() - run.t0 < run.seconds:
            t = time.perf_counter()
            _, history = self.trainer.fit(self.train_batches, self.valid_batches)
            t_end = time.perf_counter()
            epochs = len(history)
            epochs_run += epochs
            run.attempted += 1
            run.completions.append((t_end, epochs * self.epoch_units, epochs * self.epoch_flops))
            if epochs:
                run.add_sample("epoch_ms", 1e3 * (t_end - t) / epochs)
        self.record_work(run, epochs_run)

    def record_work(self, run: Run, epochs: int):
        """The launches of the tagger's own kernels over `epochs` epochs: each
        training batch forward and backward, each validation batch forward."""
        tc = self.tagger_cfg
        for _ in range(epochs):
            for batches, train in ((self.train_batches, True), (self.valid_batches, False)):
                for b in batches:
                    L = np.asarray(b["src_tokens"]).shape[1]
                    self.arch.record_work(run, b["src_lengths"], L, tc, train)

    def free_program(self):
        self.__dict__.pop("trainer", None)

    def check(self, run: Run, control: bool, fault: Optional[str] = None) -> List[tuple]:
        from reference import models as R
        from reference import train as RT

        limits = self.cell.limits
        tc = self.tagger_cfg
        steps = self.traffic["check_steps"]
        init = RT.initial_params(tc, self.trainer_seed)
        batches, valid = self.train_batches[:steps], self.valid_batches
        ref = self._reference(RT.first_steps(tc, init, batches, valid, tc["lr"], self.device,
                                             dtype=torch.float64))
        if fault == "half_batch":
            got = self._reference(RT.first_steps(
                tc, init, batches, valid, tc["lr"], self.device,
                keep_rows=self.traffic["batch_size"] // 2, dtype=torch.float64))
        elif control:
            with R.precision(True):
                got = self._reference(RT.first_steps(tc, init, batches, valid, tc["lr"],
                                                     self.device))
        else:
            got = self.captured
        start = self._to_port_names(init)

        def worst_rel(a, b):
            if len(a) != len(b):
                return float("inf")
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        loss_gap = worst_rel(got["means"], ref["means"])
        val_gap = worst_rel(got["val_losses"], ref["val_losses"])
        norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
        g_ref = {n: norm(v) for n, v in ref["grad1"].items()}
        g_med = statistics.median(g_ref.values())
        grad = {n: abs(norm(got["grad1"][n]) - g_ref[n]) / max(g_ref[n], g_med) for n in g_ref}
        # leaves whose gradient is round-off in the reference (a key's bias under
        # softmax) move under Adam by round-off alone: left out of the change
        moving = [n for n in g_ref if g_ref[n] >= 1e-3 * g_med]
        d_ref = {n: norm(ref["end"][n] - start[n]) for n in moving}
        d_med = statistics.median(d_ref.values())
        change = {n: abs(norm(got["end"][n] - start[n]) - d_ref[n]) / max(d_ref[n], d_med)
                  for n in moving}
        grad_gap, change_gap = max(grad.values()), max(change.values())
        self.notes = {"grad_gap leaf": max(grad, key=grad.get),
                      "change_gap leaf": max(change, key=change.get),
                      "left out of the change": sorted(set(g_ref) - set(moving))}
        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("val_gap", val_gap, limits["val_gap"]),
                ("grad_gap", grad_gap, limits["grad_gap"]),
                ("change_gap", change_gap, limits["change_gap"])]

    def _reference(self, out: dict) -> dict:
        """The reference's first steps in the form the program's are captured:
        the mean loss after each step, leaves under the program's names."""
        losses = out["losses"]
        return {"means": [float(np.mean(losses[:k])) for k in range(1, len(losses) + 1)],
                "val_losses": out["val_losses"],
                "grad1": self._to_port_names(out["grad1"]),
                "end": self._to_port_names(out["end"])}

    def _to_port_names(self, tree: dict) -> dict:
        """JAX-layout leaves (a pytree, or flat under "a/0/b" paths) under the
        program's parameter names (the taggers' public `from_jax_params`: a
        relabelling and a transpose, which the norms compared do not see)."""
        from multimodaltopicsegmentation_torch.models import registry

        if not hasattr(self, "_port_class"):
            self._port_class = type(registry.build(self.tagger_cfg["architecture"],
                                                   tagger_config(self.tagger_cfg)))
        flat = all(not isinstance(v, (dict, list)) for v in tree.values())
        nested = weights.nest(tree) if flat else tree
        return {k: torch.as_tensor(v) for k, v in
                self._port_class.from_jax_params(weights.to_numpy(nested)).items()}
