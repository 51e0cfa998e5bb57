"""predict_embeddings: `predict -ef` as users run it over an extracted
corpus, `cli.predict.Predictor.predict(folder, exp,
write_audio_segments=False, batch_size=...)` back to back over a folder of
[n, d] `.npy` documents drawn from the seed.

The check: every logit and tag of every call the window finished against
the plain reference of the configuration's tagger, each document alone at
its own length.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from mtsbench import trace, traffic, weights
from mtsbench.harness import Run, tagger_config
from mtsbench.harness import Driver as Base


class Driver(Base):
    def write_corpus(self) -> str:
        """The mix's documents as [n, d] float32 `.npy` files, drawn on the
        device from the seed in one draw and written, each synced to the
        disk, into the run's own directory, where predict -ef reads them."""
        self.docs = traffic.documents(self.traffic["documents"],
                                      self.config.get("max_document_units"))
        folder = os.path.join(self.tmp, "emb")
        os.makedirs(folder)
        g = torch.Generator(device=self.device).manual_seed(traffic.sub_seed(self.seed, "corpus"))
        x = torch.randn(sum(n for _, n in self.docs), self.tagger_cfg["embedding_dim"], generator=g,
                        device=self.device).cpu().numpy()
        start = 0
        for doc_id, n in self.docs:
            with open(os.path.join(folder, f"{doc_id}.npy"), "wb") as f:
                np.save(f, x[start:start + n])
                f.flush()
                os.fsync(f.fileno())  # no write-back of the corpus inside the window
            start += n
        return folder

    def prepare_inputs(self):
        self.folder = self.write_corpus()
        self.names = sorted(f"{d}.npy" for d, _ in self.docs)
        self.units = {f"{d}.npy": n for d, n in self.docs}
        self.calls: List[dict] = []

    def setup(self):
        from multimodaltopicsegmentation_torch.cli.predict import Predictor
        from multimodaltopicsegmentation_torch.train import checkpoints

        self.build_kernels(self.arch.kernels(False))
        self.phase("kernels")
        self.prepare_inputs()
        self.phase("inputs")
        params = weights.to_numpy(weights.tagger(self.tagger_cfg, self.seed, self.device))
        ckpt = os.path.join(self.tmp, "model.ckpt")
        checkpoints.save(ckpt, params, tagger_config(self.tagger_cfg),
                         self.tagger_cfg["architecture"])
        hyp = os.path.join(self.tmp, "results.txt")
        with open(hyp, "w") as f:
            f.write(f"Sentence encoder: {self.traffic['encoder']}\n"
                    f"Neural architecture: {self.tagger_cfg['architecture']}\n")
        self.predictor = Predictor(hyp, ckpt, threshold=self.traffic["threshold"],
                                   device=self.device)
        self._wrap_decode()
        self.n_calls = 0
        self.run = None
        self.phase("weights")
        self.call()  # every chunk shape of the corpus, once
        self.calls.clear()
        self.phase("warm-up")

    def _wrap_decode(self):
        """A span around the tagger's decode, ended by copying its logits to
        the host (which the predict loop's own copy of the tags waits for
        anyway), and the launches' work."""
        arch = self.predictor.arch
        decode = arch.decode

        def timed_decode(x, lengths, threshold, **kw):
            t = time.perf_counter()
            with trace.span("decode", self.run is not None and self.run.traced):
                logits, tags = decode(x, lengths, threshold, **kw)
                ln = lengths.cpu().numpy()
                host = logits[..., 0].cpu().numpy()
            call = self.calls[-1]
            call["logits"] += [host[b, :n] for b, n in enumerate(ln)]
            if self.run is not None:
                self.run.add_span("decode", time.perf_counter() - t, int(ln.sum()))
                self.arch.record_work(self.run, ln, x.shape[1], self.tagger_cfg, False)
            return logits, tags

        arch.decode = timed_decode

    def call(self):
        self.calls.append({"logits": []})
        exp = os.path.join(self.tmp, f"exp{self.n_calls}")
        self.n_calls += 1
        results = self.predictor.predict(self.folder, exp, write_audio_segments=False,
                                         batch_size=self.traffic["batch_size"])
        self.calls[-1]["tags"] = results
        shutil.rmtree(exp, ignore_errors=True)

    def window(self, run: Run):
        self.run = run
        lengths = [self.units[name] for name in self.names]
        flops = self.arch.flops(lengths, self.tagger_cfg, False)
        while time.perf_counter() - run.t0 < run.seconds:
            run.attempted += len(self.names)
            self.call()
            run.completions.append((time.perf_counter(), sum(lengths), flops))
        self.run = None

    def free_program(self):
        self.__dict__.pop("predictor", None)

    def check(self, run: Run, control: bool, fault: Optional[str] = None) -> List[tuple]:
        from reference import models as R
        from reference import taggers

        limits = self.cell.limits
        tc = self.tagger_cfg
        params = weights.tagger(tc, self.seed, self.device)
        ref_tagger = taggers.load(tc["architecture"])

        def logits_of(tf32):
            out = []
            with R.precision(tf32), torch.no_grad():
                for name in self.names:
                    n = self.units[name]
                    x = torch.from_numpy(np.load(os.path.join(self.folder, name))).to(self.device)
                    out.append(ref_tagger.logits(params, x[None, :n], [n], tc)[0].cpu().numpy())
            return out

        ref = logits_of(False)
        calls = [{"logits": logits_of(True)}] if control else self.calls
        if control:
            calls[0]["tags"] = [(z > 0).astype(int).tolist() for z in calls[0]["logits"]]
        if not calls:
            return [("calls_done", 0.0, -1.0)]
        margin = limits["logit_gap"]
        gap, flips = 0.0, 0
        for c in calls:
            if len(c["logits"]) != len(ref) or len(c["tags"]) != len(ref):
                flips += len(ref)
                continue
            for got, tags, want in zip(c["logits"], c["tags"], ref):
                if got.shape != want.shape or len(tags) != len(want):
                    flips += len(want)
                    continue
                gap = max(gap, float(np.abs(got - want).max()))
                flips += int(np.sum((np.abs(want) > margin) & (np.asarray(tags) != (want > 0))))
        return [("logit_gap", gap, limits["logit_gap"]),
                ("tag_flips", float(flips), limits["tag_flips"])]
