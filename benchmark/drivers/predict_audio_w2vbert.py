"""predict_audio_w2vbert: `predict_audio` (drivers/predict_audio.py) with
w2v-BERT 2.0 as `predict -ee --wav2vec`'s encoder, as a local
facebook/w2v-bert-2.0 checkpoint (`model_type` "wav2vec2-bert") makes it: the
same program calls in the same order over the same documents. Four things
differ, and only these: the encoder's config (the configuration's `encoder`
block, read by the program's `W2VBertConfig.from_hf` as a config.json), its
weights (`mtsbench/w2v_bert.py`, read by the program's
`load_hf_state_dict`), its model FLOPs (`w2v_bert.unit_flops`) and the
check's plain reference (`reference/w2v_bert.py`). There is no conv stack, so
no K1 work is recorded.
"""
from __future__ import annotations

import types
from unittest import mock

import torch

from mtsbench import w2v_bert, weights
from mtsbench.harness import SR, Run, tagger_config
from mtsbench.spec import driver

Base = driver("predict_audio")


class Driver(Base):
    def port_encoder_config(self):
        from multimodaltopicsegmentation_torch.encoders import w2v_bert as B

        return B.W2VBertConfig.from_hf(self.config["encoder"])

    def setup(self):
        # first, so that a program without w2v-BERT stops here, at once
        from multimodaltopicsegmentation_torch.encoders import w2v_bert as B
        from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
        from multimodaltopicsegmentation_torch.cli.predict import BasePredictor
        from multimodaltopicsegmentation_torch.models import registry

        cfg = self.port_encoder_config()
        self.build_kernels(tuple(self.arch.kernels(False)))
        self.phase("kernels")
        # the encoder of `predict -ee --wav2vec`, around weights made here in
        # the checkpoint's names and shapes
        state = B.load_hf_state_dict(w2v_bert.weights(self.config["encoder"], self.seed,
                                                      self.device), cfg)
        self.encoder = Wav2Vec2Encoder.from_state(cfg, state, self.device)
        name = self.tagger_cfg["architecture"]
        tagger = registry.build(name, tagger_config(self.tagger_cfg))
        params = weights.to_numpy(weights.tagger(self.tagger_cfg, self.seed, self.device))
        tagger.load_state_dict(type(tagger).from_jax_params(params))
        self.tagger = tagger.to(self.device).eval()
        self.crf = registry.is_crf(name)
        self.segmenter = BasePredictor()
        self.segmenter.sr, self.segmenter.adapt = SR, False
        self.segmenter.interval = self.traffic["interval_s"]
        self.phase("weights")
        self.prepare_inputs()
        self.phase("inputs")
        self.warm_up()
        self.phase("warm-up")

    def process(self, k: int, run: Run):
        """The base's document, its model FLOPs w2v-BERT's: the base counts a
        unit as wav2vec2 from a conv stack this model has not, so for the call
        its module reads `w2v_bert.unit_flops` under that name."""
        enc = self.config["encoder"]
        counts = types.SimpleNamespace(
            wav2vec2_unit_flops=lambda _cfg, samples: w2v_bert.unit_flops(enc, samples))
        with mock.patch.dict(Base.process.__globals__, roofline=counts):
            super().process(k, run)

    def record_work(self, run: Run, n: int, L: int, rows_L: int):
        """The tagger's own kernels over its padded batch (no K1 here)."""
        self.arch.record_work(run, [L], rows_L, self.tagger_cfg, False)

    def reference_answers(self, tf32: bool):
        """Answers of the plain reference (w2v-BERT 2.0 and the tagger) for
        what the check reads."""
        import numpy as np

        from reference import models as R
        from reference import taggers
        from reference import w2v_bert as RB

        enc = self.config["encoder"]
        sd = w2v_bert.weights(enc, self.seed, self.device)
        params = weights.tagger(self.tagger_cfg, self.seed, self.device)
        ref_tagger = taggers.load(self.tagger_cfg["architecture"])

        def pooled(k, unit_ids):
            audio = self.doc_audio(k)
            units = np.stack([audio[u * SR:(u + 1) * SR] for u in unit_ids])
            return RB.pooled_units(sd, enc, torch.from_numpy(units).to(self.device),
                                   tf32=tf32).cpu().numpy()

        def logits(emb):
            with R.precision(tf32), torch.no_grad():
                x = torch.from_numpy(emb[None]).to(self.device)
                return ref_tagger.logits(params, x, [emb.shape[0]], self.tagger_cfg)[0].cpu().numpy()

        return pooled, logits
