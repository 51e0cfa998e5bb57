"""predict_audio_wavlm: `predict_audio` (drivers/predict_audio.py) with WavLM
as `predict -ee --wav2vec`'s encoder, as a local microsoft/wavlm-large
checkpoint makes it: the same program calls in the same order over the same
documents. Four things differ, and only these: the encoder's config
(`feat_extract_norm="layer"`, pre-LN layers, the gated relative position
bias), its weights (`mtsbench/wavlm.py`), its model FLOPs (the gate's
products counted) and the check's plain reference (`reference/wavlm.py`).
K1 does not run (no group norm), so no K1 work is recorded.
"""
from __future__ import annotations

import torch

from mtsbench import roofline, weights, wavlm
from mtsbench.harness import SR, Run, tagger_config
from mtsbench.spec import driver

Base = driver("predict_audio")


class Driver(Base):
    def port_encoder_config(self):
        from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W

        c = self.config["encoder"]
        return W.Wav2Vec2Config(
            conv_dim=tuple(c["conv_dim"]), conv_kernel=tuple(c["conv_kernel"]),
            conv_stride=tuple(c["conv_stride"]), num_groupnorm_groups=c["conv_dim"][0],
            hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
            num_heads=c["num_attention_heads"], ffn_dim=c["intermediate_size"],
            pos_conv_kernel=c["num_conv_pos_embeddings"],
            pos_conv_groups=c["num_conv_pos_embedding_groups"],
            layer_norm_eps=c["layer_norm_eps"], do_normalize=c["do_normalize"],
            feat_extract_norm=c["feat_extract_norm"],
            do_stable_layer_norm=c["do_stable_layer_norm"], conv_bias=c["conv_bias"],
            num_buckets=c["num_buckets"], max_bucket_distance=c["max_bucket_distance"])

    def setup(self):
        from multimodaltopicsegmentation_torch.cli.predict import BasePredictor
        from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
        from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
        from multimodaltopicsegmentation_torch.models import registry

        self.build_kernels(tuple(self.arch.kernels(False)))
        self.phase("kernels")
        cfg = self.port_encoder_config()
        # the encoder of `predict -ee --wav2vec`, around weights made here
        enc = Wav2Vec2Encoder.__new__(Wav2Vec2Encoder)
        enc.device, enc.cfg = self.device, cfg
        enc.model = W.build_model(cfg, wavlm.weights(self.config["encoder"], self.seed,
                                                     self.device), self.device)
        self.encoder = enc
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
        """The base's document, its model FLOPs WavLM's (`wavlm.unit_flops`)."""
        super().process(k, run)
        t, n, flops = run.completions[-1]
        enc = self.config["encoder"]
        run.completions[-1] = (t, n, flops + n * (wavlm.unit_flops(enc, SR)
                                                 - roofline.wav2vec2_unit_flops(enc, SR)))

    def record_work(self, run: Run, n: int, L: int, rows_L: int):
        """The tagger's own kernels over its padded batch (no K1 here)."""
        self.arch.record_work(run, [L], rows_L, self.tagger_cfg, False)

    def reference_answers(self, tf32: bool):
        """Answers of the plain reference (WavLM and the tagger) for what the
        check reads."""
        import numpy as np

        from reference import models as R
        from reference import taggers
        from reference import wavlm as RW

        enc = self.config["encoder"]
        sd = wavlm.weights(enc, self.seed, self.device)
        params = weights.tagger(self.tagger_cfg, self.seed, self.device)
        ref_tagger = taggers.load(self.tagger_cfg["architecture"])

        def pooled(k, unit_ids):
            audio = self.doc_audio(k)
            units = np.stack([audio[u * SR:(u + 1) * SR] for u in unit_ids])
            with R.precision(tf32):
                return RW.pooled_units(sd, enc, torch.from_numpy(units).to(self.device)).cpu().numpy()

        def logits(emb):
            with R.precision(tf32), torch.no_grad():
                x = torch.from_numpy(emb[None]).to(self.device)
                return ref_tagger.logits(params, x, [emb.shape[0]], self.tagger_cfg)[0].cpu().numpy()

        return pooled, logits
