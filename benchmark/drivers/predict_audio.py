"""predict_audio: `predict -ee -bs 1` without its file writes, one document
at a time, through the program's own calls in the CLI's order:
`dsp.unitize.inference_uniform_units`,
`encoders.engine.Wav2Vec2Encoder.encode_document`, the `_mean` pooling of
`cli/extract_embeddings.write_frame_level` by `ops.pooling.pool` on the
device, `train.data.pad_batch` and the tagger's `decode`, and
`cli.predict.BasePredictor.segment_audio(mock_audio=...)`.

The check: the pooled embeddings of every unit of one finished document
drawn from the seed and of a seeded sample of units over all finished ones,
that document's logits (its first `max_tagged_units`), tags and segments,
against the plain reference (wav2vec2 and the configuration's tagger).
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from mtsbench import roofline, trace, traffic, weights
from mtsbench.harness import SR, Run, gap_rel, sync, tagger_config
from mtsbench.harness import Driver as Base

K1 = "instance_norm_gelu.instance_norm_gelu"


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
            layer_norm_eps=c["layer_norm_eps"], do_normalize=c["do_normalize"])

    def prepare_inputs(self):
        """The documents (fixed lengths, in the mix's order) as views of one
        audio buffer drawn on the device from the seed, at seed-drawn offsets."""
        self.docs = traffic.documents(self.traffic["documents"])
        self.outputs: List[dict] = []
        longest = max(n for _, n in self.docs)
        n_buf = (longest + 2) * SR
        g = torch.Generator(device=self.device).manual_seed(traffic.sub_seed(self.seed, "audio"))
        self.audio = torch.randn(n_buf, generator=g, device=self.device).cpu().numpy()
        r = traffic.rng(self.seed, "offsets")
        self.offsets = [int(r.integers(0, n_buf - n * SR - SR // 2 + 1)) for _, n in self.docs]
        # a fraction of a second past the last whole unit, as real audio has
        self.samples = [n * SR + SR // 2 for _, n in self.docs]

    def doc_audio(self, k: int) -> np.ndarray:
        i = k % len(self.docs)
        return self.audio[self.offsets[i]:self.offsets[i] + self.samples[i]]

    def setup(self):
        from multimodaltopicsegmentation_torch.cli.predict import BasePredictor
        from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
        from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
        from multimodaltopicsegmentation_torch.models import registry

        self.build_kernels(("instance_norm_gelu",) + tuple(self.arch.kernels(False)))
        self.phase("kernels")
        cfg = self.port_encoder_config()
        # the encoder of `predict -ee --wav2vec`, around weights made here
        # (Wav2Vec2Encoder.__init__ loads them from a checkpoint instead)
        enc = Wav2Vec2Encoder.__new__(Wav2Vec2Encoder)
        enc.device, enc.cfg = self.device, cfg
        enc.model = W.build_model(cfg, weights.wav2vec2(self.config["encoder"], self.seed,
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

    def warm_up(self):
        """The encoder's chunk shapes (256 rows and each tail the documents
        leave) and the tagger's bucket lengths, once each."""
        from multimodaltopicsegmentation_torch.train.data import bucket_length

        chunk = self.traffic["encode_chunk"]
        rows = {chunk}
        for _, n in self.docs:
            if n % chunk:
                rows.add(min(chunk, 32 * -(-(n % chunk) // 32)))
        for r in sorted(rows):
            a = self.audio[: r * SR]
            self.encoder.encode_document(a, [(i * SR, (i + 1) * SR) for i in range(r)])
        dim = self.tagger_cfg["embedding_dim"]
        cut = self.traffic["max_tagged_units"]
        for L in sorted({bucket_length(min(n, cut)) for _, n in self.docs}):
            x = torch.zeros(1, L, dim, device=self.device)
            with torch.inference_mode():
                self.tagger.decode(x, torch.tensor([L], device=self.device),
                                   self.traffic["threshold"])
        sync(self.device)

    def process(self, k: int, run: Run):
        from multimodaltopicsegmentation_torch.dsp.unitize import (inference_uniform_units,
                                                                    to_sample, to_time)
        from multimodaltopicsegmentation_torch.ops.pooling import pool
        from multimodaltopicsegmentation_torch.train.data import pad_batch

        traced = run.traced
        audio = self.doc_audio(k)
        t = time.perf_counter()
        with trace.span("unitize", traced):
            units = inference_uniform_units(to_time(SR, len(audio)), self.traffic["interval_s"])
            bounds = [(to_sample(SR, s), min(to_sample(SR, e), len(audio))) for s, e in units]
        t1 = time.perf_counter()
        run.add_span("unitize", t1 - t)
        with trace.span("encode", traced):
            unit_frames = self.encoder.encode_document(audio, bounds, self.traffic["encode_chunk"])
        t2 = time.perf_counter()
        n = len(unit_frames)
        run.add_span("encode", t2 - t1, n)
        with trace.span("pool", traced):
            # the pooling of cli/extract_embeddings.write_frame_level, on the device
            frames = torch.from_numpy(np.concatenate(unit_frames, axis=0)).to(self.device)
            seg_ids = torch.from_numpy(
                np.repeat(np.arange(n), [len(u) for u in unit_frames])).to(self.device)
            pooled = pool(frames, seg_ids, n, self.traffic["pooling"]).cpu().numpy()
            del frames, seg_ids
        t3 = time.perf_counter()
        run.add_span("pool", t3 - t2)
        with trace.span("decode", traced):
            batch = pad_batch([(pooled, [0] * n, f"doc{k}")], crf=self.crf, bucket=True)
            x, lengths = (torch.from_numpy(batch[key]).to(self.device)
                          for key in ("src_tokens", "src_lengths"))
            with torch.inference_mode():
                logits, tags = self.tagger.decode(x, lengths, self.traffic["threshold"])
            L = int(batch["src_lengths"][0])
            tags = tags.cpu().numpy()[0][:L].astype(int).tolist()
            logits = logits[0, :L, 0].cpu().numpy()
        t4 = time.perf_counter()
        run.add_span("decode", t4 - t3, L)
        with trace.span("segment", traced):
            segs, _ = self.segmenter.segment_audio(None, tags, mock_audio=audio, mock_sr=SR)
        t5 = time.perf_counter()
        run.add_span("segment", t5 - t4)
        self.record_work(run, n, L, batch["src_tokens"].shape[1])
        flops = (n * roofline.wav2vec2_unit_flops(self.config["encoder"], SR)
                 + self.arch.flops([L], self.tagger_cfg, False))
        run.completions.append((t5, n, flops))
        self.outputs.append({"k": k, "pooled": pooled, "logits": logits, "tags": tags,
                             "segments": segs, "units": n})

    def record_work(self, run: Run, n: int, L: int, rows_L: int):
        """K1's launches for a document of n units, one per chunk of rows, and
        the tagger's own kernels over its padded batch."""
        enc = self.config["encoder"]
        C = enc["conv_dim"][0]
        T = (SR - enc["conv_kernel"][0]) // enc["conv_stride"][0] + 1
        chunk = self.traffic["encode_chunk"]
        for i in range(0, n, chunk):
            rows = min(chunk, 32 * -(-(min(chunk, n - i)) // 32))
            run.add_work(K1, lambda b: (0.0, b), roofline.k1_bytes(rows, C, T))
        self.arch.record_work(run, [L], rows_L, self.tagger_cfg, False)

    def window(self, run: Run):
        k = 0
        while time.perf_counter() - run.t0 < run.seconds:
            run.attempted += 1
            self.process(k, run)
            k += 1

    def free_program(self):
        self.__dict__.pop("encoder", None)
        self.__dict__.pop("tagger", None)

    # -- the check -----------------------------------------------------------------
    def reference_answers(self, tf32: bool):
        """Answers of the plain reference for what the check reads."""
        from reference import models as R
        from reference import taggers

        sd = weights.wav2vec2(self.config["encoder"], self.seed, self.device)
        params = weights.tagger(self.tagger_cfg, self.seed, self.device)
        ref_tagger = taggers.load(self.tagger_cfg["architecture"])
        enc = self.config["encoder"]

        def pooled(k, unit_ids):
            audio = self.doc_audio(k)
            units = np.stack([audio[u * SR:(u + 1) * SR] for u in unit_ids])
            with R.precision(tf32):
                return R.pooled_units(sd, enc, torch.from_numpy(units).to(self.device)).cpu().numpy()

        def logits(emb):
            with R.precision(tf32), torch.no_grad():
                x = torch.from_numpy(emb[None]).to(self.device)
                return ref_tagger.logits(params, x, [emb.shape[0]], self.tagger_cfg)[0].cpu().numpy()

        return pooled, logits

    def check(self, run: Run, control: bool, fault: Optional[str] = None) -> List[tuple]:
        from reference import models as R

        limits = self.cell.limits
        r = traffic.rng(self.seed, "check")
        done = self.outputs
        if control:  # the documents a window finishes: the order's first, up to its units
            budget, k = self.traffic["control_units"], 0
            while budget > 0:
                budget -= self.docs[k % len(self.docs)][1]
                done.append({"k": k, "units": self.docs[k % len(self.docs)][1]})
                k += 1
        if not done:
            return [("documents_done", 0.0, -1.0)]
        ref_pooled, ref_logits = self.reference_answers(False)
        ctl_pooled, ctl_logits = self.reference_answers(True) if control else (None, None)
        # one whole document (its every unit, its logits, tags and segments) ...
        whole = done[int(r.integers(len(done)))]
        n, cut = whole["units"], self.traffic["max_tagged_units"]
        emb_ref = ref_pooled(whole["k"], range(n))
        emb_got = ctl_pooled(whole["k"], range(n)) if control else whole["pooled"]
        gaps = [gap_rel(emb_got, emb_ref)]
        # ... and a sample of units over every document the window finished
        per_doc = [d["units"] for d in done]
        picks = r.choice(sum(per_doc), size=min(self.traffic["check_sample_units"],
                                                  sum(per_doc)), replace=False)
        starts = np.cumsum([0] + per_doc)
        for j, d in enumerate(done):
            ids = sorted(int(p - starts[j]) for p in picks if starts[j] <= p < starts[j + 1])
            if ids:
                got = ctl_pooled(d["k"], ids) if control else d["pooled"][ids]
                gaps.append(gap_rel(got, ref_pooled(d["k"], ids)))
        L = min(n, cut)
        lg_ref = ref_logits(emb_ref[:L])
        if control:
            lg_got = ctl_logits(emb_got[:L])
            tags = (lg_got > 0).astype(int).tolist()
            segs = R.segments(tags, self.samples[whole["k"] % len(self.docs)])
        else:
            lg_got, tags, segs = whole["logits"], whole["tags"], whole["segments"]
        logit_gap = float(np.abs(lg_got - lg_ref).max()) if len(lg_got) == L else float("inf")
        margin = limits["logit_gap"]
        flips = abs(len(tags) - L) + int(sum(
            1 for t, z in zip(tags, lg_ref) if abs(z) > margin and t != int(z > 0)))
        want_segs = R.segments(tags, self.samples[whole["k"] % len(self.docs)])
        return [("emb_gap", max(gaps), limits["emb_gap"]),
                ("logit_gap", logit_gap, limits["logit_gap"]),
                ("tag_flips", float(flips), limits["tag_flips"]),
                ("segment_mismatch", float(segs != want_segs), limits["segment_mismatch"])]
