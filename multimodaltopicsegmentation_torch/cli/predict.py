"""End-to-end raw-audio -> topic-segments inference CLI.

Counterpart of the JAX package's cli/predict.py: read the sentence encoder
from a training `results.txt`, load the checkpoint (the JAX package's pickle
format, which names the architecture), optionally extract embeddings from an audio folder
in-process (uniform 1-second units), decode every document on the device,
convert boundary vectors to sample spans (`segment_audio`) and write
per-segment wavs with +-1 s overlap and `results.pkl`.

Every architecture of the registry decodes through the same loop; a CRF
tagger's tags are its Viterbi paths. A late-fusion checkpoint also reads the
second modality's embeddings (`-ef2`, default `<ef>_enc2`: the same file
names and unit counts), whose encoder the training `results.txt` names on
its `Second sentence encoder` line. SwitchBiLSTM is refused: predict has no
per-document domain ids.

Run: python -m multimodaltopicsegmentation_torch.cli.predict -ee -ef <emb dir>
       -hyp results.txt -model <checkpoint> -exp <out dir> -af <wav dir>
       [-ef2 <second emb dir>] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
from types import SimpleNamespace

import torch

from ..core.torch_setup import resolve_device
from ..models import registry
from ..train import checkpoints as ckpt_lib
from ..train.data import load_dataset_for_inference, pad_batch
from ..utils.audio import load_audio, save_wav


def load_dataset_for_inference_with_names(embedding_directory):
    files = sorted(os.listdir(embedding_directory))
    data = load_dataset_for_inference(embedding_directory)
    return data, files


class BasePredictor:
    def create_embeddings(self, encoder, audio_directory, out_directory, uniform_interval=1,
                          adaptive_uniform=False, verbose=False, continue_from_check=True):
        from . import extract_embeddings_inference as eei

        enc = encoder.lower()
        args = SimpleNamespace(
            vad=False,
            speechbrain=True,
            ecapa=enc.startswith("ecapa"),
            openl3=enc.startswith("openl3"),
            wav2vec=enc.startswith("wav2vec"),
            CREPE=enc.startswith("crepe"),
            prosodic_feats=enc.startswith("prosodic"),
            mfcc=enc.startswith("mfcc"),
            audio_directory=audio_directory,
            out_directory=out_directory,
            uniform_interval=uniform_interval,
            adaptive_uniform_segmentation=adaptive_uniform,
            verbose=verbose,
            continue_from_check=continue_from_check,
            device=self.device,
        )
        eei.main(args)

    def segment_audio(self, audio_file, segmentation, mock_audio=None, mock_sr=None):
        """Boundary vector -> [(start_sample, end_sample)] spans
        (reference predict.py:92-129)."""
        if mock_audio is not None:
            if mock_sr is None:
                raise ValueError("Provide a mock sample rate to debug...")
            x, sr = mock_audio, mock_sr
        else:
            x, sr = load_audio(audio_file, target_sr=self.sr)

        audio_segs = []
        prev_time = 0
        counter = 0
        if self.adapt:
            for i in range(len(x) // 100, len(x) + 1, len(x) // 100):
                if counter >= len(segmentation):
                    break
                if segmentation[counter]:
                    audio_segs.append((prev_time, i))
                    prev_time = i
                counter += 1
        else:
            for i in range(self.sr * int(self.interval), len(x) + 1, self.sr * int(self.interval)):
                if counter >= len(segmentation):
                    break
                if segmentation[counter]:
                    audio_segs.append((prev_time, i))
                    prev_time = i
                counter += 1
            audio_segs.append((prev_time, len(x)))
        return audio_segs, x


class Predictor(BasePredictor):
    """Neural predictor driven by a training results.txt (its sentence
    encoder) and a checkpoint (architecture, config and weights)."""

    def __init__(self, hyperparameter_file, best_model_path, adaptive_uniform_interval=False,
                 uniform_interval=1, original_audio_extension=".wav", threshold=0.5, sr=16000,
                 device="cuda"):
        self.encoder = self.encoder2 = None
        with open(hyperparameter_file) as f:
            for line in f.readlines():
                if line.startswith("Sentence encoder"):
                    self.encoder = line.split()[2]
                elif line.startswith("Second sentence encoder"):
                    self.encoder2 = line.split()[3]
        self.device = resolve_device(device)

        params, cfg, arch_name, _ = ckpt_lib.load(best_model_path)
        if registry.is_domain_adapt(arch_name):
            raise NotImplementedError(
                f"predict does not support architecture {arch_name!r}: it needs per-document "
                "domain ids that the raw-audio predict pipeline cannot provide")
        self.double = registry.is_double_input(arch_name)
        if self.double and self.encoder2 is None:
            raise ValueError(
                f"architecture {arch_name!r} needs a second modality but {hyperparameter_file!r} "
                "has no 'Second sentence encoder' line (train with train_fit -enc2 to record it)")
        self.cfg = cfg
        self.arch = registry.build(arch_name, cfg)
        self.arch.load_state_dict(type(self.arch).from_jax_params(params))
        self.arch.to(self.device).eval()

        self.adapt = bool(adaptive_uniform_interval)
        self.interval = uniform_interval
        self.ext = original_audio_extension
        self.th = threshold
        self.sr = sr

    def predict(self, embedding_folder, experiment_name, write_audio_segments=True,
                audio_directory=None, batch_size=8, verbose=False, add_overlap=1,
                embedding_folder2=None):
        if os.path.exists(experiment_name):
            raise ValueError(
                "The name of this experiment has already been used: please "
                f"change experiment name or delete {experiment_name}"
            )
        os.makedirs(experiment_name)

        embeddings, file_names = load_dataset_for_inference_with_names(embedding_folder)
        if verbose:
            print(f"Segmenting the following files:\n{file_names}")
        docs2 = None
        if self.double:
            docs2 = self._second_modality(embedding_folder, embedding_folder2, embeddings,
                                          file_names)

        results = []
        docs = [(e, [0] * len(e), n) for e, n in zip(embeddings, file_names)]
        for i in range(0, len(docs), batch_size):
            chunk = docs[i : i + batch_size]
            batch = pad_batch(chunk, crf=False, bucket=True)
            x, lengths = (torch.from_numpy(batch[k]).to(self.device)
                          for k in ("src_tokens", "src_lengths"))
            with torch.inference_mode():
                if self.double:
                    # the same pad_batch arguments: both modalities pad to one length
                    x2 = pad_batch(docs2[i : i + batch_size], crf=False, bucket=True)["src_tokens"]
                    _, tags = self.arch.decode(x, lengths, self.th,
                                               x2=torch.from_numpy(x2).to(self.device))
                else:
                    _, tags = self.arch.decode(x, lengths, self.th)
            tags = tags.cpu().numpy()
            for j in range(len(chunk)):
                L = int(batch["src_lengths"][j])
                results.append(tags[j][:L].astype(int).tolist())

        if write_audio_segments:
            if audio_directory is None:
                raise ValueError("If segmenting the input audio, provide the audio directory")
            seg_dir = os.path.join(experiment_name, "audio_segments")
            os.makedirs(seg_dir)
            for index, file in enumerate(file_names):
                audio_file = os.path.join(audio_directory, file[:-4] + self.ext)
                if not os.path.exists(audio_file):
                    raise FileNotFoundError(f"Could not find the audio file for embedding {file}")
                if sum(results[index]) == 0:
                    print(f"Warning: no segment identified in {file}! "
                          "No audio segments written for this file.")
                    continue
                audio_segments, audio = self.segment_audio(audio_file, results[index])
                for index_seg, seg in enumerate(audio_segments):
                    offset_start = offset_end = 0
                    if add_overlap:
                        offset = add_overlap * self.sr
                        offset_start, offset_end = (offset, offset) if index_seg else (0, offset)
                    save_wav(
                        os.path.join(seg_dir, file[:-4] + str(index_seg) + ".wav"),
                        audio[max(seg[0] - offset_start, 0) : seg[1] + offset_end],
                        self.sr,
                    )
        with open(os.path.join(experiment_name, "results.pkl"), "wb") as f:
            pickle.dump(dict(zip(file_names, results)), f)
        return results

    @staticmethod
    def _second_modality(embedding_folder, embedding_folder2, embeddings, file_names):
        """The late-fusion tagger's second modality as documents, checked to
        hold the same files with the same unit counts as the first (the two
        streams share one length vector)."""
        if embedding_folder2 is None:
            raise ValueError("late-fusion predict needs the second modality's embedding folder "
                             "(-ef2)")
        embeddings2, names2 = load_dataset_for_inference_with_names(embedding_folder2)
        if names2 != file_names:
            raise ValueError(f"second-modality folder {embedding_folder2!r} does not hold the same "
                             f"documents as {embedding_folder!r}")
        for e1, e2, name in zip(embeddings, embeddings2, file_names):
            if len(e1) != len(e2):
                raise ValueError(f"{name}: {len(e1)} units in {embedding_folder!r} vs {len(e2)} "
                                 f"in {embedding_folder2!r}; extract both modalities with the "
                                 "same unitization")
        return [(e, [0] * len(e), n) for e, n in zip(embeddings2, file_names)]


class MyParser(argparse.ArgumentParser):
    def error(self, message):
        sys.stderr.write("error: %s\n" % message)
        self.print_help()
        sys.exit(2)


def build_parser():
    parser = MyParser(description="Raw audio -> topic segments inference")
    parser.add_argument("--extract_embeddings", "-ee", action="store_true")
    parser.add_argument("--embedding_folder", "-ef", type=str, required=True)
    # the second modality of a late-fusion checkpoint; default <embedding_folder>_enc2
    parser.add_argument("--embedding_folder2", "-ef2", type=str, default=None)
    parser.add_argument("--hyperparameter_file", "-hyp", type=str)
    parser.add_argument("--best_model_path", "-model", type=str)
    parser.add_argument("--experiment_name", "-exp", default="new_experiment", type=str)
    parser.add_argument("--batch_size", "-bs", default=8, type=int)
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--audio_folder", "-af", type=str)
    parser.add_argument("--uniform_interval", "-ui", default=1, type=float)
    parser.add_argument("--adaptive_uniform", "-aus", action="store_true")
    parser.add_argument("--threshold", "-th", default=0.5, type=float)
    parser.add_argument("--return_just_segmentation", "-rjs", action="store_false")
    parser.add_argument("--audio_extension", "-ext", default=".wav", choices=[".wav"])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def cli_main(argv=None):
    args = build_parser().parse_args(argv)
    predictor = Predictor(
        args.hyperparameter_file,
        args.best_model_path,
        adaptive_uniform_interval=args.adaptive_uniform,
        uniform_interval=args.uniform_interval,
        threshold=args.threshold,
        original_audio_extension=args.audio_extension,
        device=args.device,
    )
    if predictor.double and args.embedding_folder2 is None:
        args.embedding_folder2 = args.embedding_folder.rstrip("/\\") + "_enc2"
    if args.extract_embeddings:
        streams = [(predictor.encoder, "embedding_folder")]
        if predictor.double:
            streams.append((predictor.encoder2, "embedding_folder2"))
        for enc, attr in streams:
            folder = getattr(args, attr)
            predictor.create_embeddings(enc, args.audio_folder, folder, args.uniform_interval,
                                        args.adaptive_uniform, args.verbose, True)
            pooling_idx = enc.find("_")
            if pooling_idx > -1:
                setattr(args, attr, os.path.join(folder, enc[pooling_idx:]))
    return predictor.predict(
        args.embedding_folder,
        args.experiment_name,
        write_audio_segments=args.return_just_segmentation,
        audio_directory=args.audio_folder,
        batch_size=args.batch_size,
        verbose=args.verbose,
        embedding_folder2=args.embedding_folder2,
    )


if __name__ == "__main__":
    cli_main()
