"""End-to-end raw-audio -> topic-segments inference CLI.

Counterpart of the JAX package's cli/predict.py: read the sentence encoder
from a training `results.txt`, load the checkpoint (the JAX package's pickle
format, which names the architecture), optionally extract embeddings from an audio folder
in-process (uniform 1-second units; `-ee --wav2vec` runs the checkpoint that
MTS_WAV2VEC2_WEIGHTS names: wav2vec2, WavLM or w2v-BERT 2.0, as its
config.json says), decode every document on the device,
convert boundary vectors to sample spans (`segment_audio`) and write
per-segment wavs with +-1 s overlap and `results.pkl`.

A checkpoint that is not in that format is read as a reference-trained
torch/Lightning `TextSegmenter` checkpoint and converted in place
(tools/convert_reference_checkpoint.py; the architecture comes from the
results.txt's `Neural architecture` line, the threshold from `-th`).
Every architecture of the registry decodes through the same loop; a CRF
tagger's tags are its Viterbi paths. A late-fusion checkpoint also reads the
second modality's embeddings (`-ef2`, default `<ef>_enc2`: the same file
names and unit counts), whose encoder the training `results.txt` names on
its `Second sentence encoder` line. SwitchBiLSTM is refused: predict has no
per-document domain ids.

Under torchrun (WORLD_SIZE > 1), and for a single-input tagger, the decode
is sharded as the JAX CLI shards it over its devices: every chunk of
documents is padded to a multiple of the ranks with zero-length documents,
each rank decodes its share and the tags are gathered
(parallel/train_step.make_sharded_decode). Rank 0 extracts the embeddings
(-ee) and writes `results.pkl` and the segment wavs.

`-lgr` serves the paper's logistic-regression baseline instead
(`LogReg_Predictor`): a pickled sklearn `LogisticRegression` over the
167 prosodic features, read without sklearn (utils/sklearn_pickle.py) and
applied in float64 on the device; `-ee` extracts the prosodic features first.
`-gpus`, `-pca` and `-pca_v` are accepted and unused, as in the JAX CLI.

Run: python -m multimodaltopicsegmentation_torch.cli.predict -ee -ef <emb dir>
       -hyp results.txt -model <checkpoint> -exp <out dir> -af <wav dir>
       [-ef2 <second emb dir>] [-ext .mp3] [--device cpu]
     python -m multimodaltopicsegmentation_torch.cli.predict -lgr -ee -ef <emb dir>
       -model <model.pkl> -exp <out dir> -af <wav dir> [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from ..models import registry
from ..train import checkpoints as ckpt_lib
from ..train.data import load_dataset_for_inference, pad_batch
from ..utils import profiling
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
    encoder) and a checkpoint (architecture, config and weights). `pca_reduce`
    and `pca_value` are accepted and unused, as in the JAX Predictor."""

    def __init__(self, hyperparameter_file, best_model_path, pca_reduce=False, pca_value=167,
                 adaptive_uniform_interval=False, uniform_interval=1,
                 original_audio_extension=".wav", threshold=0.5, sr=16000, device="cuda"):
        self.encoder = self.encoder2 = self.architecture = None
        with open(hyperparameter_file) as f:
            for line in f.readlines():
                if line.startswith("Sentence encoder"):
                    self.encoder = line.split()[2]
                elif line.startswith("Second sentence encoder"):
                    self.encoder2 = line.split()[3]
                elif line.startswith("Neural architecture"):
                    self.architecture = line.split()[2]
        from ..parallel.mesh import rank_device, world_size

        self.device = rank_device(device) if world_size() > 1 else resolve_device(device)

        try:
            params, cfg, arch_name, _ = ckpt_lib.load(best_model_path)
        except Exception:
            params = None
        if params is None:
            # a reference-trained torch/Lightning checkpoint: convert in place (the
            # reference's BCE -> CE fallback, predict.py:227-256, is resolved from
            # the classifier's shape inside the converter)
            try:
                from ..tools.convert_reference_checkpoint import load_torch_checkpoint

                params, cfg, arch_name = load_torch_checkpoint(best_model_path,
                                                               self.architecture)
                cfg = dataclasses.replace(cfg, threshold=threshold)
            except Exception as e:
                raise RuntimeError(
                    f"could not load checkpoint {best_model_path!r}: neither a checkpoint of "
                    "this package nor a convertible reference torch checkpoint (see "
                    f"tools/convert_reference_checkpoint.py): {e}") from e
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
                audio_directory=None, batch_size=8, num_gpus=0, verbose=False, add_overlap=1,
                embedding_folder2=None):
        from ..parallel import mesh as mesh_lib

        if os.path.exists(experiment_name):
            raise ValueError(
                "The name of this experiment has already been used: please "
                f"change experiment name or delete {experiment_name}"
            )
        mesh = sharded = None
        if mesh_lib.world_size() > 1 and not self.double:
            from ..parallel.train_step import make_sharded_decode

            # shard the documents of each chunk over the ranks' "data" axis
            mesh = mesh_lib.make_mesh(model_parallel=1)
            n = mesh.shape["data"]
            batch_size = max(batch_size, n)
            batch_size -= batch_size % n
            sharded = make_sharded_decode(self.arch, mesh, self.th)
        writer = mesh_lib.global_rank() == 0
        mesh_lib.barrier()  # every rank has looked before rank 0 makes it
        if writer:
            os.makedirs(experiment_name)

        with profiling.span("predict") as predict_span:
            with profiling.span("predict.load"):
                docs, docs2 = self._load(embedding_folder, embedding_folder2, verbose)
            predict_span.add("documents", len(docs))
            predict_span.add("units", sum(len(d[0]) for d in docs))
            results = self._tag(docs, docs2, batch_size, mesh, sharded)
            if not writer:
                mesh_lib.barrier()  # rank 0 writes the outputs
                return results
            with profiling.span("predict.write"):
                self._write(experiment_name, [d[2] for d in docs], results, write_audio_segments,
                            audio_directory, add_overlap)
        mesh_lib.barrier()
        return results

    def _load(self, embedding_folder, embedding_folder2, verbose):
        """-> the documents (embeddings, dummy labels, file name) of each
        modality (the second None for a single-input tagger)."""
        embeddings, file_names = load_dataset_for_inference_with_names(embedding_folder)
        if verbose:
            print(f"Segmenting the following files:\n{file_names}")
        docs2 = None
        if self.double:
            docs2 = self._second_modality(embedding_folder, embedding_folder2, embeddings,
                                          file_names)
        return [(e, [0] * len(e), n) for e, n in zip(embeddings, file_names)], docs2

    def _tag(self, docs, docs2, batch_size, mesh, sharded):
        """-> each document's tags, decoded in chunks of `batch_size`
        documents (sharded over the mesh's ranks where there is one)."""
        results = []
        for i in range(0, len(docs), batch_size):
            chunk = docs[i : i + batch_size]
            with profiling.span("predict.pad"):
                # a sharded chunk is padded to a multiple of the ranks
                pad_to = batch_size if mesh is not None and len(chunk) < batch_size else None
                batch = pad_batch(chunk, crf=False, bucket=True, pad_batch_to=pad_to)
                # the same pad_batch arguments: both modalities pad to one length
                x2 = pad_batch(docs2[i : i + batch_size], crf=False,
                               bucket=True)["src_tokens"] if self.double else None
            if mesh is not None:
                with profiling.span("predict.decode"):
                    _, tags = sharded(batch)
            else:
                arrays = [batch["src_tokens"], batch["src_lengths"]] + ([x2] if self.double else [])
                with profiling.span("predict.to_device",
                                    bytes_to_device=sum(a.nbytes for a in arrays)):
                    x, lengths, *rest = (torch.from_numpy(a).to(self.device) for a in arrays)
                with torch.inference_mode(), profiling.span("predict.decode"):
                    if self.double:
                        _, tags = self.arch.decode(x, lengths, self.th, x2=rest[0])
                    else:
                        _, tags = self.arch.decode(x, lengths, self.th)
            with profiling.span("predict.to_host"):
                tags = tags.cpu().numpy()
            for j in range(len(chunk)):
                L = int(batch["src_lengths"][j])
                results.append(tags[j][:L].astype(int).tolist())
        return results

    def _write(self, experiment_name, file_names, results, write_audio_segments,
               audio_directory, add_overlap):
        """The segment wavs (+- `add_overlap` s) and results.pkl."""
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


class LogReg_Predictor(BasePredictor):
    """The pickled-sklearn logistic-regression baseline (reference
    predict.py:352-424) over prosodic features; the model is read by
    utils/sklearn_pickle.py and applied in float64 on the device."""

    def __init__(self, best_model_path, adaptive_uniform_interval=False, uniform_interval=1,
                 original_audio_extension=".wav", threshold=0.5, sr=16000, device="cuda"):
        from ..utils import sklearn_pickle

        self.device = resolve_device(device)
        self.model = sklearn_pickle.load(best_model_path)
        self.encoder = "prosodic"
        self.adapt = bool(adaptive_uniform_interval)
        self.interval = uniform_interval
        self.ext = original_audio_extension
        self.th = threshold
        self.sr = sr

    def predict(self, embedding_folder, experiment_name, write_audio_segments=True,
                audio_directory=None, batch_size=1, num_gpus=0, verbose=False):
        if os.path.exists(experiment_name):
            raise ValueError(
                "The name of this experiment has already been used: please "
                f"change experiment name or delete {experiment_name}"
            )
        os.makedirs(experiment_name)
        results = {}
        for file in sorted(os.listdir(embedding_folder)):
            emb = np.load(os.path.join(embedding_folder, file))
            pred = self.model.predict(emb, self.device) > self.th
            results[file] = pred.astype(int).tolist()
            if write_audio_segments:
                audio_segs, audio = self.segment_audio(
                    os.path.join(audio_directory, file[:-4] + self.ext), results[file])
                for i, seg in enumerate(audio_segs):
                    save_wav(os.path.join(experiment_name, file[:-4] + str(i) + ".wav"),
                             audio[seg[0] : seg[1]], self.sr)
        with open(os.path.join(experiment_name, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
        return results


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
    parser.add_argument("--num_gpus", "-gpus", default=0, type=int)
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--audio_folder", "-af", type=str)
    parser.add_argument("--pca_reduce", "-pca", action="store_true")
    parser.add_argument("--pca_value", "-pca_v", default=167, type=int)
    parser.add_argument("--logistic_regression_baseline", "-lgr", action="store_true")
    parser.add_argument("--uniform_interval", "-ui", default=1, type=float)
    parser.add_argument("--adaptive_uniform", "-aus", action="store_true")
    parser.add_argument("--threshold", "-th", default=0.5, type=float)
    parser.add_argument("--return_just_segmentation", "-rjs", action="store_false")
    # the source audio's extension for the segment-writing step
    parser.add_argument("--audio_extension", "-ext", default=".wav", choices=[".wav", ".mp3"])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def cli_main(argv=None):
    """Parse and run; under torchrun (WORLD_SIZE > 1) this process joins the
    ranks' group first and leaves it at the end."""
    from ..parallel.multihost import process_group_from_environment

    args = build_parser().parse_args(argv)
    with process_group_from_environment(args.device):
        return _run(args)


def _run(args):
    """The run under MTS_TRACE_DIR's device trace; MTS_PROFILE=1 prints the
    spans' report at its end (utils/profiling.py)."""
    with profiling.device_trace():
        results = _predict(args)
    profiling.maybe_print_report()
    return results


def _predict(args):
    from ..parallel.mesh import barrier, global_rank

    if args.logistic_regression_baseline:
        predictor = LogReg_Predictor(
            args.best_model_path,
            adaptive_uniform_interval=args.adaptive_uniform,
            uniform_interval=args.uniform_interval,
            original_audio_extension=args.audio_extension,
            device=args.device,
        )
        if args.extract_embeddings:
            predictor.create_embeddings(predictor.encoder, args.audio_folder,
                                        args.embedding_folder, args.uniform_interval,
                                        args.adaptive_uniform, args.verbose, True)
        return predictor.predict(
            args.embedding_folder,
            args.experiment_name,
            write_audio_segments=args.return_just_segmentation,
            audio_directory=args.audio_folder,
            batch_size=args.batch_size,
            num_gpus=args.num_gpus,
            verbose=args.verbose,
        )
    predictor = Predictor(
        args.hyperparameter_file,
        args.best_model_path,
        args.pca_reduce,
        args.pca_value,
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
            if global_rank() == 0:
                predictor.create_embeddings(enc, args.audio_folder, folder, args.uniform_interval,
                                            args.adaptive_uniform, args.verbose, True)
            barrier()
            pooling_idx = enc.find("_")
            if pooling_idx > -1:
                setattr(args, attr, os.path.join(folder, enc[pooling_idx:]))
    return predictor.predict(
        args.embedding_folder,
        args.experiment_name,
        write_audio_segments=args.return_just_segmentation,
        audio_directory=args.audio_folder,
        batch_size=args.batch_size,
        num_gpus=args.num_gpus,
        verbose=args.verbose,
        embedding_folder2=args.embedding_folder2,
    )


if __name__ == "__main__":
    cli_main()
