"""Training-time feature and label extraction CLI (counterpart of the JAX
package's cli/extract_embeddings.py, reference extract_embeddings.py).

Walks an audio directory, pairs each wav with its timestamped-sentence
transcript by file name, unitises (VAD spans, ASR sentence times or uniform
windows), aligns topic labels to units, encodes every unit on the device and
writes:
- `{doc}.npy` per document ([n_units, dim]) or, for frame-level encoders
  (wav2vec, openl3, CREPE), the pooling folders `_mean`, `_max`,
  `_mean_std`, `_max_std`, `_last`, `_delta_gap` and `_no_reduction`;
- `segments.pkl`, `labs_dict.pkl` and `labels.npy`.

`labs_dict.pkl` is keyed by the document stem, which the training loader
looks up (the JAX package's fix of the reference, which keys by audio path).
The VAD path keeps the reference's fallbacks as they are: a RuntimeError
reruns the VAD without the energy double check, a MemoryError runs it on
four quarters of the audio.

Run: python -m multimodaltopicsegmentation_torch.cli.extract_embeddings
       -data <transcripts> -audio <wavs> -od <out> -lab <labels.npy>
       -lod <label out> [-vd] [--prosodic_feats | --mfcc | --wav2vec | ...]
       [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import sys

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from ..dsp.unitize import create_uniform_segments, create_vad_segments, to_sample
from ..encoders.engine import build_encoder
from ..ops.pooling import POOLING_VARIANTS, pool
from ..utils import profiling
from ..utils.audio import prefetch_audio

EXCLUDE_RE = "(24580|25539|25684|26071|26214|26321|26427)"
POOL_DIRS = ("_mean", "_max", "_no_reduction", "_mean_std", "_max_std", "_last", "_delta_gap")


def write_frame_level(out_directory: str, doc_name: str, unit_frames: list, device="cpu"):
    """Write the pooling variants of a document (segment reductions on
    `device`) and its raw frames under _no_reduction."""
    for d in POOL_DIRS:
        os.makedirs(os.path.join(out_directory, d), exist_ok=True)

    with open(os.path.join(out_directory, "_no_reduction", doc_name) + ".pkl", "wb") as f:
        pickle.dump(unit_frames, f)

    frames = torch.from_numpy(np.concatenate(unit_frames, axis=0)).to(device)
    seg_ids = torch.from_numpy(
        np.repeat(np.arange(len(unit_frames)), [len(u) for u in unit_frames])
    ).to(device)
    n = len(unit_frames)
    for variant in POOLING_VARIANTS:
        arr = pool(frames, seg_ids, n, variant).cpu().numpy()
        np.save(os.path.join(out_directory, variant, doc_name), arr)


def write_document(encoder, out_directory: str, doc_name: str, unit_embs: list, device):
    if encoder.frame_level:
        write_frame_level(out_directory, doc_name, unit_embs, device)
    else:
        np.save(os.path.join(out_directory, doc_name), np.stack(unit_embs))


def existing_outputs(out_directory: str) -> list:
    """Documents already written: `.npy` files, and the `_mean` folder of
    frame-level encoders (for --continue_from_check)."""
    existent = [f for f in os.listdir(out_directory) if f.endswith(".npy")]
    mean_dir = os.path.join(out_directory, "_mean")
    if os.path.exists(mean_dir):
        existent += os.listdir(mean_dir)
    return existent


def vad_segmentation(audio, postprocess: bool, device, verbose=False) -> list:
    """The reference's VAD call structure (extract_embeddings.py:297-369)."""
    from ..dsp.vad import get_speech_segments, get_speech_segments_quartered

    try:
        try:
            return get_speech_segments(audio, 16000, apply_energy_VAD=postprocess, device=device)
        except RuntimeError:
            if verbose:
                print("Warning: Postprocessing failed... trying with just neural VAD.")
            return get_speech_segments(audio, 16000, apply_energy_VAD=False, device=device)
    except MemoryError:
        return get_speech_segments_quartered(audio, 16000, apply_energy_VAD=postprocess,
                                             device=device)


def main(args):
    verbose = args.verbose
    device = resolve_device(getattr(args, "device", "cuda"))
    os.makedirs(args.out_directory, exist_ok=True)
    existent_files = existing_outputs(args.out_directory)
    encoder = build_encoder(args, device)

    # pair audio files with transcripts (reference regex pairing, :207-224)
    file_paths, audio_paths, filenames = [], [], []
    for root, _dirs, files in os.walk(args.audio_directory):
        for file in sorted(files):
            if not (file.endswith("mp3") or file.endswith("wav")):
                continue
            filename = re.findall(r"(.+)\.\w+$", file)[-1]
            filenames.append(filename)
            if args.data_directory:
                file_pattern = r"\s?({}\S*)".format(re.escape(filename))
                transcript = re.findall(
                    file_pattern, " ".join(os.listdir(args.data_directory))
                )[-1]
                file_paths.append(os.path.join(args.data_directory, transcript))
            audio_paths.append(os.path.join(root, file))

    # the flat sentence-level boundary labels
    lab_file = None
    if args.extract_labels:
        if args.BMAT:
            with open(args.lab_file) as f:
                lab_file = json.load(f)
        else:
            lab_file = np.load(args.lab_file)

    # transcripts
    times = []
    if args.BMAT:
        for _k, v in lab_file.items():
            times.append(v)
    else:
        for file_path in file_paths:
            if file_path.endswith("pkl"):
                with open(file_path, "rb") as f:
                    tss = pickle.load(f)
            elif file_path.endswith("json"):
                with open(file_path) as f:
                    tss = json.load(f)
            else:
                raise ValueError("The timestamped sentences must be in json or pkl format!")
            times.append([(t["start"], t["end"]) for t in tss])

    all_segments, all_labs = [], []
    all_labs_dictionary = {}
    lab_index = 0

    # skip decisions do not depend on audio, so upcoming documents are
    # decoded while the current one is encoded
    def _skipped(i):
        if args.continue_from_check and existent_files:
            current = os.path.basename(audio_paths[i])[:-4]
            if re.findall(re.escape(current), " ".join(existent_files)):
                return "exists"
        if re.findall(EXCLUDE_RE, audio_paths[i]):
            return "excluded"
        return None

    loader = prefetch_audio(
        [audio_paths[i] for i in range(len(times)) if _skipped(i) is None], target_sr=16000
    )

    for index, timestamps in enumerate(times):
        if args.BMAT:
            timestamps = lab_file[os.path.basename(audio_paths[index])[:-4]]
        skip = _skipped(index)
        if skip == "exists":
            lab_index += len(timestamps)
            print(f"File {os.path.basename(audio_paths[index])[:-4]}.npy exists "
                  "in target directory: skipping")
            continue
        if skip == "excluded":
            if not args.BMAT:
                lab_index += len(timestamps)
            continue

        _path, audio, sr = next(loader)

        def collect_lab_times():
            nonlocal lab_index
            lab_time = []
            if args.BMAT:
                for time in timestamps:
                    if lab_time:
                        lab_time.append((lab_time[-1][1], lab_time[-1][1] + time))
                    else:
                        lab_time.append((0, time))
            else:
                for time in timestamps:
                    if lab_file is not None and lab_file[lab_index]:
                        lab_time.append(time)
                    lab_index += 1
            return lab_time

        if args.vad:
            if verbose:
                print("Segmenting with the built-in VAD pipeline...")
            segmentation = vad_segmentation(audio, args.postprocess, device, verbose)
            segments, labs = create_vad_segments(segmentation, collect_lab_times(),
                                                 speechbrain=True)
            if len(segmentation) != len(labs):
                raise RuntimeError("Labs and segmentation lengths differ!")
        elif args.use_sentence_time:
            if verbose:
                print("Using sentence-level times from the ASR transcript...")
            labs = []
            for _time in timestamps:
                labs.append(1 if (lab_file is not None and lab_file[lab_index]) else 0)
                lab_index += 1
            segmentation = segments = timestamps
        else:
            lab_time = collect_lab_times()
            if args.adaptive_uniform_segmentation:
                segment_duration = float(lab_time[-1][1]) / 100
            else:
                segment_duration = args.uniform_interval
            if verbose:
                print(f"Uniform segmentation, duration={segment_duration}s")
            segmentation, labs = create_uniform_segments(
                lab_time, segment_duration=segment_duration,
                append_labs=args.concatenate_labels,
            )
            segments = segmentation
            if len(segmentation) != len(labs):
                raise RuntimeError("Segmentation must be the same length as labels!")

        all_segments.append(segments)
        if args.concatenate_labels:
            all_labs.extend(labs)
        else:
            all_labs.append(labs)
        all_labs_dictionary[filenames[index]] = labs

        # unit sample bounds: each unit runs to the next unit's start, the
        # last to its own end (:504-513)
        bounds = []
        for i2, time in enumerate(segmentation):
            start = to_sample(16000, float(time[0]))
            if i2 + 1 < len(segmentation):
                end = to_sample(16000, float(segmentation[i2 + 1][0]))
            else:
                end = to_sample(16000, float(time[1]))
            bounds.append((start, min(end, len(audio))))

        if verbose:
            print(f"Encoding {len(bounds)} units of {audio_paths[index]}")
        unit_embs = encoder.encode_document(audio, bounds)
        if len(unit_embs) != len(segmentation):
            raise RuntimeError("Something went wrong!")
        write_document(encoder, args.out_directory, filenames[index], unit_embs, device)

    if args.extract_labels:
        os.makedirs(args.lab_out_dir, exist_ok=True)
        with open(os.path.join(args.lab_out_dir, "segments.pkl"), "wb") as fp:
            pickle.dump(all_segments, fp)
        with open(os.path.join(args.lab_out_dir, "labs_dict.pkl"), "wb") as fp:
            pickle.dump(all_labs_dictionary, fp)
        np.save(os.path.join(args.lab_out_dir, "labels"), np.array(all_labs, dtype=object))


class MyParser(argparse.ArgumentParser):
    def error(self, message):
        sys.stderr.write("error: %s\n" % message)
        self.print_help()
        sys.exit(2)


def build_parser():
    parser = MyParser(
        description="Compute audio embeddings and store them in the specified directory"
    )
    parser.add_argument("--data_directory", "-data", type=str)
    parser.add_argument("--audio_directory", "-audio", type=str)
    parser.add_argument("--out_directory", "-od", default="results", type=str)
    parser.add_argument("--ecapa", "-e", action="store_true")
    parser.add_argument("--verbose", "-vb", action="store_true")
    parser.add_argument("--just_speakers", "-js", action="store_false")
    parser.add_argument("--extract_labels", "-exl", action="store_false")
    parser.add_argument("--lab_file", "-lab", default="nltk_podcast_labs.npy", type=str)
    parser.add_argument("--lab_out_dir", "-lod", default="INA_podcast_segments", type=str)
    parser.add_argument("--vad", "-vd", action="store_false")
    parser.add_argument("--speechbrain", "-sb", action="store_true")
    parser.add_argument("--concatenate_labels", "-cl", action="store_true")
    parser.add_argument("--postprocess", "-pp", action="store_false")
    parser.add_argument("--uniform_interval", "-ui", type=float, default=1.0)
    parser.add_argument("--use_sentence_time", "-ust", action="store_true")
    parser.add_argument("--openl3", action="store_true")
    parser.add_argument("--wav2vec", action="store_true")
    parser.add_argument("--CREPE", action="store_true")
    parser.add_argument("--prosodic_feats", action="store_true")
    parser.add_argument("--mfcc", action="store_true")
    parser.add_argument("--max", action="store_true")
    parser.add_argument("--add_std", action="store_true")
    parser.add_argument("--gap_sentence", "-gs", action="store_true")
    parser.add_argument("--continue_from_check", "-cont", action="store_true")
    parser.add_argument("--BMAT", action="store_true")
    parser.add_argument("--adaptive_uniform_segmentation", "-aus", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def cli_main(argv=None):
    args = build_parser().parse_args(argv)
    with profiling.device_trace():
        main(args)
    profiling.maybe_print_report()


if __name__ == "__main__":
    cli_main()
