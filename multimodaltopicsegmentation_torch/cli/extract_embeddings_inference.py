"""Inference-time feature extraction (no transcripts, no labels).

Counterpart of the JAX package's cli/extract_embeddings_inference.py: uniform
or adaptive-uniform (total/100) unitization, every encoder of the training
extractor (OpenL3 as its mel256 inference variant), one batched device
encode per document, `{doc}.npy` or the pooling-variant folders. Called
in-process by cli/predict.py.

Replicated quirk: each unit is exactly ONE second long starting at
`interval * i` (reference extract_embeddings_inference.py:245-248), including
under adaptive intervals, since predict's `segment_audio` depends on that
stride contract.

Run: python -m multimodaltopicsegmentation_torch.cli.extract_embeddings_inference
       -audio <wav dir> -od <out dir> [--wav2vec | --prosodic_feats | ...]
       [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import re
import sys

from ..core.torch_setup import resolve_device
from ..dsp.unitize import inference_uniform_units, to_sample, to_time
from ..encoders.engine import build_encoder
from ..utils.audio import prefetch_audio
from .extract_embeddings import existing_outputs, write_document


def main(args):
    verbose = args.verbose
    device = resolve_device(getattr(args, "device", "cuda"))
    os.makedirs(args.out_directory, exist_ok=True)
    existent_files = existing_outputs(args.out_directory)
    # inference uses the mel256/music OpenL3 variant (reference quirk)
    args._inference_variant = True
    encoder = build_encoder(args, device)

    audio_paths, filenames = [], []
    for root, _dirs, files in os.walk(args.audio_directory):
        for file in sorted(files):
            if file.endswith("mp3") or file.endswith("wav"):
                filenames.append(re.findall(r"(.+)\.\w+$", file)[-1])
                audio_paths.append(os.path.join(root, file))

    def _skipped(i):
        return bool(
            args.continue_from_check
            and existent_files
            and re.findall(re.escape(filenames[i]), " ".join(existent_files))
        )

    loader = prefetch_audio(
        [p for i, p in enumerate(audio_paths) if not _skipped(i)], target_sr=16000
    )

    for index, path in enumerate(audio_paths):
        if _skipped(index):
            print(f"File {filenames[index]} exists in target directory: skipping")
            continue

        _path, audio, sr = next(loader)
        audio_length = to_time(16000, len(audio))

        interval = (
            audio_length / 100
            if args.adaptive_uniform_segmentation
            else args.uniform_interval
        )
        units = inference_uniform_units(audio_length, interval)
        bounds = [
            (to_sample(16000, s), min(to_sample(16000, e), len(audio)))
            for s, e in units
        ]
        if not bounds:
            print(f"Warning: {path} shorter than one unit interval, skipping")
            continue

        if verbose:
            print(f"Encoding {len(bounds)} units of {path}")
        unit_embs = encoder.encode_document(audio, bounds)
        write_document(encoder, args.out_directory, filenames[index], unit_embs, device)


class MyParser(argparse.ArgumentParser):
    def error(self, message):
        sys.stderr.write("error: %s\n" % message)
        self.print_help()
        sys.exit(2)


def build_parser():
    parser = MyParser(description="Compute audio embeddings for inference")
    parser.add_argument("--audio_directory", "-audio", type=str)
    parser.add_argument("--out_directory", "-od", default="results", type=str)
    parser.add_argument("--ecapa", "-e", action="store_true")
    parser.add_argument("--verbose", "-vb", action="store_true")
    parser.add_argument("--vad", "-vd", action="store_false")
    parser.add_argument("--speechbrain", "-sb", action="store_true")
    parser.add_argument("--uniform_interval", "-ui", type=float, default=1.0)
    parser.add_argument("--openl3", action="store_true")
    parser.add_argument("--wav2vec", action="store_true")
    parser.add_argument("--CREPE", action="store_true")
    parser.add_argument("--prosodic_feats", action="store_true")
    parser.add_argument("--mfcc", action="store_true")
    parser.add_argument("--continue_from_check", "-cont", action="store_true")
    parser.add_argument("--adaptive_uniform_segmentation", "-aus", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def cli_main(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli_main()
