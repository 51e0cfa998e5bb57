"""Inference unitization (the part of the JAX package's dsp/unitize.py that
the predict path uses).

Reference quirk kept: inference units start at interval * i and last ONE
second, even under adaptive intervals; predict's `segment_audio` relies on
that stride contract.
"""
from __future__ import annotations


def inference_uniform_units(audio_length_s: float, interval: float):
    """[(start_s, end_s)] with the reference's 1-second unit quirk."""
    n = int(audio_length_s // interval)
    return [(interval * i, interval * i + 1) for i in range(n)]


def to_sample(sample_rate: int, time: float) -> int:
    return int(sample_rate * time)


def to_time(sample_rate: int, samples: int) -> float:
    return samples / sample_rate
