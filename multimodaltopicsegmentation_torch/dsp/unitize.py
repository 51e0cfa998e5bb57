"""Unitization and label alignment (a copy of the JAX package's
dsp/unitize.py, reference extract_embeddings.py semantics). These outputs
are the training corpus, so every quirk is kept:

- `create_uniform_segments` (:78-105): fixed- or adaptive-duration windows
  aligned to rounded topic end-times. A topic that rounds to ZERO windows
  contributes a bare `1` label plus one (cursor, end) span when no labels
  exist yet, and otherwise re-marks the previous topic's final label; in
  append mode the empty inner list stays next to the bare 1.
- `create_vad_segments` (:28-76): each VAD span goes to the topic whose
  end-time it crosses; the last span of each topic is labelled 1; trailing
  spans get 0s with a forced final 1. Empty topic groups remove a label at
  the GROUP index of the flat per-unit label list (the reference's pop
  arithmetic), not at the group's unit offset.
- inference units start at interval * i and last ONE second, even under
  adaptive intervals; predict's `segment_audio` relies on that stride.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def create_uniform_segments(
    lab_times: Sequence[Tuple[float, float]],
    segment_duration: float = 1,
    append_labs: bool = False,
):
    segments: List[Tuple[float, float]] = []
    labs: list = []
    cursor = 0
    for topic in lab_times:
        topic_end = float(topic[1])
        n_windows = round((round(topic_end) - cursor) / segment_duration)

        if append_labs:
            window_labs = [0] * n_windows
            labs.append(window_labs)
            if window_labs:
                window_labs[-1] = 1
            else:
                # zero-window topic: the empty list stays, a bare 1 follows,
                # and the whole (cursor, end) range becomes one span
                labs.append(1)
                segments.append((cursor, topic_end))
        else:
            labs.extend([0] * n_windows)
            if labs:
                # marks this topic's final window — or, for a zero-window
                # topic, re-marks the previous topic's final label
                labs[-1] = 1
            else:
                labs.append(1)
                segments.append((cursor, topic_end))

        segments.extend(
            (cursor + segment_duration * i, cursor + segment_duration * (i + 1))
            for i in range(n_windows)
        )
        cursor = round(topic_end)
    return segments, labs


def create_vad_segments(
    segmentation: Sequence,
    lab_times: Sequence,
    speechbrain: bool = False,
    append_labs: bool = False,
):
    """segmentation: list of spans; span end at index 1 (speechbrain-style
    (start, end)) or index 2 (INA-style (tag, start, end))."""
    end_at = 1 if speechbrain else 2
    consumed = 0
    groups: List[list] = []  # VAD spans per topic, in order
    labs: list = []
    for topic in lab_times:
        group: list = []
        for span in segmentation[consumed:]:
            consumed += 1
            group.append(span)
            if float(topic[1]) < span[end_at]:
                break
        groups.append(group)
        topic_labs = [0] * (len(group) - 1) + [1]
        if append_labs:
            if len(group) > 1:
                labs.append(topic_labs)
        else:
            labs.extend(topic_labs)

    if append_labs:
        kept = groups
    else:
        # drop empty topic groups; each removal also pops ONE label at the
        # group's index into the FLAT label list (reference quirk — the
        # index is not translated to a unit offset)
        kept = []
        removed = 0
        for gi, group in enumerate(groups):
            if group:
                kept.append(group)
            else:
                labs.pop(gi - removed)
                removed += 1

    # spans past the final topic end-time: zeros with a forced trailing 1
    if append_labs:
        if len(groups[-1]) > len(labs[-1]):
            labs[-1].extend([0] * len(segmentation[consumed:]))
    elif len(segmentation) > len(labs):
        labs.extend([0] * len(segmentation[consumed:]))
        labs[-1] = 1
    return kept, labs


def inference_uniform_units(audio_length_s: float, interval: float):
    """[(start_s, end_s)] with the reference's 1-second unit quirk."""
    n = int(audio_length_s // interval)
    return [(interval * i, interval * i + 1) for i in range(n)]


def to_sample(sample_rate: int, time: float) -> int:
    return int(sample_rate * time)


def to_time(sample_rate: int, samples: int) -> float:
    return samples / sample_rate
