"""Audio IO for the port: WAV decode through scipy, polyphase resampling.

Counterpart of the JAX package's utils/audio.py without its native C++
loader and its mp3 decoder (both still to be ported, see ROADMAP.md).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from math import gcd
from typing import Tuple

import numpy as np


def load_audio(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """-> (mono float32 in [-1, 1] at target_sr, target_sr)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mp3":
        raise NotImplementedError(
            f"{path}: mp3 decoding is not ported yet; convert to wav first"
        )
    if ext != ".wav":
        raise ValueError(f"unsupported audio format: {path}")
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    audio = _to_float_mono(data)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    return audio.astype(np.float32), target_sr


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    # scale by the integer dtype before averaging channels, which promotes
    # to float and would skip the scaling
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def save_wav(path: str, audio: np.ndarray, sr: int):
    from scipy.io import wavfile

    wavfile.write(path, sr, audio)


def prefetch_audio(paths, target_sr: int = 16000, window: int = 2):
    """Yield (path, audio, sr), decoding up to `window` documents ahead of
    the consumer on host threads (scipy's decode releases the GIL)."""
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=window) as pool:
        futures = [pool.submit(load_audio, p, target_sr) for p in paths[: window + 1]]
        for i, p in enumerate(paths):
            audio, sr = futures[i].result()
            nxt = i + window + 1
            if nxt < len(paths):
                futures.append(pool.submit(load_audio, paths[nxt], target_sr))
            yield p, audio, sr
