"""Audio IO for the port: WAV and MP3 decode, polyphase resampling.

Counterpart of the JAX package's utils/audio.py, which runs its native path:
- WAV (PCM16/24/32, float32, any channel count) decodes through the native
  C++ loader (runtime/audio_native.py, built at first use). Unlike the JAX
  module there is no scipy fallback: a failed build raises.
- MP3 decodes through SDL_mixer via pygame, imported only inside
  `_decode_mp3`, at 44.1 kHz, under one lock; without pygame it raises the
  JAX module's message naming the missing decoder.
- Resampling to the target rate is scipy's `resample_poly`, as in the JAX
  module's `resample` (its native loader reads at the file's own rate), so
  decoded audio is JAX's to the bit.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from math import gcd
from typing import Tuple

import numpy as np

from ..runtime import audio_native

# MP3s decode to this intermediate rate (SDL_mixer converts on load; 44.1 k is
# the native rate of nearly all broadcast mp3s), then `resample` takes it to
# target_sr
_MP3_DECODE_SR = 44100
# created eagerly: a lazy check-then-act would race when prefetch_audio's
# worker threads reach their first .mp3 files together
_mp3_lock = threading.Lock()


def _decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """mp3 -> (mono float32, sr) via SDL_mixer (pygame), whose decode keeps
    the duration at any requested rate."""
    try:
        os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
        import pygame
        import pygame.sndarray
    except ImportError as e:
        raise RuntimeError(
            f"{path}: mp3 decoding needs the 'pygame' package (SDL_mixer) "
            "or a prior conversion to wav (`ffmpeg -i in.mp3 out.wav`); "
            "neither ffmpeg nor pygame is available here."
        ) from e

    # pygame's mixer is process-global state: one decode at a time (the
    # prefetcher runs load_audio from worker threads)
    with _mp3_lock:
        if not pygame.mixer.get_init():
            pygame.mixer.init(frequency=_MP3_DECODE_SR, size=-16, channels=2)
        freq, _size, _ch = pygame.mixer.get_init()
        data = pygame.sndarray.array(pygame.mixer.Sound(path))
    return _to_float_mono(np.asarray(data)), freq


def load_audio(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """-> (mono float32 in [-1, 1] at target_sr, target_sr)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mp3":
        audio, sr = _decode_mp3(path)
    elif ext == ".wav":
        audio, sr = audio_native.read_wav(path)
    else:
        raise ValueError(f"unsupported audio format: {path}")
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
    the consumer on host threads (the native loader's ctypes call and
    scipy's resampling release the GIL)."""
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=window) as pool:
        futures = [pool.submit(load_audio, p, target_sr) for p in paths[: window + 1]]
        for i, p in enumerate(paths):
            audio, sr = futures[i].result()
            nxt = i + window + 1
            if nxt < len(paths):
                futures.append(pool.submit(load_audio, paths[nxt], target_sr))
            yield p, audio, sr
