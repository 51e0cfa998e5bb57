"""ctypes bindings for the native C++ audio loader (csrc/audio_native.cpp):
the JAX package's runtime/audio_native.py with the same API (`read_wav`,
`read_wav_batch`, `resample`, `available`).

The library is built at first use by core/cuda_build.py with the host C++
compiler into build/torch_kernels/, never at import. There is no fallback: a
failed build raises with the compiler's log, and `available()` says False
only to a caller that asks.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..core import cuda_build

LIBRARY = "audio_native"
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(LIBRARY)
        lib.mts_read_wav.restype = ctypes.POINTER(ctypes.c_float)
        lib.mts_read_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.mts_resample.restype = ctypes.POINTER(ctypes.c_float)
        lib.mts_resample.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        lib.mts_free.restype = None
        lib.mts_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.mts_read_wav_batch.restype = None
        lib.mts_read_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built (building it now if needed)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _take(buf, n: int) -> np.ndarray:
    """Copy a malloc'd float buffer of the library into numpy and free it."""
    try:
        return np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        _load().mts_free(buf)


def read_wav(path: str, target_sr: int = 0):
    """-> (float32 mono samples, sample_rate). target_sr=0 keeps native rate."""
    n, sr = ctypes.c_int64(), ctypes.c_int()
    buf = _load().mts_read_wav(path.encode(), ctypes.byref(n), ctypes.byref(sr), target_sr)
    if not buf:
        raise RuntimeError(f"failed to read wav: {path}")
    return _take(buf, n.value), sr.value


def read_wav_batch(paths, target_sr: int = 0):
    """Decode + resample many wavs concurrently (OpenMP across files).
    -> list of (samples, sample_rate); failed files yield (None, 0)."""
    lib = _load()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outputs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    srs = (ctypes.c_int * n)()
    lib.mts_read_wav_batch(c_paths, n, target_sr, outputs, lens, srs)
    return [(_take(outputs[i], lens[i]), srs[i]) if outputs[i] else (None, 0)
            for i in range(n)]


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling of float32 mono audio."""
    audio = np.ascontiguousarray(audio, np.float32)
    n_out = ctypes.c_int64()
    buf = _load().mts_resample(audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio),
                               sr_in, sr_out, ctypes.byref(n_out))
    if not buf:
        raise RuntimeError("native resample failed")
    return _take(buf, n_out.value)
