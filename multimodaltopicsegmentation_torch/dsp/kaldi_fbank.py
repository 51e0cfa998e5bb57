"""Kaldi-compliant log-mel filter banks on the device: the front end of
w2v-BERT 2.0 (Hugging Face's `SeamlessM4TFeatureExtractor`), for a padded
batch in which each row is one utterance.

Per row of `n` valid samples:
1. the waveform times 2**15 (Kaldi reads 16-bit integers);
2. frames of 400 samples every 160, no centring: 1 + (n - 400) // 160 of
   them, none under 400 samples;
3. per frame: its mean removed, preemphasis 0.97 (x[0] *= 0.03, x[i] -=
   0.97 x[i - 1]), the povey window (a symmetric Hann window to the power
   0.85), the power spectrum of a 512-point FFT;
4. 80 triangular filters laid out and shaped in Kaldi's mel space (1127
   ln(1 + f / 700)) from 20 to 8000 Hz;
5. log(max(energy, 1.1920929e-7));
6. each bin normalised over the row's own valid frames: (x - mean) /
   sqrt(var + 1e-7), the variance with one degree of freedom taken; the
   frames past them zero;
7. frames stacked in pairs into rows of 160 (stride 2).

An odd frame count: the last frame counts in step 6 and lies in no valid
row. HF pads the frames to an even count and its attention mask marks a row
valid by its second frame, so a row of F frames has F // 2 valid rows; a
batch keeps F // 2 rows of its padded length (HF's extra row for an odd
padded count is masked for every row, and is dropped here).

Everything is float32 (HF runs steps 2-5 in float64 in numpy, with the FFT
rounded to complex64). A row of one valid frame has a variance of 0/0 in HF
(NaN); here it reads 0 and its features are 0.
"""
from __future__ import annotations

import functools

import torch

SCALE = 2.0 ** 15
WINDOW = 400
HOP = 160
N_FFT = 512
N_MELS = 80
PREEMPHASIS = 0.97
LOG_FLOOR = 1.192092955078125e-07
STRIDE = 2


def num_frames(n):
    """Frames of `n` samples (an int or an int tensor)."""
    if torch.is_tensor(n):
        return torch.where(n >= WINDOW, (n - WINDOW) // HOP + 1, torch.zeros_like(n))
    return (n - WINDOW) // HOP + 1 if n >= WINDOW else 0


def num_rows(n):
    """Valid rows of `n` samples: num_frames(n) // 2."""
    return num_frames(n) // STRIDE


def _kaldi_mel(f):
    return 1127.0 * torch.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=None)
def constants(device: str):
    """(povey window [400], mel filters [257, 80]) in float32 on `device`,
    worked out in float64 once a device."""
    window = torch.hann_window(WINDOW, periodic=False, dtype=torch.float64) ** 0.85
    edges = torch.linspace(float(_kaldi_mel(torch.tensor(20.0, dtype=torch.float64))),
                           float(_kaldi_mel(torch.tensor(8000.0, dtype=torch.float64))),
                           N_MELS + 2, dtype=torch.float64)
    bins = _kaldi_mel(torch.arange(N_FFT // 2 + 1, dtype=torch.float64) * (16000 / N_FFT))
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (bins[:, None] - lo) / (mid - lo)
    down = (hi - bins[:, None]) / (hi - mid)
    filters = torch.minimum(up, down).clamp_min(0.0)
    return window.float().to(device), filters.float().to(device)


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """audio [B, S] float32 -> log-mel energies [B, F, 80] of every frame of
    the padded length S (steps 1-5)."""
    B, S = audio.shape
    if S < WINDOW:
        return audio.new_zeros(B, 0, N_MELS)
    window, filters = constants(str(audio.device))
    x = audio.unfold(-1, WINDOW, HOP) * SCALE  # [B, F, 400]
    x = x - x.mean(-1, keepdim=True)
    x = torch.cat([x[..., :1] * (1.0 - PREEMPHASIS), x[..., 1:] - PREEMPHASIS * x[..., :-1]], -1)
    spec = torch.view_as_real(torch.fft.rfft(x * window, n=N_FFT))
    power = spec.square().sum(-1)  # [B, F, 257]
    return torch.log(torch.matmul(power, filters).clamp_min(LOG_FLOOR))


def normalize_bins(feats: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """feats [B, F, C], frames [B] (valid frames a row) -> each bin minus its
    mean over the row's valid frames, over sqrt(var + 1e-7) with one degree
    of freedom taken (step 6); the frames past them zero."""
    F = feats.shape[1]
    valid = (torch.arange(F, device=feats.device)[None, :] < frames[:, None]).to(feats.dtype)
    valid = valid[..., None]
    n = frames.to(feats.dtype)[:, None, None]
    mean = (feats * valid).sum(1, keepdim=True) / n.clamp_min(1.0)
    var = ((feats - mean).square() * valid).sum(1, keepdim=True) / (n - 1.0).clamp_min(1.0)
    return (feats - mean) / torch.sqrt(var + 1e-7) * valid


def stack_frames(feats: torch.Tensor) -> torch.Tensor:
    """[B, F, C] -> [B, F // 2, 2 C]: frames 2r and 2r + 1 side by side in
    row r (step 7); an odd last frame is dropped."""
    B, F, C = feats.shape
    return feats[:, : F - F % STRIDE].reshape(B, F // STRIDE, STRIDE * C)


def seamless_features(audio: torch.Tensor, lengths: torch.Tensor = None):
    """audio [B, S] float32, lengths [B] valid samples (None: all S) ->
    (rows [B, T, 160], valid rows [B], frames computed B x F)."""
    B, S = audio.shape
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int64, device=audio.device)
    frames = num_frames(lengths.to(device=audio.device, dtype=torch.int64))
    feats = log_mel(audio)
    rows = stack_frames(normalize_bins(feats, frames))
    return rows, frames // STRIDE, B * feats.shape[1]

