"""CRDNN voice-activity posterior network (counterpart of the JAX package's
encoders/crdnn_vad.py: SpeechBrain's vad-crdnn that the reference training
extractor runs, extract_embeddings.py:116-121).

- `vad_fbank`: SpeechBrain's VAD front-end on the device: centred ZERO-padded
  25 ms / 10 ms frames, periodic Hamming window, power spectrum, 40 HTK mel
  filters, 10 log10 with a per-utterance 80 dB floor, sentence mean removed;
- `CRDNN`: conv2d blocks ('same' padding, LayerNorm over (freq, channel),
  leaky ReLU, frequency max-pool) -> bidirectional LSTM (cuDNN; rows are
  whole documents, so no packing) -> dense blocks with eval-mode BatchNorm -> sigmoid, its geometry
  read from the flat parameter dict;
- the flat dict is the npz schema of `tools/convert_weights.py crdnn_vad`:
  cnn{i}_w [kt, kf, cin, cout], cnn{i}_b, cnn{i}_ln_scale/_bias [f_i, cout],
  cnn{i}_pool, rnn_l{j}_{fwd,bwd}_{w_ih [in, 4H], w_hh [H, 4H], b | b_ih,
  b_hh}, dnn{j}_w [in, out], dnn{j}_b, dnn{j}_bn_{scale,bias,mean,var},
  out_w [in, 1], out_b. `from_jax_params` maps it onto the module's
  state_dict; `random_params` draws one from a torch.Generator.

A document's posteriors come from one forward over its whole length.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.torch_setup import resolve_device
from ..ops import rnn as R

SR = 16000
N_MELS = 40
WIN, HOP = 400, 160  # 25 ms / 10 ms at 16 kHz (speechbrain Fbank defaults)
LEAKY_SLOPE = 0.01  # torch.nn.LeakyReLU default used by the CRDNN lobe


def htk_mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filters on the HTK mel scale, without
    Slaney area normalisation (speechbrain.processing.features.Filterbank)."""
    hz_to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)  # noqa: E731
    mel_to_hz = lambda m: 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)  # noqa: E731
    fftfreqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0, np.minimum(lower, upper)).astype(np.float32)


def hamming_window(n: int) -> np.ndarray:
    """Periodic Hamming, matching torch.hamming_window(n)."""
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def vad_fbank(audio: torch.Tensor) -> torch.Tensor:
    """[S] 16 kHz audio -> [1 + S // 160, 40] normalised log-mel features."""
    from ..dsp.spectral import frame_signal

    audio = F.pad(audio, (WIN // 2, WIN // 2))  # constant (zero) centring
    frames = frame_signal(audio, WIN, HOP, center=False)
    win = torch.from_numpy(hamming_window(WIN)).to(audio.device)
    spec = torch.fft.rfft(frames * win, n=WIN, dim=-1).abs() ** 2
    bank = torch.from_numpy(htk_mel_filterbank(SR, WIN, N_MELS)).to(audio.device)
    db = 10.0 * torch.log10((spec @ bank.T).clamp_min(1e-10))
    db = torch.maximum(db, db.max() - 80.0)
    return db - db.mean(dim=0, keepdim=True)


def _count(params: dict, prefix: str, suffix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix) and k.endswith(suffix))


class CRDNN(nn.Module):
    """[B, T, 40] features -> [B, T] speech posteriors; geometry from the
    flat parameter dict (shapes only)."""

    def __init__(self, params: dict):
        super().__init__()
        n_cnn = _count(params, "cnn", "_w")
        self.pools = [int(params[f"cnn{i}_pool"]) for i in range(n_cnn)]
        self.convs = nn.ModuleList()
        self.ln_scale = nn.ParameterList()
        self.ln_bias = nn.ParameterList()
        for i in range(n_cnn):
            kt, kf, cin, cout = np.shape(params[f"cnn{i}_w"])
            self.convs.append(nn.Conv2d(cin, cout, (kt, kf), padding="same"))
            self.ln_scale.append(nn.Parameter(torch.ones(np.shape(params[f"cnn{i}_ln_scale"]))))
            self.ln_bias.append(nn.Parameter(torch.zeros(np.shape(params[f"cnn{i}_ln_bias"]))))
        n_rnn = _count(params, "rnn_l", "_fwd_w_ih")
        in_dim, four_h = np.shape(params["rnn_l0_fwd_w_ih"])
        self.rnn = nn.LSTM(in_dim, four_h // 4, num_layers=n_rnn, bidirectional=True,
                           batch_first=True)
        self.dnn = nn.ModuleList()
        self.bns = nn.ModuleList()
        for j in range(_count(params, "dnn", "_w")):
            d_in, d_out = np.shape(params[f"dnn{j}_w"])
            self.dnn.append(nn.Linear(d_in, d_out))
            self.bns.append(nn.BatchNorm1d(d_out, eps=1e-5))
        self.out = nn.Linear(np.shape(params["out_w"])[0], 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        B, T = feats.shape[:2]
        x = feats[..., None]  # [B, T, F, C]
        for conv, scale, bias, pool in zip(self.convs, self.ln_scale, self.ln_bias, self.pools):
            x = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            x = F.layer_norm(x, tuple(scale.shape), scale, bias, eps=1e-5)
            x = F.leaky_relu(x, LEAKY_SLOPE)
            if pool > 1:
                f2 = (x.shape[2] // pool) * pool
                x = x[:, :, :f2].reshape(B, T, f2 // pool, pool, x.shape[3]).amax(dim=3)
        x = self.rnn(x.reshape(B, T, -1))[0]
        for lin, bn in zip(self.dnn, self.bns):
            x = F.leaky_relu(bn(lin(x).transpose(1, 2)).transpose(1, 2), LEAKY_SLOPE)
        return torch.sigmoid(self.out(x)[..., 0])


def from_jax_params(params: dict) -> dict:
    """Flat npz / JAX parameter dict -> CRDNN state_dict."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {}
    for i in range(_count(params, "cnn", "_w")):
        sd[f"convs.{i}.weight"] = t(np.transpose(np.asarray(params[f"cnn{i}_w"]), (3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = t(params[f"cnn{i}_b"])
        sd[f"ln_scale.{i}"] = t(params[f"cnn{i}_ln_scale"])
        sd[f"ln_bias.{i}"] = t(params[f"cnn{i}_ln_bias"])
    layers = []
    for j in range(_count(params, "rnn_l", "_fwd_w_ih")):
        layers.append({d: {k[len(f"rnn_l{j}_{d}_"):]: v for k, v in params.items()
                           if k.startswith(f"rnn_l{j}_{d}_")} for d in ("fwd", "bwd")})
    sd.update(R.from_jax_params(layers, prefix="rnn"))
    for j in range(_count(params, "dnn", "_w")):
        sd[f"dnn.{j}.weight"] = t(np.transpose(params[f"dnn{j}_w"]))
        sd[f"dnn.{j}.bias"] = t(params[f"dnn{j}_b"])
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"bns.{j}.{ours}"] = t(params[f"dnn{j}_bn_{theirs}"])
        sd[f"bns.{j}.num_batches_tracked"] = torch.tensor(0)
    sd["out.weight"] = t(np.transpose(params["out_w"]))
    sd["out.bias"] = t(params["out_b"])
    return sd


def build(params: dict, device) -> CRDNN:
    """A CRDNN in eval mode on `device` holding `params` (flat dict)."""
    model = CRDNN(params)
    model.load_state_dict(from_jax_params(params))
    return model.to(resolve_device(device)).eval()


@torch.inference_mode()
def posteriors(model: CRDNN, audio: np.ndarray, sr: int) -> np.ndarray:
    """Whole-document speech posteriors on the 10 ms grid, one forward."""
    audio = np.asarray(audio)
    if audio.size == 0:
        return np.zeros((0,), np.float32)
    if sr != SR:
        from ..utils.audio import resample

        audio = resample(audio, sr, SR)
    device = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(device)
    return model(vad_fbank(x)[None])[0].cpu().numpy()


def load_npz(path: str) -> dict:
    """Read a checkpoint written by tools/convert_weights.py crdnn_vad."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def random_params(generator: torch.Generator, cnn_channels=(16, 32), cnn_kernel=(3, 3),
                  pool=2, rnn_layers=2, rnn_neurons=32, dnn_blocks=1, dnn_neurons=16,
                  n_mels: int = N_MELS) -> dict:
    """A random CRDNN of the published vad-crdnn-libriparty geometry as a
    flat numpy dict (the npz schema)."""
    def normal(*shape):
        return (0.1 * torch.randn(*shape, generator=generator)).numpy()

    params = {}
    cin, f = 1, n_mels
    for i, cout in enumerate(cnn_channels):
        params[f"cnn{i}_w"] = normal(cnn_kernel[0], cnn_kernel[1], cin, cout)
        params[f"cnn{i}_b"] = np.zeros((cout,), np.float32)
        params[f"cnn{i}_ln_scale"] = np.ones((f, cout), np.float32)
        params[f"cnn{i}_ln_bias"] = np.zeros((f, cout), np.float32)
        params[f"cnn{i}_pool"] = np.asarray(pool, np.int32)
        cin, f = cout, f // pool
    lstm = nn.LSTM(f * cin, rnn_neurons, num_layers=rnn_layers, bidirectional=True)
    R.tf_init(lstm, generator)
    for j, layer in enumerate(R.to_jax_params({f"rnn.{k}": v for k, v in lstm.state_dict().items()},
                                              rnn_layers, True)):
        for d, p in layer.items():
            for name, v in p.items():
                params[f"rnn_l{j}_{d}_{name}"] = v
    in_dim = 2 * rnn_neurons
    for j in range(dnn_blocks):
        params[f"dnn{j}_w"] = normal(in_dim, dnn_neurons)
        params[f"dnn{j}_b"] = np.zeros((dnn_neurons,), np.float32)
        params[f"dnn{j}_bn_scale"] = np.ones((dnn_neurons,), np.float32)
        params[f"dnn{j}_bn_bias"] = np.zeros((dnn_neurons,), np.float32)
        params[f"dnn{j}_bn_mean"] = np.zeros((dnn_neurons,), np.float32)
        params[f"dnn{j}_bn_var"] = np.ones((dnn_neurons,), np.float32)
        in_dim = dnn_neurons
    params["out_w"] = normal(in_dim, 1)
    params["out_b"] = np.zeros((1,), np.float32)
    return params
