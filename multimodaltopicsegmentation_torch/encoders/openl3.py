"""OpenL3 audio embeddings (counterpart of the JAX package's encoders/openl3.py;
the reference calls the openl3 package with mel128/env/512 weights for
training and mel256/music/512 for inference).

  48 kHz, 1 s windows, 0.1 s hop -> dB mel image (128 or 256 bands; n_fft
  2048, hop 242, 80 dB floor under each window's peak)
  -> VGG-ish trunk: [64, 64] + pool, [128, 128] + pool, [256, 256] + pool,
     [512, 512]; each conv 3x3 'same' -> BatchNorm (eps 1e-3) -> ReLU
  -> global max pool -> 512-d embedding per window.

`load_weights` reads the converted keras npz (conv{i}_{w,b} [kh, kw, cin,
cout], bn{i}_{scale,bias,mean,var}); `from_jax_params` maps the JAX pytree
onto the module's state_dict. Windows go to the card in chunks of 64
without row padding (the JAX package pads chunks to 32-row multiples only to
bound its compiled shapes; a 1-second unit is one window, so that padding
would multiply the work by 32).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.torch_setup import resolve_device
from ..dsp.spectral import frame_signal, hann_window, mel_filterbank
from ..utils.audio import resample

OPENL3_SR = 48000
WINDOW_S = 1.0
HOP_S = 0.1
CONV_BLOCKS = ((64, 64), (128, 128), (256, 256), (512, 512))


def mel_image(windows: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[N, S] 48 kHz windows -> [N, n_mels, T] dB mel images."""
    n_fft, hop = 2048, 242
    frames = frame_signal(windows, n_fft, hop, center=True)
    win = torch.from_numpy(hann_window(n_fft).astype(np.float32)).to(windows.device)
    spec = torch.fft.rfft(frames * win, dim=-1).abs() ** 2
    bank = torch.from_numpy(mel_filterbank(OPENL3_SR, n_fft, n_mels)).to(windows.device)
    db = 10.0 * torch.log10((spec @ bank.T).clamp_min(1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    return db.transpose(1, 2)


class OpenL3(nn.Module):
    def __init__(self):
        super().__init__()
        convs, bns, cin = [], [], 1
        for block in CONV_BLOCKS:
            for cout in block:
                convs.append(nn.Conv2d(cin, cout, 3, padding=1))
                bns.append(nn.BatchNorm2d(cout, eps=1e-3))
                cin = cout
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)

    def forward(self, windows: torch.Tensor, n_mels: int) -> torch.Tensor:
        """[N, S] 1-s 48 kHz windows -> [N, 512]."""
        x = mel_image(windows, n_mels)[:, None]  # [N, 1, n_mels, T]
        i = 0
        for b, block in enumerate(CONV_BLOCKS):
            for _ in block:
                x = F.relu(self.bns[i](self.convs[i](x)))
                i += 1
            if b < len(CONV_BLOCKS) - 1:
                x = F.max_pool2d(x, 2)
        return x.amax(dim=(2, 3))


def from_jax_params(params: dict) -> dict:
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd, i = {}, 0
    for block in params["blocks"]:
        for lp in block:
            sd[f"convs.{i}.weight"] = t(np.transpose(np.asarray(lp["w"]), (3, 2, 0, 1)))
            sd[f"convs.{i}.bias"] = t(lp["b"])
            for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                 ("running_mean", "mean"), ("running_var", "var")):
                sd[f"bns.{i}.{ours}"] = t(lp["bn"][theirs])
            sd[f"bns.{i}.num_batches_tracked"] = torch.tensor(0)
            i += 1
    return sd


def load_weights(npz_path: str) -> dict:
    """Converted keras weights -> the JAX pytree layout (numpy leaves)."""
    with np.load(npz_path) as data:
        blocks, i = [], 0
        for block in CONV_BLOCKS:
            layers = []
            for _ in block:
                layers.append({"w": data[f"conv{i}_w"], "b": data[f"conv{i}_b"],
                               "bn": {k: data[f"bn{i}_{k}"]
                                      for k in ("scale", "bias", "mean", "var")}})
                i += 1
            blocks.append(layers)
    return {"blocks": blocks}


def random_state_dict(generator: torch.Generator) -> dict:
    """He-normal conv weights (sqrt(2 / (9 cin))), zero biases, unit BatchNorm."""
    model = OpenL3()
    with torch.no_grad():
        for conv in model.convs:
            cin = conv.weight.shape[1]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                              * np.sqrt(2.0 / (9 * cin)))
            conv.bias.zero_()
    return model.state_dict()


class OpenL3Encoder:
    """Engine adapter: per unit, the 512-d embeddings of its 1-s windows."""

    name = "openl3"
    dim = 512
    frame_level = True

    def __init__(self, n_mels: int = 128, weights: str = None, device="cuda"):
        self.n_mels = n_mels
        self.device = resolve_device(device)
        # the variant-specific env var first, so exporting both variants'
        # weights never cross-loads (their conv shapes are equal)
        weights = (weights
                   or os.environ.get(f"MTS_OPENL3_WEIGHTS_MEL{n_mels}")
                   or os.environ.get("MTS_OPENL3_WEIGHTS"))
        self.model = OpenL3()
        if weights:
            self.model.load_state_dict(from_jax_params(load_weights(weights)))
        elif os.environ.get("MTS_RANDOM_ENCODER_WEIGHTS") == "1":
            print("WARNING: openl3 running with RANDOM weights (smoke mode)")
            self.model.load_state_dict(random_state_dict(torch.Generator().manual_seed(0)))
        else:
            raise RuntimeError(
                "openl3 weights unavailable in this environment; pass a "
                "converted .npz via weights= / MTS_OPENL3_WEIGHTS or set "
                "MTS_RANDOM_ENCODER_WEIGHTS=1"
            )
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def encode_document(self, audio, bounds, chunk=64):
        """audio is 16 kHz; OpenL3 runs at 48 kHz on 1 s windows every 0.1 s."""
        audio48 = resample(audio, 16000, OPENL3_SR)
        win = int(WINDOW_S * OPENL3_SR)
        hop = int(HOP_S * OPENL3_SR)
        outs = []
        for s16, e16 in bounds:
            seg = audio48[s16 * 3 : e16 * 3]
            if len(seg) < win:
                seg = np.pad(seg, (0, win - len(seg)))
            starts = np.arange(0, max(len(seg) - win, 0) + 1, hop)
            windows = np.stack([seg[st : st + win] for st in starts])
            embs = []
            for i in range(0, len(windows), chunk):
                x = torch.from_numpy(np.ascontiguousarray(windows[i : i + chunk], np.float32))
                embs.append(self.model(x.to(self.device), self.n_mels).cpu().numpy())
            outs.append(np.concatenate(embs, axis=0))
        return outs
