"""Speaker-embedding encoders x-vector and ECAPA-TDNN (counterpart of the JAX
package's encoders/tdnn.py; the reference runs SpeechBrain's pretrained
stacks, extract_embeddings.py:140-143,197).

- x-vector (Snyder et al. 2018): 5 TDNN layers (512, 512, 512, 512, 1500),
  conv -> ReLU -> BatchNorm, over 24 log-mel fbanks; masked statistics
  pooling (mean || std) and a linear map to 512;
- ECAPA-TDNN (Desplanques et al. 2020): conv stem over 80 fbanks, 3
  SE-Res2Net blocks (dilations 2/3/4, scale 8), multi-layer aggregation,
  attentive statistics pooling with global context, linear to 192.

Both are `nn.Module`s over `[B, C, T]` rows. Every convolution pads 'same'
with REFLECT, as SpeechBrain's Conv1d does, by index arithmetic (the pad can
exceed a short row). A BatchNorm without running statistics (the x-vector's
random init) normalises each row over all its frames, padding included, as
the JAX package's per-utterance `_bn` does. `from_jax_params` maps the JAX
pytrees onto the state_dicts; `xvector_load_npz` / `ecapa_load_npz` read the
flat npz schemas of tools/convert_weights.py into those pytrees.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.torch_setup import resolve_device
from ..dsp.spectral import (frame_signal, hann_window, mel_filterbank, melspectrogram,
                            power_to_db, reflect_index)
from .engine_util import bucket_rows, pad_units

SR = 16000
ECAPA_DILATIONS = (2, 3, 4)
XVEC_LAYERS = (
    # (kernel, dilation, out)
    (5, 1, 512),
    (3, 2, 512),
    (3, 3, 512),
    (1, 1, 512),
    (1, 1, 1500),
)


def _fbank(y: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, S] -> [B, T, n_mels] log-mel features (400/160 at 16 kHz, n_fft 512)."""
    frames = frame_signal(y, 400, 160, center=True)
    win = torch.from_numpy(hann_window(400).astype(np.float32)).to(y.device)
    spec = torch.fft.rfft(frames * win, n=512, dim=-1).abs() ** 2
    bank = torch.from_numpy(mel_filterbank(SR, 512, n_mels)).to(y.device)
    return torch.log(spec @ bank.T + 1e-10)


class _Conv(nn.Module):
    """Conv1d over [B, C, T] with 'same' reflect padding."""

    def __init__(self, cin, cout, kernel, dilation=1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, dilation=dilation)
        self.pad = (kernel - 1) * dilation // 2

    def forward(self, x):
        if self.pad > 0:
            idx = reflect_index(x.shape[-1], self.pad, self.pad)
            x = x[..., torch.from_numpy(idx).to(x.device)]
        return self.conv(x)


class _BN(nn.Module):
    """Eval BatchNorm over [B, C, T] (or [B, C]); with no running statistics,
    each row is normalised over its own frames (biased variance)."""

    def __init__(self, c, running: bool, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        if running:
            self.register_buffer("running_mean", torch.zeros(c))
            self.register_buffer("running_var", torch.ones(c))
        else:
            self.running_mean = self.running_var = None

    def forward(self, x):
        shape = (-1, 1) if x.dim() == 3 else (-1,)
        if self.running_mean is not None:
            mu, var = self.running_mean.view(shape), self.running_var.view(shape)
        else:
            mu = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, unbiased=False, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + self.eps) * self.weight.view(shape)
                + self.bias.view(shape))


class _TDNNBlock(nn.Module):
    """speechbrain TDNNBlock: Conv1d -> ReLU -> BatchNorm1d."""

    def __init__(self, cin, cout, kernel, dilation=1, running=True):
        super().__init__()
        self.conv = _Conv(cin, cout, kernel, dilation)
        self.bn = _BN(cout, running)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


def _masked_stats(x, m, cnt):
    """x [B, C, T], m [B, 1, T] -> (mean, std floor 1e-10 on the variance)."""
    mean = (x * m).sum(dim=-1) / cnt
    var = (m * (x - mean[..., None]) ** 2).sum(dim=-1) / cnt
    return mean, torch.sqrt(var.clamp_min(1e-10))


class XVector(nn.Module):
    def __init__(self, n_mels: int = 24, emb_dim: int = 512, running_bn: bool = False):
        super().__init__()
        layers, cin = [], n_mels
        for k, d, out in XVEC_LAYERS:
            layers.append(_TDNNBlock(cin, out, k, d, running_bn))
            cin = out
        self.tdnn = nn.ModuleList(layers)
        self.emb = nn.Linear(2 * cin, emb_dim)

    def forward(self, feats, frame_mask):
        """feats [B, T, n_mels], frame_mask [B, T] -> [B, emb_dim]."""
        x = feats.transpose(1, 2)
        for layer in self.tdnn:
            x = layer(x)
        m = frame_mask[:, None, :]
        mean, std = _masked_stats(x, m, m.sum(dim=-1).clamp_min(1.0))
        return self.emb(torch.cat([mean, std], dim=-1))


class _SERes2Block(nn.Module):
    def __init__(self, channels, dilation, scale, se_channels):
        super().__init__()
        width = channels // scale
        self.scale = scale
        self.tdnn1 = _TDNNBlock(channels, channels, 1)
        self.res2net = nn.ModuleList(_TDNNBlock(width, width, 3, dilation)
                                     for _ in range(scale - 1))
        self.tdnn2 = _TDNNBlock(channels, channels, 1)
        self.se1 = nn.Linear(channels, se_channels)
        self.se2 = nn.Linear(se_channels, channels)

    def forward(self, x, m, cnt):
        h = self.tdnn1(x)
        chunks = torch.chunk(h, self.scale, dim=1)
        ys, prev = [chunks[0]], None
        for i, sub in enumerate(self.res2net):
            prev = sub(chunks[i + 1] if prev is None else chunks[i + 1] + prev)
            ys.append(prev)
        h = self.tdnn2(torch.cat(ys, dim=1))
        # squeeze-excitation over the masked time mean
        s = (h * m).sum(dim=-1) / cnt
        s = torch.sigmoid(self.se2(F.relu(self.se1(s))))
        return x + h * s[..., None]


class ECAPA(nn.Module):
    def __init__(self, n_mels: int = 80, channels: int = 512, emb_dim: int = 192,
                 scale: int = 8, se_channels: int = 128, attn_channels: int = 128):
        super().__init__()
        mfa = 3 * channels
        self.stem = _TDNNBlock(n_mels, channels, 5)
        self.blocks = nn.ModuleList(_SERes2Block(channels, d, scale, se_channels)
                                    for d in ECAPA_DILATIONS)
        self.mfa = _TDNNBlock(channels * 3, mfa, 1)
        self.asp_tdnn = _TDNNBlock(mfa * 3, attn_channels, 1)
        self.asp_conv = nn.Conv1d(attn_channels, mfa, 1)
        self.asp_bn = _BN(2 * mfa, running=True)
        self.fc = nn.Linear(2 * mfa, emb_dim)

    def forward(self, feats, frame_mask):
        """feats [B, T, n_mels], frame_mask [B, T] -> [B, emb_dim]."""
        m = frame_mask[:, None, :]
        cnt = m.sum(dim=-1).clamp_min(1.0)
        x = self.stem(feats.transpose(1, 2))
        outs = []
        for block in self.blocks:
            x = block(x, m, cnt)
            outs.append(x)
        h = self.mfa(torch.cat(outs, dim=1))

        # attentive statistics pooling with global context
        mu, sg = _masked_stats(h, m, cnt)
        T = h.shape[-1]
        ctx = torch.cat([h, mu[..., None].expand(-1, -1, T), sg[..., None].expand(-1, -1, T)],
                        dim=1)
        a = self.asp_conv(torch.tanh(self.asp_tdnn(ctx)))
        a = torch.softmax(torch.where(m > 0, a, -1e9), dim=-1)
        mean = (a * h).sum(dim=-1)
        var = (a * (h - mean[..., None]) ** 2).sum(dim=-1)
        stats = torch.cat([mean, torch.sqrt(var.clamp_min(1e-10))], dim=-1)
        return self.fc(self.asp_bn(stats))


# ---------------------------------------------------------------------------
# weights: JAX pytrees <-> state_dicts, npz schemas
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _conv_sd(prefix, p):
    return {f"{prefix}.weight": _t(np.transpose(np.asarray(p["w"]), (2, 1, 0))),
            f"{prefix}.bias": _t(p["b"])}


def _bn_sd(prefix, bn):
    sd = {f"{prefix}.weight": _t(bn["scale"]), f"{prefix}.bias": _t(bn["bias"])}
    if "mean" in bn:
        sd[f"{prefix}.running_mean"] = _t(bn["mean"])
        sd[f"{prefix}.running_var"] = _t(bn["var"])
    return sd


def _block_sd(prefix, p):
    return {**_conv_sd(f"{prefix}.conv.conv", p), **_bn_sd(f"{prefix}.bn", p["bn"])}


def _linear_sd(prefix, w, b):
    return {f"{prefix}.weight": _t(np.transpose(np.asarray(w))), f"{prefix}.bias": _t(b)}


def xvector_from_jax_params(params: dict) -> dict:
    sd = {}
    for i, lp in enumerate(params["tdnn"]):
        sd.update(_block_sd(f"tdnn.{i}", lp))
    sd.update(_linear_sd("emb", params["emb_w"], params["emb_b"]))
    return sd


def ecapa_from_jax_params(params: dict) -> dict:
    sd = _block_sd("stem", params["stem"])
    for j, block in enumerate(params["blocks"]):
        pre = f"blocks.{j}"
        sd.update(_block_sd(f"{pre}.tdnn1", block["tdnn1"]))
        for i, sub in enumerate(block["res2net"]):
            sd.update(_block_sd(f"{pre}.res2net.{i}", sub))
        sd.update(_block_sd(f"{pre}.tdnn2", block["tdnn2"]))
        for se in ("se1", "se2"):
            sd.update(_linear_sd(f"{pre}.{se}", np.asarray(block[se]["w"])[0], block[se]["b"]))
    sd.update(_block_sd("mfa", params["mfa"]))
    sd.update(_block_sd("asp_tdnn", params["asp_tdnn"]))
    sd.update(_conv_sd("asp_conv", params["asp_conv"]))
    sd.update(_bn_sd("asp_bn", params["asp_bn"]))
    sd.update(_linear_sd("fc", params["fc_w"], params["fc_b"]))
    return sd


def _bn_from(d, prefix):
    bn = {"scale": np.asarray(d[f"{prefix}_scale"]), "bias": np.asarray(d[f"{prefix}_bias"])}
    if f"{prefix}_mean" in d:
        bn["mean"] = np.asarray(d[f"{prefix}_mean"])
        bn["var"] = np.asarray(d[f"{prefix}_var"])
    return bn


def _tdnn_from(d, prefix):
    return {"w": np.asarray(d[f"{prefix}_w"]), "b": np.asarray(d[f"{prefix}_b"]),
            "bn": _bn_from(d, f"{prefix}_bn")}


def _open(path_or_dict):
    if isinstance(path_or_dict, (str, os.PathLike)):
        with np.load(path_or_dict) as z:
            return {k: z[k] for k in z.files}
    return path_or_dict


def xvector_load_npz(path_or_dict) -> dict:
    """Flat npz (tdnn{i}_w/_b/_bn_* + emb_w[/emb_b]) -> x-vector pytree."""
    d = _open(path_or_dict)
    params = {"tdnn": [_tdnn_from(d, f"tdnn{i}") for i in range(len(XVEC_LAYERS))]}
    params["emb_w"] = np.asarray(d["emb_w"])
    params["emb_b"] = (np.asarray(d["emb_b"]) if "emb_b" in d
                       else np.zeros((params["emb_w"].shape[1],), np.float32))
    return params


def ecapa_load_npz(path_or_dict, scale: int = 8) -> dict:
    """Flat npz (tools/convert_weights.py map_ecapa_state_dict) -> ECAPA pytree."""
    d = _open(path_or_dict)
    p = {"stem": _tdnn_from(d, "stem"), "blocks": []}
    for j in range(len(ECAPA_DILATIONS)):
        p["blocks"].append({
            "tdnn1": _tdnn_from(d, f"block{j}_tdnn1"),
            "res2net": [_tdnn_from(d, f"block{j}_res2net{i}") for i in range(scale - 1)],
            "tdnn2": _tdnn_from(d, f"block{j}_tdnn2"),
            "se1": {"w": np.asarray(d[f"block{j}_se1_w"]), "b": np.asarray(d[f"block{j}_se1_b"])},
            "se2": {"w": np.asarray(d[f"block{j}_se2_w"]), "b": np.asarray(d[f"block{j}_se2_b"])},
        })
    p["mfa"] = _tdnn_from(d, "mfa")
    p["asp_tdnn"] = _tdnn_from(d, "asp_tdnn")
    p["asp_conv"] = {"w": np.asarray(d["asp_conv_w"]), "b": np.asarray(d["asp_conv_b"])}
    p["asp_bn"] = _bn_from(d, "asp_bn")
    p["fc_w"] = np.asarray(d["fc_w"])
    p["fc_b"] = (np.asarray(d["fc_b"]) if "fc_b" in d
                 else np.zeros((p["fc_w"].shape[1],), np.float32))
    return p


# ---------------------------------------------------------------------------
# engine adapters
# ---------------------------------------------------------------------------


def _require_weights(name):
    if os.environ.get("MTS_RANDOM_ENCODER_WEIGHTS") != "1":
        raise RuntimeError(
            f"encoder '{name}' needs SpeechBrain pretrained weights that are "
            "not available in this environment. Set "
            "MTS_RANDOM_ENCODER_WEIGHTS=1 for a random-weight smoke test, or "
            "provide a converted checkpoint."
        )
    print(f"WARNING: encoder '{name}' running with RANDOM weights (smoke mode)")


def _random_state_dict(model: nn.Module, generator: torch.Generator) -> dict:
    """Scaled-normal conv/linear weights (1/sqrt(fan_in); 0.01 on the
    embedding head), zero biases, unit BatchNorm: the JAX inits' scheme
    drawn from a torch.Generator."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                w = mod.weight
                fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
                std = 0.01 if name in ("emb", "fc") else fan_in ** -0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                mod.bias.zero_()
    return model.state_dict()


def xvector_random_state_dict(generator: torch.Generator) -> dict:
    return _random_state_dict(XVector(), generator)


def ecapa_random_state_dict(generator: torch.Generator) -> dict:
    return _random_state_dict(ECAPA(), generator)


class _PooledEncoder:
    """Unit-level encoders over fbanks: `pad_units` rows in chunks, row-bucketed."""

    frame_level = False

    def __init__(self, model: nn.Module, device, n_mels: int, chunk: int):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_mels, self.chunk = n_mels, chunk

    @torch.inference_mode()
    def encode_document(self, audio, bounds, chunk=None):
        chunk = chunk or self.chunk
        units, lens = pad_units(audio, bounds, bucket=True)
        outs = []
        for i in range(0, len(bounds), chunk):
            n = min(chunk, len(bounds) - i)
            u, l = bucket_rows(units[i : i + chunk], lens[i : i + chunk], 32, cap=chunk)
            feats = _fbank(torch.from_numpy(u).to(self.device), self.n_mels)
            T = feats.shape[1]
            fmask = (np.arange(T)[None, :] < (1 + l[:, None] // 160)).astype(np.float32)
            emb = self.model(feats, torch.from_numpy(fmask).to(self.device))
            outs.append(emb[:n].cpu().numpy())
        return [e for e in np.concatenate(outs, axis=0)]


class XVectorEncoder(_PooledEncoder):
    name = "x-vectors"
    dim = 512

    def __init__(self, weights: str = None, device="cuda"):
        weights = weights or os.environ.get("MTS_XVECTOR_WEIGHTS")
        if weights:
            params = xvector_load_npz(weights)
            model = XVector(emb_dim=params["emb_w"].shape[1],
                            running_bn="mean" in params["tdnn"][0]["bn"])
            model.load_state_dict(xvector_from_jax_params(params))
        else:
            _require_weights(self.name)
            model = XVector()
            model.load_state_dict(xvector_random_state_dict(torch.Generator().manual_seed(0)))
        super().__init__(model, device, n_mels=24, chunk=128)


class EcapaEncoder(_PooledEncoder):
    name = "ecapa"
    dim = 192

    def __init__(self, weights: str = None, device="cuda"):
        weights = weights or os.environ.get("MTS_ECAPA_WEIGHTS")
        model = ECAPA()
        if weights:
            model.load_state_dict(ecapa_from_jax_params(ecapa_load_npz(weights)))
        else:
            _require_weights(self.name)
            model.load_state_dict(ecapa_random_state_dict(torch.Generator().manual_seed(0)))
        super().__init__(model, device, n_mels=80, chunk=64)


class RandomProjectionEncoder:
    """Smoke-mode stand-in for weightless encoders: a fixed random projection
    (numpy default_rng(0), as in the JAX package) of log-mel statistics."""

    def __init__(self, dim, frame_level=False, device="cuda"):
        self.dim = dim
        self.frame_level = frame_level
        self.device = resolve_device(device)
        self._proj = np.random.default_rng(0).standard_normal((128, dim)).astype(np.float32) * 0.1

    @torch.inference_mode()
    def encode_document(self, audio, bounds, chunk=256):
        units, _ = pad_units(audio, bounds, bucket=True)
        outs = []
        for i in range(0, len(units), chunk):
            n = min(chunk, len(units) - i)
            u, _ = bucket_rows(units[i : i + chunk], cap=chunk)
            y = torch.from_numpy(u).to(self.device)
            mel = power_to_db(melspectrogram(y, SR, n_mels=64))[:n]  # [B, 64, T]
            stats = torch.cat([mel.mean(-1), mel.std(-1, unbiased=False)], dim=-1)
            emb = stats.cpu().numpy() @ self._proj
            if self.frame_level:
                outs.extend([np.tile(e[None, :], (4, 1)) for e in emb])
            else:
                outs.extend([e for e in emb])
        return outs
