"""CREPE pitch-embedding encoder (counterpart of the JAX package's
encoders/crepe.py; the reference's `TorchCrepeModel` is absent from its own
repo, and its tables expect a 256-d embedding per frame).

  1024-sample frames at 16 kHz every 10 ms, each standardised
  -> 5 x (conv1d 'same' -> ReLU -> BatchNorm (eps 1e-3) -> max-pool 2)
  -> max over time -> linear projection to 256.

'same' follows XLA: total padding max((ceil(N/s) - 1) s + k - N, 0), the
smaller half first; `nn.Conv1d(padding="same")` refuses stride 4.
`load_weights` reads the converted npz (conv{i}_{w,b} [k, cin, cout],
bn{i}_*, optional proj_w/proj_b) into the JAX pytree layout;
`from_jax_params` maps that onto the module's state_dict. Frames go to the
card in chunks of 512 without row padding (the JAX package pads chunks to
32-row multiples only to bound its compiled shapes; frames are independent).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.torch_setup import resolve_device
from .engine_util import traced_encode

FRAME = 1024
HOP = 160  # 10 ms at 16 kHz
# (out_channels, kernel, stride) per layer
LAYERS = ((1024, 512, 4), (128, 64, 1), (128, 64, 1), (128, 64, 1), (256, 64, 1))


def same_padding(n: int, k: int, s: int):
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Crepe(nn.Module):
    def __init__(self, emb_dim: int = 256):
        super().__init__()
        convs, bns, cin = [], [], 1
        for cout, k, s in LAYERS:
            convs.append(nn.Conv1d(cin, cout, k, stride=s))
            bns.append(nn.BatchNorm1d(cout, eps=1e-3))
            cin = cout
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.proj = nn.Linear(cin, emb_dim)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, 1024] frames -> [N, 256]."""
        mu = frames.mean(dim=-1, keepdim=True)
        sd = frames.std(dim=-1, unbiased=False, keepdim=True) + 1e-8
        x = ((frames - mu) / sd)[:, None]  # [N, 1, 1024]
        for conv, bn, (_cout, k, s) in zip(self.convs, self.bns, LAYERS):
            x = conv(F.pad(x, same_padding(x.shape[-1], k, s)))
            x = F.max_pool1d(bn(F.relu(x)), 2)
        return self.proj(x.amax(dim=-1))


def from_jax_params(params: dict) -> dict:
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {}
    for i, lp in enumerate(params["layers"]):
        sd[f"convs.{i}.weight"] = t(np.transpose(np.asarray(lp["w"]), (2, 1, 0)))
        sd[f"convs.{i}.bias"] = t(lp["b"])
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            sd[f"bns.{i}.{ours}"] = t(lp["bn"][theirs])
        sd[f"bns.{i}.num_batches_tracked"] = torch.tensor(0)
    sd["proj.weight"] = t(np.transpose(np.asarray(params["proj_w"])))
    sd["proj.bias"] = t(params["proj_b"])
    return sd


def random_state_dict(generator: torch.Generator) -> dict:
    """He-normal convs (sqrt(2 / (k cin))), projection 0.02, zero biases,
    unit BatchNorm."""
    model = Crepe()
    with torch.no_grad():
        for conv in model.convs:
            cout, cin, k = conv.weight.shape
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                              * np.sqrt(2.0 / (k * cin)))
            conv.bias.zero_()
        model.proj.weight.copy_(torch.randn(model.proj.weight.shape, generator=generator) * 0.02)
        model.proj.bias.zero_()
    return model.state_dict()


def load_weights(npz_path: str) -> dict:
    """Converted npz -> JAX pytree layout (numpy leaves). torchcrepe's head
    is a 360-way classifier, so the 256-d projection may be missing: it is
    then drawn as `random_state_dict` draws it."""
    with np.load(npz_path) as data:
        params = {"layers": [
            {"w": data[f"conv{i}_w"], "b": data[f"conv{i}_b"],
             "bn": {k: data[f"bn{i}_{k}"] for k in ("scale", "bias", "mean", "var")}}
            for i in range(len(LAYERS))]}
        if "proj_w" in data:
            params["proj_w"], params["proj_b"] = data["proj_w"], data["proj_b"]
            return params
    sd = random_state_dict(torch.Generator().manual_seed(0))
    params["proj_w"] = sd["proj.weight"].numpy().T
    params["proj_b"] = sd["proj.bias"].numpy()
    return params


class CrepeEncoder:
    name = "crepe"
    dim = 256
    frame_level = True

    def __init__(self, weights: str = None, device="cuda"):
        weights = weights or os.environ.get("MTS_CREPE_WEIGHTS")
        self.model = Crepe()
        if weights:
            self.model.load_state_dict(from_jax_params(load_weights(weights)))
        elif os.environ.get("MTS_RANDOM_ENCODER_WEIGHTS") == "1":
            print("WARNING: crepe running with RANDOM weights (smoke mode)")
            self.model.load_state_dict(random_state_dict(torch.Generator().manual_seed(0)))
        else:
            raise RuntimeError(
                "CREPE weights unavailable (the reference's TorchCrepeModel "
                "module is absent from its own repo); pass weights= / "
                "MTS_CREPE_WEIGHTS or set MTS_RANDOM_ENCODER_WEIGHTS=1"
            )
        self.device = resolve_device(device)
        self.model.to(self.device).eval()

    @traced_encode
    @torch.inference_mode()
    def encode_document(self, audio, bounds, chunk=512):
        outs = []
        for s, e in bounds:
            seg = audio[s:e]
            if len(seg) < FRAME:
                seg = np.pad(seg, (0, FRAME - len(seg)))
            starts = np.arange(0, len(seg) - FRAME + 1, HOP)
            frames = np.stack([seg[st : st + FRAME] for st in starts])
            embs = []
            for i in range(0, len(frames), chunk):
                x = torch.from_numpy(np.ascontiguousarray(frames[i : i + chunk], np.float32))
                embs.append(self.model(x.to(self.device)).cpu().numpy())
            outs.append(np.concatenate(embs, axis=0))
        return outs
