"""Checkpoints in the JAX package's pickle format, and the reference's
checkpoint file-name grammar (counterpart of train/checkpoints.py there).

Payload: {"params": numpy pytree, "cfg": config dict, "architecture": name,
"extra": dict}. A checkpoint the JAX package wrote pickles the config's
`dtype` as the global `jax.numpy.float32`, so a plain `pickle.load` would
import JAX; `load` maps every `jax.*` global to a stand-in (the field is
dropped anyway). `save` writes the dtype as its name, so either package
reads the file without the other's framework.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Tuple

from ..models.base import TaggerConfig


def checkpoint_name(epoch: int, monitored: float, threshold: float = 0.5) -> str:
    return f"checkpoint-epoch={epoch:02d}-val_loss={monitored:.4f}-threshold={threshold:.2f}.ckpt"


def parse_checkpoint_name(path: str) -> Tuple[float, float]:
    """-> (threshold, val_loss), the reference parse (train_fit.py:337-338).
    `final=0.500.ckpt` has no loss field: it gives 0.5 and a NaN sentinel."""
    if os.path.basename(path).startswith("final="):
        return 0.5, float("nan")
    threshold = float(path.split("=")[-1][:4])
    val_loss = float(path.split("=")[-2][:6])
    return threshold, val_loss


class _JaxGlobal:
    """Stand-in for a `jax.*` global found in a checkpoint pickle."""

    def __init__(self, module: str, name: str):
        self.qualname = f"{module}.{name}"

    def __repr__(self):
        return f"<jax global {self.qualname}>"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "jax" or module.startswith(("jax.", "jaxlib")):
            return _JaxGlobal(module, name)
        return super().find_class(module, name)


def save(path: str, params, cfg: TaggerConfig, architecture: str, extra: dict = None):
    """`params` is the JAX-layout pytree with numpy leaves (a tagger's
    `to_jax_params()`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["dtype"] = str(cfg.dtype).replace("torch.", "")
    payload = {"params": params, "cfg": cfg_dict, "architecture": architecture,
               "extra": extra or {}}
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load(path: str):
    """-> (params pytree, TaggerConfig, architecture, extra). Unpickles, so
    only load checkpoints this program or the JAX package wrote."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    cfg = TaggerConfig.from_dict(payload["cfg"])
    return payload["params"], cfg, payload["architecture"], payload.get("extra", {})
