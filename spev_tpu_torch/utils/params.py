"""Reference state-dict naming and weight carry-over.

The port's ``nn.Module``s use the reference checkpoints' parameter names
(the naming of ``spev_tpu/utils/torch_loader.py``).  These helpers turn a
JAX-package parameter tree — nested dicts and lists of arrays — into such a
state dict, and read a reference ``.pt`` checkpoint.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from spev_tpu_torch.errors import UserError

_VARIANCES = ("duration", "pitch", "energy", "breath", "rough", "bright", "nasal")
_EMBEDDED = ("pitch", "energy", "breath", "rough", "bright", "nasal")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def fastspeech2_state_dict_from_tree(tree: dict) -> dict:
    """JAX FastSpeech2 parameter tree → the port's state dict.  The
    attention in-projection is stored (3, H, H) / (3, H) there and packed
    (3H, H) / (3H,) here.  Nasal predictor and embedding come along when the
    tree has them."""
    sd = {"embedding.weight": _t(tree["embedding"]["weight"])}
    for kind in ("encoder", "decoder"):
        for i, blk in enumerate(tree[f"{kind}_blocks"]):
            pre = f"{kind}_blocks.{i}"
            att = blk["attention"]
            w3, b3 = np.asarray(att["in_proj_weight"]), np.asarray(att["in_proj_bias"])
            sd[f"{pre}.attention.in_proj_weight"] = _t(w3.reshape(-1, w3.shape[-1]))
            sd[f"{pre}.attention.in_proj_bias"] = _t(b3.reshape(-1))
            sd[f"{pre}.attention.out_proj.weight"] = _t(att["out_proj"]["weight"])
            sd[f"{pre}.attention.out_proj.bias"] = _t(att["out_proj"]["bias"])
            for nm in ("norm1", "conv1", "conv2", "norm2"):
                sd[f"{pre}.{nm}.weight"] = _t(blk[nm]["weight"])
                sd[f"{pre}.{nm}.bias"] = _t(blk[nm]["bias"])
    for name in _VARIANCES:
        vp = tree.get(f"{name}_predictor")
        if vp is None:
            continue
        pre = f"{name}_predictor"
        for i, (c, n) in enumerate(zip(vp["convs"], vp["norms"])):
            sd[f"{pre}.layers.{4 * i}.weight"] = _t(c["weight"])
            sd[f"{pre}.layers.{4 * i}.bias"] = _t(c["bias"])
            sd[f"{pre}.layers.{4 * i + 2}.weight"] = _t(n["weight"])
            sd[f"{pre}.layers.{4 * i + 2}.bias"] = _t(n["bias"])
        for part in ("proj", "output_norm"):
            sd[f"{pre}.{part}.weight"] = _t(vp[part]["weight"])
            sd[f"{pre}.{part}.bias"] = _t(vp[part]["bias"])
    for name in _EMBEDDED:
        if f"{name}_embedding" in tree:
            sd[f"{name}_embedding.weight"] = _t(tree[f"{name}_embedding"]["weight"])
            sd[f"{name}_embedding.bias"] = _t(tree[f"{name}_embedding"]["bias"])
    sd["mel_linear.weight"] = _t(tree["mel_linear"]["weight"])
    sd["mel_linear.bias"] = _t(tree["mel_linear"]["bias"])
    return sd


def hifigan_state_dict_from_tree(tree: dict, cfg) -> dict:
    """JAX HiFi-GAN parameter tree → the upstream generator's (folded)
    state dict."""
    sd = {}
    for name in ("conv_pre", "conv_post"):
        sd[f"{name}.weight"] = _t(tree[name]["weight"])
        sd[f"{name}.bias"] = _t(tree[name]["bias"])
    for i in range(len(cfg.upsample_rates)):
        sd[f"ups.{i}.weight"] = _t(tree["ups"][i]["weight"])
        sd[f"ups.{i}.bias"] = _t(tree["ups"][i]["bias"])
    for r, rb in enumerate(tree["resblocks"]):
        for group, convs in rb.items():  # convs1/convs2 (type 1) or convs (type 2)
            for i, c in enumerate(convs):
                sd[f"resblocks.{r}.{group}.{i}.weight"] = _t(c["weight"])
                sd[f"resblocks.{r}.{group}.{i}.bias"] = _t(c["bias"])
    return sd


def read_checkpoint(path: str) -> dict:
    """A reference-schema ``.pt`` checkpoint (``{'model', 'optimizer',
    'vocab', 'stats', 'step_num', 'epoch'}``, plus ``'model_config'`` when
    the port's trainer wrote it) as the dict ``torch.save`` stored, read with
    ``torch.load(weights_only=True)`` onto the CPU."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if path.endswith(".spev"):
        raise UserError(
            f"{path}: .spev checkpoints are not readable by the PyTorch port yet; "
            "export a reference .pt (spev_tpu.train.checkpoint.export_reference_checkpoint)"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise UserError(f"{path}: not a reference checkpoint (no 'model' state dict)")
    return ckpt


def unpack_checkpoint(ckpt: dict) -> Tuple[dict, list, dict]:
    """(float32 state dict, vocab list, stats dict) of a `read_checkpoint` dict."""
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in ckpt["model"].items()}
    vocab = [str(v) for v in ckpt.get("vocab", [])]
    stats = {k: float(v) for k, v in ckpt.get("stats", {}).items()}
    return sd, vocab, stats


def load_reference_checkpoint(path: str) -> Tuple[dict, list, dict]:
    """A reference ``.pt`` checkpoint → (state dict, vocab list, stats dict)."""
    return unpack_checkpoint(read_checkpoint(path))
