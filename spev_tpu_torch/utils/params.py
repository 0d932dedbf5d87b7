"""Reference state-dict naming and weight carry-over.

The port's ``nn.Module``s use the reference checkpoints' parameter names
(the naming of ``spev_tpu/utils/torch_loader.py``), plus ``nasal_*`` and
``advanced.*`` for the advanced model's groups.  These helpers turn a
JAX-package parameter tree — nested dicts and lists of arrays — into such a
state dict and back, and read a ``.pt`` or ``.spev`` checkpoint.
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


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32, copy=True)


def fastspeech2_state_dict_from_tree(tree: dict) -> dict:
    """JAX FastSpeech2 parameter tree → the port's state dict.  The
    attention in-projection is stored (3, H, H) / (3, H) there and packed
    (3H, H) / (3H,) here.  The nasal predictor and embedding and the
    ``advanced`` group (VAD projection, speaker table) come along when the
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
    adv = tree.get("advanced", {})
    if "vad_proj" in adv:
        sd["advanced.vad_proj.weight"] = _t(adv["vad_proj"]["weight"])
        sd["advanced.vad_proj.bias"] = _t(adv["vad_proj"]["bias"])
    if "speaker_embedding" in adv:
        sd["advanced.speaker_embedding.weight"] = _t(adv["speaker_embedding"]["weight"])
    return sd


def fastspeech2_tree_from_state_dict(sd: dict) -> dict:
    """The port's FastSpeech2 state dict → the JAX package's parameter tree
    (float32 numpy leaves), the inverse of `fastspeech2_state_dict_from_tree`:
    the attention in-projection goes back to (3, H, H) / (3, H)."""
    sd = {k: _np(v) for k, v in sd.items()}

    def pair(pre):
        return {"weight": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]}

    tree = {"embedding": {"weight": sd["embedding.weight"]}}
    for kind in ("encoder", "decoder"):
        blocks = []
        i = 0
        while f"{kind}_blocks.{i}.norm1.weight" in sd:
            pre = f"{kind}_blocks.{i}"
            w, b = sd[f"{pre}.attention.in_proj_weight"], sd[f"{pre}.attention.in_proj_bias"]
            blk = {"attention": {"in_proj_weight": w.reshape(3, w.shape[0] // 3, w.shape[1]),
                                 "in_proj_bias": b.reshape(3, b.shape[0] // 3),
                                 "out_proj": pair(f"{pre}.attention.out_proj")}}
            for nm in ("norm1", "conv1", "conv2", "norm2"):
                blk[nm] = pair(f"{pre}.{nm}")
            blocks.append(blk)
            i += 1
        tree[f"{kind}_blocks"] = blocks
    for name in _VARIANCES:
        pre = f"{name}_predictor"
        if f"{pre}.proj.weight" not in sd:
            continue
        n_layers = sum(1 for k in sd if k.startswith(f"{pre}.layers.") and k.endswith(".weight")) // 2
        tree[pre] = {
            "convs": [pair(f"{pre}.layers.{4 * i}") for i in range(n_layers)],
            "norms": [pair(f"{pre}.layers.{4 * i + 2}") for i in range(n_layers)],
            "proj": pair(f"{pre}.proj"),
            "output_norm": pair(f"{pre}.output_norm"),
        }
    for name in _EMBEDDED:
        if f"{name}_embedding.weight" in sd:
            tree[f"{name}_embedding"] = pair(f"{name}_embedding")
    tree["mel_linear"] = pair("mel_linear")
    adv = {}
    if "advanced.vad_proj.weight" in sd:
        adv["vad_proj"] = pair("advanced.vad_proj")
    if "advanced.speaker_embedding.weight" in sd:
        adv["speaker_embedding"] = {"weight": sd["advanced.speaker_embedding.weight"]}
    if adv:
        tree["advanced"] = adv
    return tree


def hifigan_state_dict_from_tree(tree: dict, cfg=None) -> dict:
    """JAX HiFi-GAN parameter tree → the upstream generator's (folded)
    state dict (``conv_pre.weight``, ``ups.{i}.weight``,
    ``resblocks.{r}.convs1.{i}.weight`` ...); ``cfg`` is not needed."""
    return state_dict_from_tree(tree)


def state_dict_from_tree(tree) -> dict:
    """A parameter tree of nested dicts and lists → a flat state dict whose
    names join the path with dots (list items by index): the naming the
    port's HiFi-GAN generator and discriminators share with the JAX
    package's trees."""
    sd = {}

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            name = f"{prefix}{k}"
            if isinstance(v, (dict, list, tuple)):
                walk(v, name + ".")
            else:
                sd[name] = v if isinstance(v, torch.Tensor) else _t(v)

    walk(tree, "")
    return sd


def tree_from_state_dict(sd: dict):
    """The inverse of `state_dict_from_tree`: float32 numpy leaves, numeric
    name parts as list indices."""
    root: dict = {}
    for name, v in sd.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _np(v)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


# the JAX package's HiFi-GAN generator and discriminator trees use that naming
# as it is (``mpd.{i}.convs.{j}``, ``msd.{i}.conv_post`` ...)
hifigan_tree_from_state_dict = tree_from_state_dict
discriminators_state_dict_from_tree = state_dict_from_tree
discriminators_tree_from_state_dict = tree_from_state_dict


def policy_state_dict_from_tree(tree: dict) -> dict:
    """JAX acoustic-policy parameter tree (``spev_tpu.models.policy``) →
    `spev_tpu_torch.models.policy.PolicyModel`'s state dict:
    ``lstm/<l>/{fwd,bwd}/<name>`` becomes ``lstm.<name>_l<l>[_reverse]``."""
    sd = {"embedding.weight": _t(tree["embedding"]["weight"])}
    for layer, dirs in enumerate(tree["lstm"]):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"lstm.{name}_l{layer}{suffix}"] = _t(dirs[d][name])
    for head in ("head_breath", "head_rough", "head_bright"):
        sd[f"{head}.weight"] = _t(tree[head]["weight"])
        sd[f"{head}.bias"] = _t(tree[head]["bias"])
    return sd


def read_checkpoint(path: str) -> dict:
    """A checkpoint as the reference ``.pt`` schema's dict (``{'model',
    'optimizer', 'vocab', 'stats', 'step_num', 'epoch'}``, plus
    ``'model_config'`` when the writer stored one).

    A ``.pt`` is read with ``torch.load(weights_only=True)`` onto the CPU.
    A ``.spev`` (the JAX package's format) is decoded once: ``model`` is
    its parameter tree as the port's state dict, ``optimizer`` the stored
    optax tree (or None) and ``model_config`` the stored field dict."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if path.endswith(".spev"):
        from spev_tpu_torch.train.checkpoint import load_spev, relistify

        raw = load_spev(path)
        meta = raw["meta"]
        return {"model": fastspeech2_state_dict_from_tree(relistify(raw["model"])),
                "optimizer": raw.get("optimizer"), "vocab": list(meta["vocab"]),
                "stats": dict(meta["stats"]), "step_num": int(meta["step_num"]),
                "epoch": int(meta["epoch"]), "model_config": meta.get("model_config")}
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
    """A ``.pt`` or ``.spev`` checkpoint → (state dict, vocab list, stats dict)."""
    return unpack_checkpoint(read_checkpoint(path))
