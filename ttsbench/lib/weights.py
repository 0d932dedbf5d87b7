"""Seeded weights, made on the device from ``--seed`` in one draw per model.

Every random parameter takes a slice of one ``torch.rand`` call on the run's
device (a ``torch.Generator`` there), mapped to a uniform distribution of the
standard deviation that PyTorch's default initialisation, or the generator
recipe, gives it.  The same dict of tensors goes to the program and to the
reference.  What each configuration assumes is written under its ``assumed``
key.
"""

from __future__ import annotations

import math

import torch

from ttsbench.reference.models import fs2_shapes, generator_shapes

_STREAMS = {"acoustic": 0x5EED_0001, "vocoder": 0x5EED_0002}


def generator_for(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + _STREAMS[stream]) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _fs2_rule(name: str, shape: tuple, weights: dict):
    """(kind, value): 'uniform' with its bound, or 'const' with its value."""
    if name == "duration_predictor.output_norm.bias":
        return "const", weights["duration_bias"]
    layer_norm = (".norm1." in name or ".norm2." in name or "output_norm" in name
                  or (".layers." in name and int(name.split(".")[2]) % 4 == 2))
    if layer_norm:
        return "const", 1.0 if name.endswith("weight") else 0.0
    if name == "embedding.weight":
        return "uniform", math.sqrt(3.0) * weights["embedding_std"]
    if name.endswith("in_proj_weight"):
        return "uniform", math.sqrt(6.0 / (2 * shape[1]))
    if name.endswith("in_proj_bias"):
        return "const", 0.0
    if name.startswith(("pitch_embedding", "energy_embedding", "breath_embedding",
                        "rough_embedding", "bright_embedding", "mel_linear")):
        if name.endswith("bias"):
            return "const", 0.0
        return "uniform", math.sqrt(3.0) * weights["head_std"]
    return "fan_in", None


def _draw(shapes: dict, rules: dict, seed: int, stream: str, device) -> dict:
    fan_in = {n[: -len(".weight")]: math.prod(s[1:]) for n, s in shapes.items()
              if n.endswith(".weight") and len(s) >= 2}
    random = [n for n in shapes if rules[n][0] != "const"]
    total = sum(math.prod(shapes[n]) for n in random)
    u = torch.rand(total, generator=generator_for(seed, stream, device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind, value = rules[name]
        if kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
            continue
        n = math.prod(shape)
        if kind == "fan_in":
            value = 1.0 / math.sqrt(fan_in[name.rsplit(".", 1)[0]])
        out[name] = (u[at: at + n].reshape(shape) * 2.0 - 1.0) * value
        at += n
    return out


def fs2_weights(cfg: dict, vocab_size: int, weights: dict, seed: int, device) -> dict:
    """The acoustic model's state dict: PyTorch's default distributions
    (linear and conv U(+-1/sqrt(fan_in)), attention in-projection
    xavier-uniform with a zero bias, LayerNorm ones and zeros), a unit-std
    embedding with row 0 zero, std ``head_std`` variance embeddings and mel
    head with zero biases, and the duration predictor's output bias
    ``duration_bias``."""
    shapes = fs2_shapes(cfg, vocab_size)
    rules = {n: _fs2_rule(n, s, weights) for n, s in shapes.items()}
    out = _draw(shapes, rules, seed, "acoustic", device)
    out["embedding.weight"][0].zero_()
    return out


def generator_weights(hcfg: dict, seed: int, device) -> dict:
    """The vocoder's (folded) state dict: every weight of std
    1/sqrt(fan_in), every bias zero."""
    shapes = generator_shapes(hcfg)
    rules = {n: ("const", 0.0) if n.endswith("bias")
             else ("uniform", math.sqrt(3.0 / math.prod(s[1:]))) for n, s in shapes.items()}
    return _draw(shapes, rules, seed, "vocoder", device)
