"""HiFi-GAN generator (inference) — counterpart of ``spev_tpu.models.hifigan``.

mel (B, T, num_mels) → conv pre-net → N transposed-conv upsample stages, each
followed by a multi-receptive-field fusion (ResBlocks averaged over kernel
sizes) → leaky-ReLU (slope 0.01) → conv post-net → tanh waveform
(B, T·prod(upsample_rates)).

Parameter names are the upstream generator's (``conv_pre``, ``ups.{i}``,
``resblocks.{r}.convs1.{i}`` ...), with weight norm folded at load time
(``w = g·v/‖v‖``, the norm over all axes but dim 0).  With ``mel_len`` given,
every stage zeroes the positions past the valid length, so a bucket-padded
input gives the exact-length waveform on its valid prefix.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    """The upstream config.json fields the generator needs (V1 default)."""

    resblock: str = "1"
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80

    @staticmethod
    def from_json(path: str) -> "HiFiGANConfig":
        with open(path) as f:
            h = json.load(f)
        return HiFiGANConfig(
            resblock=str(h["resblock"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=int(h["upsample_initial_channel"]),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
            num_mels=int(h.get("num_mels", 80)),
        )

    @staticmethod
    def v3() -> "HiFiGANConfig":
        return HiFiGANConfig(
            resblock="2",
            upsample_rates=(8, 8, 4),
            upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=256,
            resblock_kernel_sizes=(3, 5, 7),
            resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
        )

    @property
    def hop_recovery(self) -> int:
        return int(np.prod(self.upsample_rates))


def _conv(in_ch: int, out_ch: int, k: int, d: int = 1) -> nn.Conv1d:
    """'Same'-padded dilated conv: padding (k-1)·d//2."""
    return nn.Conv1d(in_ch, out_ch, k, dilation=d, padding=(k - 1) * d // 2)


def _mask_valid(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero positions ≥ valid along the time axis of (B, C, T)."""
    if valid is None:
        return x
    t = torch.arange(x.shape[-1], device=x.device)
    return x.masked_fill(t[None, None, :] >= valid[:, None, None], 0.0)


class ResBlock(nn.Module):
    """Type '1' (dilated conv then unit conv, per dilation) or '2' (one
    dilated conv per dilation); residual, masked after every step."""

    def __init__(self, kind: str, ch: int, k: int, dilations: Sequence[int]):
        super().__init__()
        self.kind = kind
        if kind == "1":
            self.convs1 = nn.ModuleList(_conv(ch, ch, k, d) for d in dilations)
            self.convs2 = nn.ModuleList(_conv(ch, ch, k) for _ in dilations)
        else:
            self.convs = nn.ModuleList(_conv(ch, ch, k, d) for d in dilations)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        convs = self.convs1 if self.kind == "1" else self.convs
        for i, c in enumerate(convs):
            h = c(_mask_valid(F.leaky_relu(x, LRELU_SLOPE), valid))
            if self.kind == "1":
                h = self.convs2[i](_mask_valid(F.leaky_relu(h, LRELU_SLOPE), valid))
            x = _mask_valid(x + h, valid)
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = _conv(cfg.num_mels, ch, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, stride=u, padding=(k - u) // 2))
            ch //= 2
            for kr, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(cfg.resblock, ch, kr, dil))
        self.conv_post = _conv(ch, 1, 7)

    def forward(self, mel: torch.Tensor, mel_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T, num_mels) → waveform (B, T·hop_recovery).  mel_len
        (B,) masks every stage so bucket padding is invisible; None skips
        masking (fully valid input)."""
        valid = None if mel_len is None else mel_len.to(mel.device)
        x = _mask_valid(mel.to(self.conv_pre.weight.dtype).transpose(1, 2), valid)
        x = self.conv_pre(x)
        n_kernels = len(self.cfg.resblock_kernel_sizes)
        for i, (u, up) in enumerate(zip(self.cfg.upsample_rates, self.ups)):
            x = up(_mask_valid(F.leaky_relu(x, LRELU_SLOPE), valid))
            valid = None if valid is None else valid * u
            x = _mask_valid(x, valid)
            acc = None
            for j in range(n_kernels):
                out = self.resblocks[i * n_kernels + j](x, valid)
                acc = out if acc is None else acc + out
            x = acc / n_kernels
        # upstream uses leaky_relu's default slope (0.01) before conv_post
        x = _mask_valid(F.leaky_relu(x, 0.01), valid)
        return torch.tanh(self.conv_post(x))[:, 0]

    @staticmethod
    def random_init(cfg: Optional[HiFiGANConfig] = None, seed: int = 0) -> "HiFiGANGenerator":
        """Upstream init, N(0, 0.01²) weights and zero biases, drawn on the
        CPU from a generator seeded with ``seed``."""
        gen = HiFiGANGenerator(cfg or HiFiGANConfig())
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in gen.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                else:
                    p.copy_(torch.empty(p.shape).normal_(0.0, 0.01, generator=g))
        return gen.eval()

    @staticmethod
    def from_pretrained(directory: str) -> "HiFiGANGenerator":
        """``config.json`` plus the newest ``g_*`` checkpoint in a directory
        (weight-normed or folded upstream state dict)."""
        cfg = HiFiGANConfig.from_json(os.path.join(directory, "config.json"))
        ckpts = sorted(glob.glob(os.path.join(directory, "g_*")))
        if not ckpts:
            raise FileNotFoundError(f"no g_* checkpoint in {directory}")
        raw = torch.load(ckpts[-1], map_location="cpu", weights_only=True)
        sd = raw["generator"] if "generator" in raw else raw
        gen = HiFiGANGenerator(cfg)
        gen.load_state_dict(fold_weight_norm(sd))
        return gen.eval()


def fold_weight_norm(sd: dict) -> dict:
    """Fold ``weight_g``/``weight_v`` pairs into plain weights (torch
    ``remove_weight_norm``; the norm over all axes but dim 0)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_v"):
            base = k[: -len("_v")]
            v = torch.as_tensor(v, dtype=torch.float32)
            g = torch.as_tensor(sd[base + "_g"], dtype=torch.float32)
            norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[base] = g * v / norm.clamp_min(1e-12)
        elif not k.endswith("weight_g"):
            out[k] = torch.as_tensor(v)
    return out
