"""HiFi-GAN discriminators, multi-period (MPD) and multi-scale (MSD) —
counterpart of ``spev_tpu.models.hifigan_disc``.

- **MPD**: one sub-discriminator per period p (2, 3, 5, 7, 11 by default).
  The waveform is padded to a multiple of p (reflect when the signal is at
  least as long as the pad, else zeros), folded to (T/p, p) and run through
  2-D convs with (5, 1) kernels and (3, 1) strides over 32 → 128 → 512 →
  1024 channels, then two post convs.
- **MSD**: one sub-discriminator per scale over the raw waveform and its
  2× and 4× average-pooled versions (``AvgPool1d(4, 2, padding=2)``, the
  padding counted), with 1-D conv stacks of kernels 15 and 41, some grouped.

Each sub-discriminator returns its logits, flattened as the JAX package
flattens them, and its feature maps (NCHW / NCL here; the losses only take
means of them).  LeakyReLU slope 0.1 and no weight norm, as in the JAX
package.  Parameter names follow its tree (``mpd.{i}.convs.{j}``,
``mpd.{i}.conv_post1``, ``msd.{i}.conv_post`` ...), so
`utils.params.discriminators_state_dict_from_tree` carries weights across.

``forward(wav, dtype=torch.bfloat16)`` is the trainer's ``--disc_dtype
bf16``: weights and input are cast inside the forward, so the fp32 master
weights get the gradients; logits and feature maps come back in bf16 and
the callers accumulate their losses in fp32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
_MPD_CHANNELS = (32, 128, 512, 1024)
# (in, out, kernel, stride, groups, pad) of the MSD's conv stack
_MSD_SPEC = (
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
)

Output = Tuple[torch.Tensor, List[torch.Tensor]]


def msd_pool(wav: torch.Tensor) -> torch.Tensor:
    """One MSD downscale step, (B, T) → (B, T//2 + 1): ``AvgPool1d(4, 2,
    padding=2)`` with the padding counted, as the JAX package's ``_avg_pool``."""
    return F.avg_pool1d(wav[:, None], 4, 2, padding=2)[:, 0]


def _cast(conv: nn.Module, dtype):
    w, b = conv.weight, conv.bias
    if dtype is None:
        return w, b
    return w.to(dtype), b.to(dtype)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = (1,) + _MPD_CHANNELS
        self.convs = nn.ModuleList(nn.Conv2d(i, o, (5, 1)) for i, o in zip(chans, chans[1:]))
        self.conv_post1 = nn.Conv2d(chans[-1], chans[-1], (5, 1))
        self.conv_post2 = nn.Conv2d(chans[-1], 1, (3, 1))

    def forward(self, wav: torch.Tensor, dtype=None) -> Output:
        """wav (B, T) → (logits (B, n), feature maps (B, C, T/p/3^k, p))."""
        B, T = wav.shape
        p = self.period
        pad = (-T) % p
        if pad:
            wav = F.pad(wav[:, None], (0, pad), mode="reflect" if T >= pad else "constant")[:, 0]
        x = wav.reshape(B, 1, -1, p)
        feats = []
        for c in self.convs:
            x = F.leaky_relu(F.conv2d(x, *_cast(c, dtype), stride=(3, 1), padding=(2, 0)), LRELU)
            feats.append(x)
        x = F.leaky_relu(F.conv2d(x, *_cast(self.conv_post1, dtype), padding=(2, 0)), LRELU)
        feats.append(x)
        x = F.conv2d(x, *_cast(self.conv_post2, dtype), padding=(1, 0))
        feats.append(x)
        return x.reshape(B, -1), feats


class ScaleDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv1d(i, o, k, groups=g)
                                   for i, o, k, _, g, _ in _MSD_SPEC)
        self.conv_post = nn.Conv1d(_MSD_SPEC[-1][1], 1, 3)

    def forward(self, wav: torch.Tensor, dtype=None) -> Output:
        """wav (B, T) → (logits (B, n), feature maps (B, C, n_k))."""
        x = wav[:, None]
        feats = []
        for c, (_, _, _, stride, groups, pad) in zip(self.convs, _MSD_SPEC):
            x = F.leaky_relu(F.conv1d(x, *_cast(c, dtype), stride=stride, padding=pad,
                                      groups=groups), LRELU)
            feats.append(x)
        x = F.conv1d(x, *_cast(self.conv_post, dtype), padding=1)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats


class Discriminators(nn.Module):
    """The MPD sub-discriminators (in ``periods`` order), then the MSD's."""

    def __init__(self, periods: Sequence[int] = MPD_PERIODS, n_scales: int = 3):
        super().__init__()
        self.periods = tuple(int(p) for p in periods)
        self.mpd = nn.ModuleList(PeriodDiscriminator(p) for p in self.periods)
        self.msd = nn.ModuleList(ScaleDiscriminator() for _ in range(n_scales))

    def forward(self, wav: torch.Tensor, dtype: Optional[torch.dtype] = None) -> List[Output]:
        """wav (B, T) → [(logits, feature maps)] over every sub-discriminator."""
        if dtype is not None:
            wav = wav.to(dtype)
        outs = [d(wav, dtype) for d in self.mpd]
        x = wav
        for i, d in enumerate(self.msd):
            if i > 0:
                x = msd_pool(x)
            outs.append(d(x, dtype))
        return outs

    @staticmethod
    def random_init(periods: Sequence[int] = MPD_PERIODS, n_scales: int = 3,
                    seed: int = 0) -> "Discriminators":
        """Torch-style init, as the JAX package draws it: weight and bias
        uniform in ±1/sqrt(fan_in), fan_in = in/groups · kernel area, drawn
        on the CPU from a generator seeded with ``seed``."""
        disc = Discriminators(periods, n_scales)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in disc.modules():
                if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)
        return disc
