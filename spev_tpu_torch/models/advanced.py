"""Advanced acoustic model: VAD emotion and speaker conditioning, word
emphasis, and the age and lung-capacity rules.  Counterpart of
``spev_tpu.models.advanced``.

- `AdvancedExtras` holds the learned parts, a 3-D valence/arousal/dominance
  projection into hidden space and (with more than one speaker) a speaker
  table.  `FastSpeech2` carries it as ``self.advanced`` when its config asks
  for VAD or speakers, so their state-dict names are ``advanced.*``.  Their
  sum is added after the encoder through the model's ``encoder_bias``.
- The age and lung-capacity rules and word emphasis are control-plane
  transforms: `apply_advanced` folds emphasis into the duration, pitch and
  energy controls before the base forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class AdvancedExtras(nn.Module):
    """``vad_proj`` (3 → H) and, when ``n_speakers > 1``, a
    ``speaker_embedding`` (n_speakers, H) without a padding row."""

    def __init__(self, hidden_dim: int, n_speakers: int = 1):
        super().__init__()
        self.vad_proj = nn.Linear(3, hidden_dim)
        self.speaker_embedding = nn.Embedding(n_speakers, hidden_dim) if n_speakers > 1 else None

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        """The JAX package's initialisation: a zero VAD projection (an
        untrained head is exactly a no-op) and a N(0, 0.01²) speaker table,
        drawn from ``g`` on the CPU."""
        self.vad_proj.weight.zero_()
        self.vad_proj.bias.zero_()
        if self.speaker_embedding is not None:
            w = self.speaker_embedding.weight
            w.copy_(torch.empty(w.shape).normal_(0.0, 1.0, generator=g) * 0.01)

    def forward(self, vad: Optional[torch.Tensor] = None,
                speaker_ids: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """vad (B, 3), speaker_ids (B,) → the encoder bias (B, 1, H), or None
        when neither is given (or the model has no speaker table)."""
        bias = None
        if vad is not None:
            # at `modules.get_matmul_precision()` both ways, as the JAX
            # package runs it: the TF32 flags `modules.matmul_precision` sets
            bias = F.linear(vad, self.vad_proj.weight, self.vad_proj.bias)[:, None, :]
        if speaker_ids is not None and self.speaker_embedding is not None:
            spk = F.embedding(speaker_ids, self.speaker_embedding.weight)[:, None, :]
            bias = spk if bias is None else bias + spk
        return bias


# ---------------------------------------------------------------------------
# physiological / expressive control rules (host side, pure)
# ---------------------------------------------------------------------------


def age_pitch_scale(age: float, base_scale: float = 1.0) -> float:
    """Age → pitch rule: ``pitch *= 1.0 + (25 − age)·0.008``."""
    return float(base_scale * (1.0 + (25.0 - float(age)) * 0.008))


@dataclass(frozen=True)
class LungEffect:
    breath_boost: float
    duration_scale: float


def lung_capacity_effect(lung_capacity: float) -> LungEffect:
    """Breath-need rule: low lung capacity → more audible breath and
    stretched phrasing.  lung_capacity in (0, 1], 1.0 = no effect."""
    lc = float(np.clip(lung_capacity, 0.05, 1.0))
    need = 1.0 - lc
    return LungEffect(breath_boost=0.4 * need, duration_scale=1.0 + 0.2 * need)


def apply_advanced(model, phoneme_ids: torch.Tensor, lengths: torch.Tensor,
                   max_frames: Optional[int] = None, *,
                   vad: Optional[torch.Tensor] = None,
                   speaker_ids: Optional[torch.Tensor] = None,
                   emphasis: Optional[torch.Tensor] = None,
                   d_control=1.0, p_control=1.0, e_control=1.0, **kw) -> dict:
    """Advanced forward of a `FastSpeech2`: the VAD/speaker encoder bias
    (when the model has ``advanced``), and per-phoneme ``emphasis`` (B, P)
    multiplied into the d/p/e controls; the other keywords go to the base
    forward."""
    bias = model.advanced(vad, speaker_ids) if model.advanced is not None else None
    if emphasis is not None:
        d_control = d_control * emphasis
        p_control = p_control * emphasis
        e_control = e_control * emphasis
    return model(phoneme_ids, lengths, max_frames, d_control=d_control, p_control=p_control,
                 e_control=e_control, encoder_bias=bias, **kw)
