"""Prosody policies: emotion → acoustic controls (own copy of
``spev_tpu.agents.prosody``, pure numpy).

Two generations, matching the reference exactly:

- `ProsodyPolicy` (static knobs, ``spev_embodied_core.py:118-171``):
  emotion → scalar dict {breathiness, roughness, brightness, pitch_scale,
  duration_scale}; styles neutral/exhausted/excited/secretive/angry.
- `CurveGenerator` + `ProsodyManager` (temporal curves,
  ``spev_temporal_policy.py:47-169``): emotion → per-phoneme trajectories
  (linear/constant/bell/oscillator primitives); styles
  neutral/exhausted/relief/anxious/angry plus scalar pitch/speed.

Also the VAD (valence/arousal/dominance) mapping for the documented
spev_advanced emotion interface (SURVEY.md §2.9): a continuous 3-D emotion
vector is mapped onto the same control knobs so the advanced CLI's
``--valence/--arousal/--dominance`` flags drive the base controls even
without the learned VAD embedding.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ProsodyPolicy:
    """Static emotion → knob mapping (reference rules table)."""

    def __init__(self):
        self.default_style = {
            "breathiness": 0.1,
            "roughness": 0.05,
            "brightness": 0.0,
            "pitch_scale": 1.0,
            "duration_scale": 1.0,
        }
        self.styles = {
            "neutral": self.default_style,
            "exhausted": {
                "breathiness": 0.7,
                "roughness": 0.4,
                "brightness": -1.0,
                "pitch_scale": 0.8,
                "duration_scale": 1.2,
            },
            "excited": {
                "breathiness": 0.0,
                "roughness": 0.0,
                "brightness": 1.5,
                "pitch_scale": 1.3,
                "duration_scale": 0.9,
            },
            "secretive": {
                "breathiness": 0.9,
                "roughness": 0.0,
                "brightness": -0.5,
                "pitch_scale": 1.0,
                "duration_scale": 1.1,
            },
            "angry": {
                "breathiness": 0.0,
                "roughness": 0.6,
                "brightness": 1.0,
                "pitch_scale": 1.1,
                "duration_scale": 0.8,
            },
        }

    def get_knobs(self, emotion: str) -> Dict[str, float]:
        return self.styles.get(emotion, self.default_style)


class CurveGenerator:
    """Temporal trajectory primitives (``spev_temporal_policy.py:47-67``)."""

    @staticmethod
    def linear(start: float, end: float, steps: int) -> np.ndarray:
        return np.linspace(start, end, steps)

    @staticmethod
    def constant(val: float, steps: int) -> np.ndarray:
        return np.full(steps, val, dtype=np.float64)

    @staticmethod
    def bell(peak: float, steps: int) -> np.ndarray:
        t = np.linspace(-1, 1, steps)
        return peak * np.exp(-5 * t**2)

    @staticmethod
    def oscillator(base: float, amp: float, freq: float, steps: int) -> np.ndarray:
        t = np.linspace(0, freq * 2 * np.pi, steps)
        return base + amp * np.sin(t)


class ProsodyManager:
    """Emotion → per-phoneme control curves (temporal edition)."""

    def __init__(self):
        self.styles = {
            "neutral": {
                "breath": ("constant", 0.1),
                "rough": ("constant", 0.05),
                "bright": ("constant", 0.0),
                "pitch": 1.0,
                "speed": 1.0,
            },
            "exhausted": {
                "breath": ("constant", 0.8),
                "rough": ("linear", 0.2, 0.6),
                "bright": ("constant", -1.5),
                "pitch": 0.8,
                "speed": 1.2,
            },
            "relief": {
                "breath": ("linear", 0.9, 0.0),
                "rough": ("constant", 0.0),
                "bright": ("linear", -1.0, 0.5),
                "pitch": 0.9,
                "speed": 1.1,
            },
            "anxious": {
                "breath": ("oscillator", 0.3, 0.2, 3.0),
                "rough": ("constant", 0.4),
                "bright": ("constant", 0.5),
                "pitch": 1.2,
                "speed": 0.9,
            },
            "angry": {
                "breath": ("constant", 0.0),
                "rough": ("bell", 0.8),
                "bright": ("constant", 1.5),
                "pitch": 1.1,
                "speed": 0.85,
            },
        }

    def get_curves(self, emotion: str, steps: int) -> Dict[str, np.ndarray | float]:
        style = self.styles.get(emotion, self.styles["neutral"])

        def generate(name):
            spec = style.get(name, ("constant", 0.0))
            kind, args = spec[0], spec[1:]
            if kind == "constant":
                return CurveGenerator.constant(args[0], steps)
            if kind == "linear":
                return CurveGenerator.linear(args[0], args[1], steps)
            if kind == "bell":
                return CurveGenerator.bell(args[0], steps)
            if kind == "oscillator":
                return CurveGenerator.oscillator(args[0], args[1], args[2], steps)
            return np.zeros(steps)

        return {
            "breath": generate("breath"),
            "rough": generate("rough"),
            "bright": generate("bright"),
            "pitch_scale": style.get("pitch", 1.0),
            "speed_scale": style.get("speed", 1.0),
        }


def vad_to_knobs(valence: float, arousal: float, dominance: float) -> Dict[str, float]:
    """Continuous VAD → control knobs (documented spev_advanced interface,
    ``README.md:178-183``).  A rule mapping consistent with the discrete
    styles: low valence darkens/roughens, arousal raises pitch/speed/
    brightness, low dominance adds breathiness.

    All inputs in [-1, 1] (neutral = 0).
    """
    v, a, d = (float(np.clip(x, -1.0, 1.0)) for x in (valence, arousal, dominance))
    return {
        "breathiness": float(np.clip(0.1 + 0.3 * max(0.0, -d) + 0.2 * max(0.0, -a), 0.0, 0.8)),
        "roughness": float(np.clip(0.05 + 0.4 * max(0.0, -v) * max(0.0, a), 0.0, 1.5)),
        "brightness": float(np.clip(0.8 * a + 0.4 * v, -2.5, 2.5)),
        "pitch_scale": float(np.clip(1.0 + 0.2 * a + 0.05 * v, 0.5, 1.6)),
        "duration_scale": float(np.clip(1.0 - 0.15 * a + 0.1 * max(0.0, -v), 0.6, 1.5)),
        "energy_scale": float(np.clip(1.0 + 0.25 * a + 0.1 * d, 0.5, 1.6)),
    }
