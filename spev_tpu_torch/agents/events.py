"""Procedural non-verbal vocal events (no model, pure DSP).  Counterpart of
``spev_tpu.agents.events``.

- **sigh** (1.2 s): lowpassed noise source, attack→sustain→slow-decay
  envelope, 800-4000 Hz bandpass, ×intensity×0.15;
- **breath-in** (0.4 s): white noise, quadratic-rise envelope,
  1500-6000 Hz bandpass, ×intensity×0.1;
- **grunt** (0.2 s): 60 Hz impulse train (sin > 0.95 gate) + jitter,
  Gaussian bell envelope, ×intensity×0.2;
- dispatch by substring of the event name; unknown events → 100 zeros.

Filters are designed on the host (scipy) and applied on the device by
`spev_tpu_torch.ops.filters`; the outputs are numpy.  The noise comes from
`VocalEventSynth._noise`, a CPU ``torch.Generator`` seeded once, moved to the
device: like the JAX package's counter-based draw, it does not depend on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

from spev_tpu_torch.ops.filters import butter_ba, butter_sos, lfilter, sosfilt
from spev_tpu_torch.utils.platform import resolve_device


class VocalEventSynth:
    def __init__(self, sr: int = 22050, seed: int = 0, device="cuda"):
        """device: "cuda" (the default) raises when no GPU is present; pass
        "cpu" to run on the CPU."""
        self.sr = sr
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(int(seed))
        # host-side constant filter designs (reference coefficients)
        self._lp_b, self._lp_a = butter_ba(1, 0.2)
        self._sigh_sos = butter_sos(2, [800, 4000], btype="bandpass", fs=sr)
        self._breath_sos = butter_sos(2, [1500, 6000], btype="bandpass", fs=sr)

    def _noise(self, n: int) -> torch.Tensor:
        """n standard-normal float32 samples on the device; each call draws
        the next ones from the synth's generator."""
        return torch.randn(n, generator=self._gen).to(self.device)

    def _env(self, env: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(env.astype(np.float32), device=self.device)

    def generate_sigh(self, duration: float = 1.2, intensity: float = 0.8) -> np.ndarray:
        n = int(self.sr * duration)
        noise = lfilter(self._lp_b, self._lp_a, self._noise(n))
        env = np.concatenate(
            [
                np.linspace(0, 1, int(0.2 * self.sr)),
                np.linspace(1, 0.6, int(0.3 * self.sr)),
                np.linspace(0.6, 0, int((duration - 0.5) * self.sr)),
            ]
        )
        env = np.pad(env, (0, max(0, n - len(env))))[:n]
        filtered = sosfilt(self._sigh_sos, noise)
        return (filtered * self._env(env) * intensity * 0.15).cpu().numpy()

    def generate_breath_in(self, duration: float = 0.4, intensity: float = 0.6) -> np.ndarray:
        n = int(self.sr * duration)
        noise = self._noise(n)
        env = np.linspace(0, 1, n) ** 2
        filtered = sosfilt(self._breath_sos, noise)
        return (filtered * self._env(env) * intensity * 0.1).cpu().numpy()

    def generate_grunt(self, duration: float = 0.2, intensity: float = 0.5) -> np.ndarray:
        n = int(self.sr * duration)
        t = np.linspace(0, duration, n).astype(np.float32)
        pulses = (np.sin(2 * np.pi * 60.0 * t) > 0.95).astype(np.float32)
        jitter = self._noise(n).cpu().numpy() * 0.1
        env = np.exp(-((t - duration / 2) ** 2) / 0.005).astype(np.float32)
        return (pulses + jitter) * env * intensity * 0.2

    def generate_simple(self, event_name: str) -> np.ndarray:
        """The temporal agent's simplified event: decaying noise."""
        duration = 1.0 if "sigh" in event_name else 0.5
        n = int(self.sr * duration)
        t = np.linspace(0, duration, n).astype(np.float32)
        return self._noise(n).cpu().numpy() * np.exp(-3 * t) * 0.1

    def get_event(self, event_name: str) -> np.ndarray:
        name = event_name.lower()
        if "sigh" in name:
            return self.generate_sigh()
        if "breath" in name:
            return self.generate_breath_in()
        if "grunt" in name:
            return self.generate_grunt()
        return np.zeros(100, np.float32)
