"""The embodied agent: the coordinator that blends vocal events and speech
(counterpart of ``spev_tpu.agents.embodied``).

Text with ``[event]`` tags is split on the tags.  An event becomes its
procedural sound (`VocalEventSynth`) followed by 0.1 s of silence; a speech
segment goes through `Synthesizer.synthesize_ids` with breath, roughness
and brightness given per phoneme; the segments are concatenated.  Two
modes share the orchestration:

- **static** (``temporal=False``): constant controls from the emotion's
  knobs (`ProsodyPolicy`), the full event sounds;
- **temporal** (``temporal=True``): per-phoneme curves and the pitch and
  speed scalars from `ProsodyManager`, the simplified events.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from spev_tpu_torch.agents.events import VocalEventSynth
from spev_tpu_torch.agents.prosody import ProsodyManager, ProsodyPolicy
from spev_tpu_torch.infer.synthesis import Synthesizer

_EVENT_RE = re.compile(r"(\[.*?\])")


class EmbodiedAgent:
    def __init__(self, checkpoint, hifigan_dir: Optional[str] = None, temporal: bool = False,
                 synthesizer: Optional[Synthesizer] = None, sr: int = 22050, device="cuda"):
        """checkpoint: what `Synthesizer` takes (unused when ``synthesizer``
        is given).  device: "cuda" (the default) raises when no GPU is
        present; pass "cpu" to run on the CPU.  It places the `Synthesizer`
        built here and the event synth."""
        self.synth = synthesizer or Synthesizer(checkpoint, hifigan_dir=hifigan_dir, device=device)
        self.temporal = temporal
        self.event_synth = VocalEventSynth(sr=sr, device=device)
        self.policy = ProsodyPolicy()
        self.manager = ProsodyManager()
        self.sr = sr

    def _speech_segment(self, text: str, emotion: str) -> np.ndarray:
        phones = self.synth.g2p.phonemes(text)
        n = len(phones)
        ids = self.synth.phonemes_to_ids(phones)
        if self.temporal:
            # curves over the whole segment; synthesize_ids slices them
            # alike when it cuts an over-bucket segment into spans
            curves = self.manager.get_curves(emotion, n)
            breath, rough, bright = (np.asarray(curves[k], np.float32)
                                     for k in ("breath", "rough", "bright"))
            pitch_scale = float(curves["pitch_scale"])
            duration_scale = float(curves["speed_scale"])
        else:
            knobs = self.policy.get_knobs(emotion)
            breath, rough, bright = (np.full((n,), knobs[k], np.float32)
                                     for k in ("breathiness", "roughness", "brightness"))
            pitch_scale = float(knobs["pitch_scale"])
            duration_scale = float(knobs["duration_scale"])
        wav, _ = self.synth.synthesize_ids(ids, breath=breath, rough=rough, bright=bright,
                                           pitch_scale=pitch_scale,
                                           duration_scale=duration_scale)
        return np.asarray(wav, np.float32)

    def synthesize(self, text_input: str, emotion: str = "neutral") -> np.ndarray:
        """Text with ``[event]`` tags → one waveform (float32 numpy)."""
        tokens = [t.strip() for t in _EVENT_RE.split(text_input) if t.strip()]
        segments = []
        for token in tokens:
            if token.startswith("[") and token.endswith("]"):
                name = token[1:-1].lower()
                if self.temporal:
                    segments.append(self.event_synth.generate_simple(name))
                else:
                    segments.append(self.event_synth.get_event(name))
                segments.append(np.zeros(int(self.sr * 0.1), np.float32))
            else:
                segments.append(self._speech_segment(token, emotion))
        if not segments:
            return np.zeros(100, np.float32)
        return np.concatenate(segments).astype(np.float32)
