"""Emotion labels → VAD (valence/arousal/dominance) training targets.  Own
copy of ``spev_tpu.data.emotion`` (numpy only).

A fixed emotion → (V, A, D) table turns the emotion label that the ESD
prepper keeps in a pair's file name (``{utt_id}_{emotion}``) into a
per-utterance 3-D target.  The dataset build writes it into each npz as
``vad``, the batch carries it, and the advanced model's ``vad_proj`` trains
on it.  The coordinates follow the circumplex placements (Russell 1980;
Mehrabian PAD) and agree in direction with the inference-side rule map
`spev_tpu_torch.agents.prosody.vad_to_knobs`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# (valence, arousal, dominance) in [-1, 1]^3: the ESD five
# (neutral/angry/happy/sad/surprise) plus the common extended set
EMOTION_VAD: Dict[str, Tuple[float, float, float]] = {
    "neutral": (0.0, 0.0, 0.0),
    "angry": (-0.6, 0.8, 0.6),
    "happy": (0.8, 0.6, 0.3),
    "sad": (-0.7, -0.5, -0.4),
    "surprise": (0.4, 0.8, 0.0),
    # extended set (IEMOCAP/CREMA-D style labels)
    "fear": (-0.7, 0.7, -0.6),
    "disgust": (-0.6, 0.3, 0.2),
    "calm": (0.4, -0.6, 0.2),
    "excited": (0.7, 0.9, 0.4),
    "bored": (-0.3, -0.7, -0.2),
}

# common spelling variants normalize onto the canonical rows
_ALIASES = {
    "anger": "angry",
    "happiness": "happy",
    "joy": "happy",
    "sadness": "sad",
    "surprised": "surprise",
    "fearful": "fear",
    "afraid": "fear",
    "disgusted": "disgust",
}


def canonical_emotion(name: str) -> Optional[str]:
    """Normalize an emotion label to a table row, or None if unknown."""
    n = name.strip().lower()
    n = _ALIASES.get(n, n)
    return n if n in EMOTION_VAD else None


def vad_for_emotion(name: str) -> np.ndarray:
    """(3,) float32 VAD vector for a (canonical or alias) emotion name."""
    c = canonical_emotion(name)
    if c is None:
        raise KeyError(f"unknown emotion label {name!r}; known: {sorted(EMOTION_VAD)}")
    return np.asarray(EMOTION_VAD[c], np.float32)


def emotion_from_basename(basename: str) -> Optional[str]:
    """Emotion label from a ``{utt_id}_{emotion}`` pair filename: the last
    underscore-separated token, if it is a known emotion.  Returns the
    canonical name or None."""
    stem = basename.rsplit(".", 1)[0]
    if "_" not in stem:
        return None
    return canonical_emotion(stem.rsplit("_", 1)[1])
