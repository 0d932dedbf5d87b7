"""Word-level emphasis → phoneme-level control scaling (own copy of
``spev_tpu.text.emphasis``).

``--word_emphasis "1.0,1.5,1.0"`` assigns one scalar per word; emphasized
words get proportionally scaled duration, pitch and energy.  This maps the
per-word scalars onto the phoneme axis using the frontend's per-word
phoneme counts, including the surrounding ``<SIL>`` markers (scale 1.0).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from spev_tpu_torch.errors import UserError


def parse_emphasis(spec: str) -> List[float]:
    """Parse the CLI string '1.0,1.5,...' into floats."""
    out = []
    for x in spec.split(","):
        x = x.strip()
        if not x:
            continue
        try:
            out.append(float(x))
        except ValueError:
            raise UserError(
                f"--word_emphasis expects comma-separated numbers like '1.0,1.5,1.0'; got {x!r}"
            ) from None
    return out


def word_emphasis_to_phonemes(
    word_scales: Sequence[float],
    phonemes_per_word: Sequence[Sequence[str]],
    leading_sil: int = 1,
    trailing_sil: int = 1,
) -> np.ndarray:
    """Expand word scalars to a per-phoneme scale vector.

    If fewer scales than words are given, the tail defaults to 1.0 (extra
    scales are ignored)."""
    scales: List[float] = [1.0] * leading_sil
    for i, phs in enumerate(phonemes_per_word):
        s = float(word_scales[i]) if i < len(word_scales) else 1.0
        scales.extend([s] * len(phs))
    scales.extend([1.0] * trailing_sil)
    return np.asarray(scales, dtype=np.float32)
