"""Breath-need planning: accumulated air use → mid-utterance breath events
(own copy of ``spev_tpu.agents.breath``).

The reference documents a "breath-need predictor → duration extension
driven by lung_capacity" (``PRODUCTION_SYSTEM_SUMMARY.md:91-94``) but ships
no mechanism that ever inserts a breath.  This module implements the
physical model behind that description: speech spends air in proportion to
how much is said and how fast; a speaker with reduced lung capacity runs
out sooner and must inhale at a phrase boundary before continuing.

The planner is rule-parameterized (an explicit air-budget model, not a
learned net — see docs/COVERAGE.md for the scope note) but it *acts*: it
decides, per phrase boundary, whether the speaker breathes, and with what
urgency — low capacity or long phrases produce more, louder, longer
inhales (the C10 `VocalEventSynth.generate_breath_in` DSP event), exactly
the audible behavior the docs describe.

Model
-----
Air is a reservoir in [0, 1], full at utterance start.  Speaking phrase
``i`` costs ``phonemes_i · duration_scale / (CAPACITY_PHONEMES · lc)``
where ``lc`` is lung capacity in (0, 1]: a full-capacity speaker can
comfortably phrase ~CAPACITY_PHONEMES phonemes on one breath, and slower
speech (duration_scale > 1) spends proportionally more air per phoneme.
At each phrase boundary the speaker inhales iff finishing the NEXT phrase
would drop the reservoir below a safety reserve — i.e. the breath is taken
*in anticipation of need*, as real speakers plan inhalations at
grammatical boundaries (breath-group theory).  Inhale depth scales with
the deficit: near-empty lungs produce a longer, more audible gasp.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

# phonemes comfortably produced on one full breath at duration_scale 1.0
# (~60 phonemes ≈ 4-5 s of speech at typical rates — the upper end of
# published breath-group durations)
CAPACITY_PHONEMES = 60.0
# the planner keeps this much air in reserve: real speakers inhale well
# before their lungs are empty
RESERVE = 0.25

# phrase boundaries: sentence punctuation, clause commas, em-dashes,
# ellipses.  The delimiter stays attached to the phrase it terminates so
# per-phrase G2P sees the same local context.
_PHRASE_RE = re.compile(r"[^,;:.!?…—]+[,;:.!?…—]*")


@dataclass(frozen=True)
class BreathEvent:
    """An inhale at a phrase boundary: ``after_phrase`` indexes the phrase
    the speaker just finished; intensity/duration grow with air deficit."""

    after_phrase: int
    intensity: float
    duration: float
    air_before: float  # reservoir level that triggered the breath


def split_phrases(text: str) -> List[str]:
    """Split text into phrases at punctuation boundaries (delimiters kept,
    whitespace trimmed, empties dropped)."""
    return [m.group(0).strip() for m in _PHRASE_RE.finditer(text) if m.group(0).strip()]


def phrase_air_cost(n_phonemes: int, lung_capacity: float,
                    duration_scale: float = 1.0) -> float:
    """Fraction of a full breath spent producing ``n_phonemes`` phonemes."""
    lc = min(max(float(lung_capacity), 0.05), 1.0)
    return float(n_phonemes) * float(duration_scale) / (CAPACITY_PHONEMES * lc)


def plan_breaths(
    phrase_phonemes: Sequence[int],
    lung_capacity: float,
    duration_scale: float = 1.0,
) -> List[Optional[BreathEvent]]:
    """Plan inhales between phrases.

    Returns one slot per interior boundary (length ``len(phrase_phonemes)
    - 1``): ``BreathEvent`` if the speaker inhales after phrase ``i``,
    else None.  Deterministic; monotone in need — lower capacity, longer
    phrases, or slower speech can only add breaths and deepen them
    (tests/test_breath.py pins both directions).
    """
    costs = [phrase_air_cost(n, lung_capacity, duration_scale)
             for n in phrase_phonemes]
    out: List[Optional[BreathEvent]] = []
    air = 1.0
    for i, cost in enumerate(costs):
        air -= cost
        if i == len(costs) - 1:
            break  # utterance over — no trailing breath
        air = max(air, 0.0)
        if air - costs[i + 1] < RESERVE:
            deficit = 1.0 - air
            out.append(BreathEvent(
                after_phrase=i,
                # shallow top-up → quiet short inhale; empty lungs → gasp
                intensity=round(0.35 + 0.55 * deficit, 4),
                duration=round(0.25 + 0.4 * deficit, 4),
                air_before=round(air, 4),
            ))
            air = 1.0
        else:
            out.append(None)
    return out
