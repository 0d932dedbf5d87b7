"""Praat TextGrid parser for forced-alignment output (own copy of
``spev_tpu.text.textgrid``): the long ("ooTextFile") and short forms, the
``phones``/``phonemes`` tier, and per-phoneme frame durations."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class Interval:
    xmin: float
    xmax: float
    mark: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval]


def parse_textgrid(path: str) -> List[Tier]:
    with open(path, encoding="utf-8", errors="replace") as f:
        content = f.read()
    if "xmin" in content and "item" in content:
        return _parse_long(content)
    return _parse_short(content)


def _parse_long(content: str) -> List[Tier]:
    tiers: List[Tier] = []
    for item in re.split(r"item\s*\[\d+\]\s*:", content)[1:]:
        cls = re.search(r'class\s*=\s*"([^"]*)"', item)
        if not cls or cls.group(1) != "IntervalTier":
            continue
        name = re.search(r'name\s*=\s*"([^"]*)"', item)
        ivs = []
        for m in re.finditer(
            r'intervals\s*\[\d+\]\s*:\s*xmin\s*=\s*([\d.eE+-]+)\s*xmax\s*=\s*([\d.eE+-]+)\s*text\s*=\s*"((?:[^"]|"")*)"',
            item,
        ):
            ivs.append(Interval(float(m.group(1)), float(m.group(2)), m.group(3).replace('""', '"')))
        tiers.append(Tier(name.group(1) if name else "", ivs))
    return tiers


def _parse_short(content: str) -> List[Tier]:
    # header lines, then per tier: "IntervalTier", name, xmin, xmax, n, then
    # n triples (xmin, xmax, text)
    tokens = [line.strip() for line in content.splitlines() if line.strip()]
    tiers: List[Tier] = []
    i = 0
    while i < len(tokens):
        if tokens[i].strip('"') == "IntervalTier":
            name = tokens[i + 1].strip('"')
            n = int(float(tokens[i + 4]))
            ivs = []
            j = i + 5
            for _ in range(n):
                ivs.append(Interval(float(tokens[j]), float(tokens[j + 1]), tokens[j + 2].strip('"')))
                j += 3
            tiers.append(Tier(name, ivs))
            i = j
        else:
            i += 1
    return tiers


def phone_intervals(path: str) -> Optional[List[Interval]]:
    """The first tier named ``phones`` or ``phonemes`` (any case)."""
    for tier in parse_textgrid(path):
        if tier.name.lower() in ("phones", "phonemes"):
            return tier.intervals
    return None


def intervals_to_durations(intervals: List[Interval], sr: int = 22050,
                           hop_length: int = 256) -> Tuple[List[str], List[int]]:
    """frames = int((xmax - xmin)·sr/hop); zero-frame intervals dropped;
    empty marks become ``<SIL>``."""
    phs, durs = [], []
    for iv in intervals:
        frames = int((iv.xmax - iv.xmin) * sr / hop_length)
        if frames > 0:
            phs.append(iv.mark if iv.mark else "<SIL>")
            durs.append(frames)
    return phs, durs
