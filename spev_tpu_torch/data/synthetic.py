"""Synthetic formant-speech corpus: offline data with learnable structure
(counterpart of ``spev_tpu.data.synthetic``).

Source–filter speech from a 10-phone inventory (vowel formant stacks,
fricative noise bands, a nasal murmur, a plosive burst, silence), with
per-phone durations under small lognormal jitter, an F0 declination (210 →
150 Hz) with per-phone accents, and Praat TextGrids on the mel hop grid, so
duration targets come from the TextGrid path.  An acoustic model that learns
the phone → spectrum map drives teacher-forced MCD far below its random-init
level; ``tools/torch_quality_run.py`` trains on it.

Host numpy/scipy, as in the JAX package, with the same
``np.random.RandomState`` draw order: from one seed both packages write the
same wavs, TextGrids and transcripts byte for byte.
"""


from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from spev_tpu_torch.utils.wavio import write_wav


@dataclass(frozen=True)
class Phone:
    name: str
    kind: str  # 'vowel' | 'nasal' | 'fricative' | 'plosive' | 'sil'
    formants: Tuple[Tuple[float, float], ...]  # (freq_hz, bandwidth_hz)
    mean_frames: int
    level: float  # linear amplitude
    voiced: bool


# A compact, acoustically well-separated inventory.  Formant values are
# textbook male-ish targets; bandwidths widened slightly for stable IIRs.
_INVENTORY: Tuple[Phone, ...] = (
    Phone("AA", "vowel", ((730, 90), (1090, 110), (2440, 160)), 14, 0.30, True),
    Phone("IY", "vowel", ((270, 60), (2290, 140), (3010, 200)), 12, 0.28, True),
    Phone("UW", "vowel", ((300, 70), (870, 100), (2240, 160)), 13, 0.26, True),
    Phone("EH", "vowel", ((530, 80), (1840, 120), (2480, 160)), 11, 0.28, True),
    Phone("OW", "vowel", ((570, 80), (840, 100), (2410, 160)), 15, 0.28, True),
    Phone("M", "nasal", ((250, 60), (1000, 300), (2200, 300)), 8, 0.18, True),
    Phone("S", "fricative", ((5500, 2000),), 9, 0.12, False),
    Phone("SH", "fricative", ((2500, 1200),), 9, 0.14, False),
    Phone("T", "plosive", ((3500, 2500),), 4, 0.15, False),
    Phone("<SIL>", "sil", (), 6, 0.0, False),
)

_PHONES = {p.name: p for p in _INVENTORY}
_VOWELS = [p.name for p in _INVENTORY if p.kind == "vowel"]
_CONS = [p.name for p in _INVENTORY if p.kind in ("nasal", "fricative", "plosive")]


def _resonator(y: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """Second-order all-pole formant resonator, unit gain at the pole
    frequency (classic Klatt cascade element)."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a1, a2 = -2 * r * np.cos(theta), r * r
    b0 = (1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * theta) + r * r)
    from scipy.signal import lfilter

    return lfilter([b0], [1.0, a1, a2], y)


def _harmonic_source(f0: np.ndarray, sr: int, rng: np.random.RandomState) -> np.ndarray:
    """Band-limited glottal-ish source: harmonics at k·f0 with 1/k rolloff
    up to 5 kHz, plus 1% aspiration noise.  f0 is per-sample."""
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = np.zeros_like(f0)
    kmax = int(5000.0 / max(float(f0.min()), 1.0))
    for k in range(1, max(2, kmax + 1)):
        mask = k * f0 < 5000.0
        y += np.where(mask, np.sin(k * phase) / k, 0.0)
    return y + 0.01 * rng.randn(len(f0))


def _phone_audio(
    phone: Phone, n: int, f0: np.ndarray, sr: int, rng: np.random.RandomState
) -> np.ndarray:
    if phone.kind == "sil":
        return 1e-4 * rng.randn(n)
    if phone.voiced:
        src = _harmonic_source(f0, sr, rng)
    else:
        src = rng.randn(n)
    y = src
    for freq, bw in phone.formants:
        y = _resonator(y, freq, bw, sr)
    peak = np.max(np.abs(y)) + 1e-9
    y = y / peak * phone.level
    if phone.kind == "plosive":
        # burst: sharp attack, exponential decay
        y = y * np.exp(-np.arange(n) / (0.25 * n + 1))
    # 5 ms raised-cosine edges against clicks
    e = min(int(0.005 * sr), n // 2)
    if e > 0:
        ramp = 0.5 * (1 - np.cos(np.linspace(0, np.pi, e)))
        y[:e] *= ramp
        y[-e:] *= ramp[::-1]
    return y


def _sample_phone_seq(rng: np.random.RandomState, n_syllables: int) -> List[str]:
    seq = ["<SIL>"]
    for _ in range(n_syllables):
        if rng.rand() < 0.85:
            seq.append(_CONS[rng.randint(len(_CONS))])
        seq.append(_VOWELS[rng.randint(len(_VOWELS))])
        if rng.rand() < 0.15:
            seq.append("<SIL>")
    seq.append("<SIL>")
    return seq


def _write_textgrid(path: str, phones: List[str], bounds_s: List[float]) -> None:
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0.0",
        f"xmax = {bounds_s[-1]:.8f}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        '        name = "phones"',
        "        xmin = 0.0",
        f"        xmax = {bounds_s[-1]:.8f}",
        f"        intervals: size = {len(phones)}",
    ]
    for i, ph in enumerate(phones):
        mark = "" if ph == "<SIL>" else ph
        lines += [
            f"        intervals [{i + 1}]:",
            f"            xmin = {bounds_s[i]:.8f}",
            # +5e-6 s guards int() truncation in intervals_to_durations
            f"            xmax = {bounds_s[i + 1] + 5e-6:.8f}",
            f'            text = "{mark}"',
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def emotion_prosody(vad) -> Tuple[float, float, float]:
    """Per-emotion prosody register (f0_mult, duration_mult, level_mult)
    as an exact LOG-LINEAR function of the (V, A, D) coordinates, so the
    advanced model's linear ``vad_proj`` can represent the corpus's
    emotion→prosody map perfectly: arousal raises pitch/rate/energy,
    valence brightens pitch slightly and low valence slows the rate,
    dominance adds level (the directions of `agents.prosody.vad_to_knobs`
    and the production-speech literature)."""
    v, a, d = (float(x) for x in vad)
    return (
        float(np.exp(0.18 * a + 0.05 * v)),   # F0 register
        float(np.exp(-0.12 * a - 0.05 * v)),  # speaking rate (duration)
        float(np.exp(0.20 * a + 0.10 * d)),   # vocal effort (level)
    )


def speaker_voice(k: int, n_speakers: int) -> Tuple[float, float]:
    """Deterministic per-speaker voice: (f0_multiplier, formant_scale).
    Speakers spread over ~[0.72, 1.39]× F0 (≈ half an octave either way)
    and [0.90, 1.10]× vocal-tract formant scaling — separations far above
    the corpus's per-utterance jitter, so speaker identity is learnable."""
    if n_speakers <= 1:
        return 1.0, 1.0
    t = k / (n_speakers - 1)  # 0..1
    return float(np.exp(-0.33 + 0.66 * t)), float(0.90 + 0.20 * t)


def generate_formant_corpus(
    out_dir: str,
    n_utterances: int = 200,
    seed: int = 0,
    sr: int = 22050,
    hop_length: int = 256,
    syllable_range: Tuple[int, int] = (3, 7),
    duration_jitter: float = 0.05,
    textgrid_dir: Optional[str] = None,
    n_speakers: int = 1,
    emotions: Optional[Tuple[str, ...]] = None,
) -> str:
    """Generate ``n_utterances`` wav + TextGrid pairs.  Returns the
    TextGrid directory (defaults to ``out_dir``/textgrids).

    Phone boundaries land exactly on the hop grid, so TextGrid-derived
    frame durations equal the generated ones.

    With ``n_speakers > 1`` (the multi-speaker stretch config), utterances
    are assigned round-robin to speakers with distinct deterministic
    voices (`speaker_voice`: F0 register + vocal-tract formant scaling)
    and named ``spk{k}_utt{u:04d}.*`` so ``SpevDataset(multi_speaker=True)``
    derives the speaker label from the basename prefix.

    With ``emotions`` (a tuple of `data.emotion.EMOTION_VAD` names),
    utterances are assigned round-robin to emotions; each emotion applies
    its `emotion_prosody` register (F0 / rate / level shifts, log-linear
    in the emotion's VAD coordinates) and the files are named
    ``...utt{u:04d}_{emotion}.*`` so ``SpevDataset(emotion_vad=True)``
    derives the label from the basename suffix — the offline corpus for
    proving the trainable VAD pathway end-to-end.
    """
    os.makedirs(out_dir, exist_ok=True)
    tg_dir = textgrid_dir or os.path.join(out_dir, "textgrids")
    os.makedirs(tg_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    if emotions:
        from spev_tpu_torch.data.emotion import EMOTION_VAD

        unknown = [e for e in emotions if e not in EMOTION_VAD]
        if unknown:
            raise ValueError(f"unknown emotions {unknown}; known: "
                             f"{sorted(EMOTION_VAD)}")

    for u in range(n_utterances):
        spk = u % max(1, n_speakers)
        f0_mult, fm_scale = speaker_voice(spk, n_speakers)
        emo, dur_mult, lvl_mult = None, 1.0, 1.0
        if emotions:
            emo = emotions[u % len(emotions)]
            e_f0, dur_mult, lvl_mult = emotion_prosody(EMOTION_VAD[emo])
            f0_mult *= e_f0
        n_syll = rng.randint(syllable_range[0], syllable_range[1] + 1)
        phones = _sample_phone_seq(rng, n_syll)
        frames = [
            max(2, int(round(_PHONES[p].mean_frames * dur_mult
                             * np.exp(duration_jitter * rng.randn()))))
            for p in phones
        ]
        total_frames = sum(frames)
        n_samples = total_frames * hop_length

        # utterance F0 contour: declination + per-phone accent
        f0_start = 210.0 * f0_mult * np.exp(0.03 * rng.randn())
        f0_end = 150.0 * f0_mult * np.exp(0.03 * rng.randn())
        base = np.linspace(f0_start, f0_end, n_samples)
        f0 = base.copy()
        cur = 0
        for p, d in zip(phones, frames):
            n = d * hop_length
            accent = np.exp(0.04 * rng.randn())
            f0[cur : cur + n] *= accent
            cur += n

        y = np.zeros(n_samples)
        cur = 0
        bounds = [0.0]
        for p, d in zip(phones, frames):
            n = d * hop_length
            ph = _PHONES[p]
            if fm_scale != 1.0 and ph.formants:
                from dataclasses import replace

                ph = replace(ph, formants=tuple(
                    (f * fm_scale, bw) for f, bw in ph.formants))
            seg = _phone_audio(ph, n, f0[cur : cur + n], sr, rng)
            if lvl_mult != 1.0 and ph.kind != "sil":
                seg = np.clip(seg * lvl_mult, -1.0, 1.0)
            y[cur : cur + n] = seg
            cur += n
            bounds.append(cur / sr)

        name = f"utt{u:04d}" if n_speakers <= 1 else f"spk{spk}_utt{u:04d}"
        if emo is not None:
            name = f"{name}_{emo}"
        write_wav(os.path.join(out_dir, f"{name}.wav"), y.astype(np.float32), sr)
        _write_textgrid(os.path.join(tg_dir, f"{name}.TextGrid"), phones, bounds)
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(" ".join(p for p in phones if p != "<SIL>"))
    return tg_dir
