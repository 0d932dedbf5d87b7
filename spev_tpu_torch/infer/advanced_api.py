"""Advanced-control synthesis over a `Synthesizer`.  Counterpart of
``spev_tpu.infer.advanced_api``: VAD emotion knobs, the age pitch rule,
lung-capacity breath planning, per-word emphasis, and the learned and DSP
voice-quality controls.  It runs on the Synthesizer's device, under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spev_tpu_torch.agents.breath import plan_breaths, split_phrases
from spev_tpu_torch.agents.events import VocalEventSynth
from spev_tpu_torch.agents.prosody import vad_to_knobs
from spev_tpu_torch.models.advanced import age_pitch_scale, lung_capacity_effect
from spev_tpu_torch.ops.mel_dsp import apply_voice_quality
from spev_tpu_torch.text.emphasis import parse_emphasis, word_emphasis_to_phonemes
from spev_tpu_torch.text.g2p import WORD_RE


@torch.inference_mode()
def synthesize_advanced_controls(
    synth,
    text: str,
    *,
    breathiness: float = 0.0,
    roughness: float = 0.0,
    brightness: float = 0.0,
    nasality: float = 0.0,
    valence: float = 0.0,
    arousal: float = 0.0,
    dominance: float = 0.0,
    age: float = 25.0,
    lung_capacity: float = 1.0,
    word_emphasis: str = "",
    speaker: Optional[int] = None,
    pitch_scale: float = 1.0,
    duration_scale: float = 1.0,
    energy_scale: float = 1.0,
    dsp_seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(waveform, log-mel) with the full advanced control surface applied.

    - VAD (valence/arousal/dominance) → the base prosody knobs AND the
      learned emotion projection when the checkpoint carries one;
    - ``age`` scales pitch by ``1 + (25 − age)·0.008``;
    - ``lung_capacity`` < 1 boosts breathiness, stretches durations, and
      runs the breath planner (`agents.breath`): where the air budget says
      the speaker cannot finish the next phrase, an inhale
      (`VocalEventSynth.generate_breath_in`) between two 60 ms pauses is
      inserted at the phrase boundary and the waveform is assembled phrase
      by phrase, so it is LONGER than ``len(mel)·hop`` (the mel covers the
      speech frames only);
    - ``word_emphasis`` "1.0,1.5,…" scales each word's per-phoneme
      duration, pitch and energy;
    - breathiness/roughness/nasality drive the learned channels (when the
      checkpoint has them) AND the mel-domain DSP (`ops.mel_dsp`); with any
      of them set, each span is vocoded a second time from the DSP mel.
    """
    knobs = vad_to_knobs(valence, arousal, dominance)
    lung = lung_capacity_effect(lung_capacity)

    pitch_s = age_pitch_scale(age, pitch_scale * knobs["pitch_scale"])
    duration_s = duration_scale * knobs["duration_scale"] * lung.duration_scale
    energy_s = energy_scale * knobs.get("energy_scale", 1.0)

    word_scales = parse_emphasis(word_emphasis) if word_emphasis.strip() else None
    has_advanced = synth.has_advanced

    def segment(seg_text: str, seg_scales, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """One speech span (the whole utterance, or one phrase on the breath
        path) under the shared control state."""
        phones = synth.g2p.phonemes(seg_text)
        n = len(phones)
        breath = np.clip(
            np.full((n,), knobs["breathiness"] + 0.5 * breathiness + lung.breath_boost),
            0.0, 0.8,
        ).astype(np.float32)
        rough = np.clip(
            np.full((n,), knobs["roughness"] + 0.5 * roughness), 0.0, 1.5
        ).astype(np.float32)
        bright = np.clip(
            np.full((n,), knobs["brightness"] + brightness - 0.8 * nasality), -2.5, 2.5
        ).astype(np.float32)

        emphasis_vec = None
        if seg_scales is not None:
            per_word = synth.g2p.phonemes_per_word(seg_text)
            emphasis = word_emphasis_to_phonemes(seg_scales, per_word)
            emphasis_vec = np.ones((n,), np.float32)
            m = min(len(emphasis), n)
            emphasis_vec[:m] = emphasis[:m]

        ids = synth.phonemes_to_ids(phones)
        nasal_vec = (
            np.full((n,), np.clip(nasality, 0.0, 1.0), np.float32)
            if synth.model_cfg.use_nasality else None
        )
        wav, mel = synth.synthesize_ids(
            ids,
            breath=breath,
            rough=rough,
            bright=bright,
            nasal=nasal_vec,
            duration_scale=duration_s if emphasis_vec is None else duration_s * emphasis_vec,
            pitch_scale=pitch_s if emphasis_vec is None else pitch_s * emphasis_vec,
            energy_scale=energy_s if emphasis_vec is None else energy_s * emphasis_vec,
            speaker_id=speaker if has_advanced else None,
            vad=(valence, arousal, dominance) if has_advanced else None,
        )

        # mel-domain DSP effects, then re-vocode if any is active
        if breathiness or roughness or nasality:
            mel_t = apply_voice_quality(
                torch.as_tensor(mel, device=synth.device)[None],
                seed,
                breathiness=breathiness,
                roughness=roughness,
                nasality=nasality,
            )[0]
            mel = mel_t.cpu().numpy()
            wav = synth.vocoder.infer(mel_t)
        return np.asarray(wav, np.float32), mel

    # ---- breath-need path: phrase-wise assembly with planned inhales ----
    plan = None
    phrases: List[str] = []
    if lung_capacity < 1.0:
        phrases = split_phrases(text)
        if len(phrases) > 1:
            counts = [len(synth.g2p.phonemes(p)) for p in phrases]
            plan = plan_breaths(counts, lung_capacity, duration_scale=duration_s)
            if not any(plan):
                plan = None
    if plan is None:
        return segment(text, word_scales, dsp_seed)

    sr = synth.audio.sample_rate
    events = VocalEventSynth(sr=sr, seed=dsp_seed, device=synth.device)
    pause = np.zeros(int(0.06 * sr), np.float32)  # settle around the inhale
    wavs, mels = [], []
    w_off = 0
    for i, phrase in enumerate(phrases):
        seg_scales = None
        if word_scales is not None:
            # count words with the tokenization phonemes_per_word uses (a
            # whitespace split miscounts hyphenated words and decimals)
            n_words = len(WORD_RE.findall(phrase))
            seg_scales = word_scales[w_off : w_off + n_words]
            w_off += n_words
        wav_i, mel_i = segment(phrase, seg_scales, dsp_seed + i)
        wavs.append(wav_i)
        mels.append(mel_i)
        if i < len(phrases) - 1 and plan[i] is not None:
            ev = plan[i]
            wavs.extend([pause, events.generate_breath_in(ev.duration, ev.intensity), pause])
    return np.concatenate(wavs), np.concatenate(mels, axis=0)
