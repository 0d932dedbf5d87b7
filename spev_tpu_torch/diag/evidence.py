"""Measured evidence that the learned and rule-based controls work: the
counterparts of the JAX package's ``tools/emotion_register_demo.py``,
``tools/multispeaker_demo.py`` and ``tools/advanced_controls_demo.py``,
with their names, setups and JSON keys.

- `train_emotion_registers`: an emotion-conditioned formant corpus, the
  advanced model with the VAD pathway trained on it, then
  `measure_registers` (the same phonemes under each emotion's (V, A, D),
  through the learned embedding only) and `per_emotion_eval`.
- `train_multispeaker`: a 3-speaker formant corpus, the advanced model with
  a speaker table, then `per_speaker_eval` and `speaker_identity` (the same
  phonemes as each speaker, voiced F0 of the audio).

The register and identity texts are read as the corpus's phoneme names
(`PhonemeReader`), where the JAX tools' G2P turns them into silences (F3);
the sweeps' English texts go through the rules G2P, as the JAX tool's do.
- `control_sweeps`: age, word emphasis, nasality and lung capacity swept
  through `synthesize_advanced_controls` on a trained checkpoint, each
  measured by its documented physical effect.

Every entry point takes ``device`` ("cuda" by default; raises without a
GPU).  The sizes a test cuts (utterances, width, epochs) are keyword
arguments whose defaults are the JAX tools'.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

EMOTIONS = ("neutral", "happy", "sad", "angry")
N_SPEAKERS = 3
REGISTER_TEXT = "AA M OW S IY AH N AA"  # vowel-rich for stable F0 tracking
IDENTITY_TEXT = "AA M OW S IY"  # a held-out utterance's phonemes
CONTROL_TEXT = "the quick onset of the storm caught everyone"
AGES = (10, 25, 45, 70)
EMPHASIS_TEXT = "alpha bravo charlie delta"
EMPHASIS_SPEC = "1,1,2.0,1"
NASALITIES = (0.0, 0.5, 1.0)
LUNG_TEXT = ("first the wind rose over the hills, then the rain came "
             "down in sheets, and finally the thunder rolled away")
LUNG_CAPACITIES = (1.0, 0.6, 0.3)
# the JAX tools' buckets: training and the register / identity synthesis,
# and the control sweeps
TRAIN_BUCKETS = dict(phoneme_buckets=(32,), frame_buckets=(256,))
SWEEP_BUCKETS = dict(phoneme_buckets=(64,), frame_buckets=(256, 512))


# -- measurements ---------------------------------------------------------------


class PhonemeReader:
    """A G2P that reads a text as the phoneme names it spells, one per
    space-separated token, between two ``<SIL>``.

    The register and identity texts ("AA M OW S IY ...") name phonemes of
    the formant corpus.  The JAX tools pass them through the rules G2P,
    which spells them in IPA characters that are not in the corpus's
    vocabulary, so every id falls back to ``<SIL>`` and the proofs measure
    an utterance of silences (ROADMAP.md, section 4, F3).  A `Synthesizer`
    given this reader as its ``g2p`` synthesizes the named phonemes."""

    @staticmethod
    def phonemes(text: str) -> list:
        return ["<SIL>", *text.split(), "<SIL>"]

    @staticmethod
    def phonemes_per_word(text: str) -> list:
        return [[p] for p in text.split()]



def median_f0(wav, sr: int, device="cuda") -> float:
    """Median voiced F0 of ``wav`` by pyin (default hop 512), NaN when no
    frame is voiced."""
    from spev_tpu_torch.ops.features import pyin_f0
    from spev_tpu_torch.utils.platform import resolve_device

    y = torch.as_tensor(np.asarray(wav, np.float32), device=resolve_device(device))
    f0, voiced, _prob = pyin_f0(y, sr=sr)
    f0 = f0.cpu().numpy()[voiced.cpu().numpy() > 0.5]
    return float(np.median(f0)) if f0.size else float("nan")


def _voiced_f0(wav, audio, device) -> float:
    """Median F0 over the frames pyin marks voiced at the audio's hop (the
    register and identity proofs' audio column), NaN when none is."""
    from spev_tpu_torch.ops.features import pyin_f0

    y = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    f0, vflag, _ = pyin_f0(y, sr=audio.sample_rate, hop_length=audio.hop_length)
    f0, vflag = f0.cpu().numpy(), vflag.cpu().numpy().astype(bool)
    voiced = np.isfinite(f0) & vflag
    return float(np.median(f0[voiced])) if voiced.any() else float("nan")


def spectral_tilt(mel) -> float:
    """High-band minus low-band mean log-mel energy (a tilt proxy)."""
    m = np.asarray(mel)
    n = m.shape[1]
    return float(m[:, 2 * n // 3 :].mean() - m[:, : n // 3].mean())


@torch.inference_mode()
def model_pitch_hz(synth, ids, vad=None, pitch_scale: float = 1.0) -> float:
    """The pitch the acoustic model uses for ``ids`` (its pitch head times
    ``pitch_scale``, as the forward applies ``p_control``), de-normalised to
    Hz with the checkpoint's ``p_mean``/``p_std``: the median over the
    phones whose prediction is off the unvoiced 0-target (|z| > 1e-3), else
    over all.  ``vad`` feeds the learned projection when the model has one."""
    from spev_tpu_torch.models.advanced import apply_advanced

    p_mean = float(synth.stats.get("p_mean", 0.0))
    p_std = float(synth.stats.get("p_std", 1.0))
    P = synth.phoneme_buckets[-1]
    ids_pad = np.zeros((1, P), np.int64)
    ids_pad[0, : len(ids)] = ids
    dev = synth.device
    out = apply_advanced(synth.model, torch.as_tensor(ids_pad, device=dev),
                         torch.tensor([len(ids)], dtype=torch.int32, device=dev),
                         vad=None if vad is None else torch.tensor([list(vad)],
                                                                   dtype=torch.float32,
                                                                   device=dev))
    pp = out["pitch_pred"][0, : len(ids)].float().cpu().numpy()
    hz = np.exp(pp * pitch_scale * p_std + p_mean)
    voiced = np.abs(pp) > 1e-3
    return float(np.median(hz[voiced]) if voiced.any() else np.median(hz))


def measure_registers(ckpt: str, out_path: str, wav_dir: Optional[str] = None,
                      extra: Optional[dict] = None, device="cuda") -> dict:
    """Register proof on a trained checkpoint: the phonemes `REGISTER_TEXT`
    names (`PhonemeReader`) under each of `EMOTIONS`' (V, A, D) through
    the learned embedding only.  The primary F0 is `model_pitch_hz`; the
    audio's voiced pyin F0 (Griffin-Lim) is the secondary column.  Frames
    come from the synthesized mel; the corpus columns from
    `data.synthetic.emotion_prosody`.  Writes ``out_path``."""
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.data.emotion import EMOTION_VAD
    from spev_tpu_torch.data.synthetic import emotion_prosody
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.utils.wavio import write_wav

    synth = Synthesizer(ckpt, hifigan_dir=None, g2p_backend="rules", device=device,
                        **TRAIN_BUCKETS)
    synth.g2p = PhonemeReader()
    ids = synth.phonemes_to_ids(synth.g2p.phonemes(REGISTER_TEXT))
    audio = AudioConfig()
    registers = {}
    for emo, vad in EMOTION_VAD.items():
        if emo not in EMOTIONS:
            continue
        pred_hz = model_pitch_hz(synth, ids, vad=vad)
        wav, mel = synth.synthesize_ids(ids, vad=vad)
        hz = _voiced_f0(wav, audio, synth.device)
        corpus_f0, corpus_dur, _lvl = emotion_prosody(vad)
        registers[emo] = {
            "vad": list(vad),
            "pred_f0_hz": round(pred_hz, 2),
            "synth_f0_hz": round(hz, 2),
            "synth_frames": int(mel.shape[0]),
            "corpus_f0_mult": round(corpus_f0, 3),
            "corpus_dur_mult": round(corpus_dur, 3),
        }
        print(f"{emo}: predicted F0 {pred_hz:.1f} Hz (audio pyin {hz:.1f}), "
              f"{mel.shape[0]} frames (corpus registers {corpus_f0:.3f}x F0, "
              f"{corpus_dur:.3f}x dur)", flush=True)
        if wav_dir:
            os.makedirs(wav_dir, exist_ok=True)
            write_wav(os.path.join(wav_dir, f"emo_{emo}_same_text.wav"),
                      np.clip(wav, -1, 1), audio.sample_rate)
    f0_of = {e: registers[e]["pred_f0_hz"] for e in EMOTIONS}
    fr_of = {e: registers[e]["synth_frames"] for e in EMOTIONS}
    out = {
        **(extra or {}),
        "registers": registers,
        "f0_register_ordered": bool(f0_of["happy"] > f0_of["neutral"] > f0_of["sad"]),
        "duration_register_ordered": bool(fr_of["sad"] > fr_of["neutral"] >= fr_of["happy"]),
    }
    _write_json(out_path, out)
    print(json.dumps({k: out[k] for k in ("f0_register_ordered", "duration_register_ordered")},
                     indent=1))
    print("written:", out_path)
    return out


def _group_rows(per_utterance: dict, label_of: dict, labels) -> dict:
    """Held-out rows grouped by label: n and the means of MCD, duration
    error and F0 RMSE (NaN for an empty group, as numpy's mean gives)."""
    rows = {}
    for lab in labels:
        rs = [v for i, v in per_utterance.items() if label_of[i] == lab]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the mean of an empty group
            rows[lab] = {
                "n": len(rs),
                "mcd_db": round(float(np.mean([r["mcd_db"] for r in rs])), 2),
                "dur_err_pct": round(float(np.mean([r["dur_err_pct"] for r in rs])), 2),
                "f0_rmse_hz": round(float(np.mean([r["f0_rmse_hz"] for r in rs
                                                   if "f0_rmse_hz" in r])), 2),
            }
    return rows


def per_emotion_eval(ckpt: str, ds, va_idx, device="cuda") -> dict:
    """Held-out evaluation rows grouped by emotion: each utterance's label
    is the `EMOTION_VAD` row nearest to its cached float32 VAD target."""
    from spev_tpu_torch.data.emotion import EMOTION_VAD
    from spev_tpu_torch.infer.evaluate import evaluate_checkpoint

    res = evaluate_checkpoint(ckpt, ds, indices=list(va_idx), batch_size=16, device=device,
                              **TRAIN_BUCKETS)
    emos = sorted(EMOTION_VAD)
    table = np.asarray([EMOTION_VAD[e] for e in emos], np.float64)
    emo_of = {}
    for i in va_idx:
        v = np.asarray(ds.load_utterance(i)["vad"], np.float64)
        emo_of[i] = emos[int(np.argmin(np.sum((table - v) ** 2, axis=1)))]
    rows = _group_rows(res["per_utterance"], emo_of, sorted(set(emo_of.values())))
    rows = {e: r for e, r in rows.items() if r["n"]}
    for emo, row in rows.items():
        print(f"{emo} val: {row}", flush=True)
    return rows


def per_speaker_eval(ckpt: str, ds, va_idx, n_speakers: int = N_SPEAKERS,
                     device="cuda") -> dict:
    """Held-out evaluation by speaker: ``{"aggregate_val": ...,
    "per_speaker_val": {"spk<k>": row}}`` (a speaker without held-out
    utterances has n 0 and NaN means)."""
    from spev_tpu_torch.infer.evaluate import evaluate_checkpoint

    res = evaluate_checkpoint(ckpt, ds, indices=va_idx, batch_size=8, device=device,
                              **TRAIN_BUCKETS)
    spk_of = {i: f"spk{int(ds.load_utterance(i)['speaker_id'])}" for i in va_idx}
    rows = _group_rows(res["per_utterance"], spk_of, [f"spk{k}" for k in range(n_speakers)])
    for name, row in rows.items():
        print(f"{name} val: {row}", flush=True)
    return {"aggregate_val": res["aggregate"], "per_speaker_val": rows}


def speaker_identity(synth, n_speakers: int = N_SPEAKERS, wav_dir: Optional[str] = None) -> dict:
    """The identity proof: `IDENTITY_TEXT` as each speaker (read by ``synth``'s
    G2P: `train_multispeaker` gives it a `PhonemeReader`), the median voiced
    pyin F0 of the audio beside the corpus's register.  Returns ``{"identity":
    {"spk<k>": ...}, "identity_f0_ordered": spk0 < spk1 < ...}``."""
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.data.synthetic import speaker_voice
    from spev_tpu_torch.infer.advanced_api import synthesize_advanced_controls
    from spev_tpu_torch.utils.wavio import write_wav

    audio = AudioConfig()
    identity = {}
    for k in range(n_speakers):
        wav, _ = synthesize_advanced_controls(synth, IDENTITY_TEXT, speaker=k)
        hz = _voiced_f0(wav, audio, synth.device)
        identity[f"spk{k}"] = {"synth_f0_hz": round(hz, 2),
                               "corpus_f0_mult": round(speaker_voice(k, n_speakers)[0], 3)}
        print(f"spk{k}: synthesized voiced F0 {hz:.1f} Hz (corpus register "
              f"{identity[f'spk{k}']['corpus_f0_mult']}x)", flush=True)
        if wav_dir:
            os.makedirs(wav_dir, exist_ok=True)
            write_wav(os.path.join(wav_dir, f"ms_spk{k}_same_text.wav"), np.clip(wav, -1, 1),
                      audio.sample_rate)
    f0s = [identity[f"spk{k}"]["synth_f0_hz"] for k in range(n_speakers)]
    return {"identity": identity,
            "identity_f0_ordered": bool(all(a < b for a, b in zip(f0s, f0s[1:])))}


def age_model_f0(synth) -> list:
    """Per age of `AGES`, the pitch the model uses on `CONTROL_TEXT` after
    the age rule (`model_pitch_hz` at ``age_pitch_scale(age,
    vad_to_knobs(0, 0, 0)["pitch_scale"])``, the scale
    `synthesize_advanced_controls` passes), with the neutral VAD when the
    model has the learned projection."""
    from spev_tpu_torch.agents.prosody import vad_to_knobs
    from spev_tpu_torch.models.advanced import age_pitch_scale

    ids = synth.phonemes_to_ids(synth.g2p.phonemes(CONTROL_TEXT))
    base = vad_to_knobs(0.0, 0.0, 0.0)["pitch_scale"]
    vad = (0.0, 0.0, 0.0) if synth.has_advanced else None
    return [model_pitch_hz(synth, ids, vad=vad, pitch_scale=age_pitch_scale(a, base))
            for a in AGES]


def control_sweeps(checkpoint: str, out_dir: str, text: str = CONTROL_TEXT,
                   device="cuda") -> dict:
    """Each advanced control swept on ``checkpoint`` through
    `synthesize_advanced_controls` (Griffin-Lim): age → median voiced F0 of
    the audio; word emphasis → frames; nasality → the mel's spectral tilt;
    lung capacity → speech frames, samples and the breaths the planner
    inserts.  Writes ``advanced_controls.json`` and the sweep wavs to
    ``out_dir``; returns the results."""
    from spev_tpu_torch.agents.breath import plan_breaths, split_phrases
    from spev_tpu_torch.infer.advanced_api import synthesize_advanced_controls
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.models.advanced import lung_capacity_effect
    from spev_tpu_torch.utils.wavio import write_wav

    os.makedirs(out_dir, exist_ok=True)
    synth = Synthesizer(checkpoint, hifigan_dir=None, g2p_backend="rules", device=device,
                        **SWEEP_BUCKETS)
    sr = synth.audio.sample_rate
    results = {"checkpoint": checkpoint, "text": text}

    rows = []
    for age in AGES:
        wav, _ = synthesize_advanced_controls(synth, text, age=age)
        rows.append({"age": age, "median_f0_hz": round(median_f0(wav, sr, synth.device), 1),
                     "formula_pitch_mult": round(1.0 + (25 - age) * 0.008, 3)})
        write_wav(os.path.join(out_dir, f"adv_age{age}.wav"), np.clip(wav, -1, 1), sr)
        print(rows[-1], flush=True)
    results["age_sweep"] = rows
    f0s = [r["median_f0_hz"] for r in rows]
    results["age_monotone_decreasing"] = bool(all(a >= b for a, b in zip(f0s, f0s[1:])))

    base_mel = synthesize_advanced_controls(synth, EMPHASIS_TEXT, word_emphasis="")[1]
    wav_e, emph_mel = synthesize_advanced_controls(synth, EMPHASIS_TEXT,
                                                   word_emphasis=EMPHASIS_SPEC)
    write_wav(os.path.join(out_dir, "adv_emphasis.wav"), np.clip(wav_e, -1, 1), sr)
    base_frames, emph_frames = int(base_mel.shape[0]), int(emph_mel.shape[0])
    results["emphasis"] = {
        "text": EMPHASIS_TEXT,
        "baseline_frames": base_frames,
        "emphasized_frames": emph_frames,
        "frames_gained_pct": round(100 * (emph_frames - base_frames) / max(base_frames, 1), 1),
        "emphasized_word": "charlie (2.0x)",
        "phonemes_per_word": [len(w) for w in synth.g2p.phonemes_per_word(EMPHASIS_TEXT)],
    }
    print(results["emphasis"], flush=True)

    rows = []
    for nas in NASALITIES:
        mel = synthesize_advanced_controls(synth, text, nasality=nas)[1]
        rows.append({"nasality": nas, "spectral_tilt": round(spectral_tilt(mel), 3)})
        print(rows[-1], flush=True)
    results["nasality_sweep"] = rows
    tilts = [r["spectral_tilt"] for r in rows]
    results["nasality_monotone_darkening"] = bool(all(a >= b for a, b in zip(tilts, tilts[1:])))

    rows = []
    phrases = split_phrases(LUNG_TEXT)
    counts = [len(synth.g2p.phonemes(p)) for p in phrases]
    for lc in LUNG_CAPACITIES:
        wav, mel = synthesize_advanced_controls(synth, LUNG_TEXT, lung_capacity=lc)
        plan = (plan_breaths(counts, lc, lung_capacity_effect(lc).duration_scale)
                if lc < 1.0 else [])
        rows.append({
            "lung_capacity": lc,
            "speech_frames": int(mel.shape[0]),
            "wav_samples": int(wav.shape[0]),
            "inserted_breaths": int(sum(e is not None for e in plan)),
            "breath_samples": int(wav.shape[0] - mel.shape[0] * synth.audio.hop_length),
        })
        write_wav(os.path.join(out_dir, f"adv_lung{int(lc * 100)}.wav"),
                  np.clip(np.asarray(wav, np.float32), -1, 1), sr)
        print(rows[-1], flush=True)
    results["lung_sweep"] = rows
    frames = [r["speech_frames"] for r in rows]
    breaths = [r["inserted_breaths"] for r in rows]
    results["lung_monotone"] = bool(all(a <= b for a, b in zip(frames, frames[1:]))
                                    and all(a <= b for a, b in zip(breaths, breaths[1:])))
    _write_json(os.path.join(out_dir, "advanced_controls.json"), results)
    print("written", os.path.join(out_dir, "advanced_controls.json"), flush=True)
    return results


# -- the training runs ------------------------------------------------------------


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _train(ds, model_kw: dict, epochs: int, work: str, device, hidden: int):
    """The JAX tools' recipe: hidden/embed ``hidden``, per-phoneme
    predictors, B=16, lr 2e-3, 50 warmup steps, 2 duration-only epochs, a
    0.1 validation split (seed 0), one bucket, validation every epoch.
    Returns (trainer, config, held-out indices)."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher, train_val_split
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    vocab = Vocab(ds.vocab)
    cfg = SpevConfig(
        model=ModelConfig(vocab_size=len(vocab), embed_dim=hidden, hidden_dim=hidden, n_mels=80,
                          max_frames=256, vp_output_norm=False, **model_kw),
        train=TrainConfig(batch_size=16, warmup_steps=50, epochs=epochs, warmup_epochs=2,
                          learning_rate=2e-3),
    )
    tr_idx, va_idx = train_val_split(len(ds), 0.1, seed=0)
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(work, "ck"),
                      log_dir=os.path.join(work, "logs"), device=device)
    bt = BucketBatcher(ds, vocab, batch_size=16, indices=tr_idx, **TRAIN_BUCKETS)
    bv = BucketBatcher(ds, vocab, batch_size=16, indices=va_idx, **TRAIN_BUCKETS)
    for epoch in range(epochs):
        m = trainer.train_epoch(bt.epoch(epoch))
        val = trainer.validate(bv.epoch(0))
        if epoch % 10 == 0 or epoch == epochs - 1:
            q = trainer.last_quality
            print(f"epoch {epoch}: loss {m['train_loss']:.3f} val {val:.3f} "
                  f"MCD {q.get('val_mcd_db', float('nan')):.1f} "
                  f"durerr {q.get('val_dur_err_pct', float('nan')):.1f}%", flush=True)
    return trainer, cfg, va_idx


def _final_quality(trainer) -> dict:
    return {k: round(float(v), 2) for k, v in trainer.last_quality.items()}


def train_emotion_registers(epochs: int = 150,
                            out_path: str = ".scratch/demo/emotion_metrics.json",
                            wav_dir: Optional[str] = None, device="cuda", *,
                            n_utterances: int = 160, hidden: int = 96,
                            work: Optional[str] = None) -> dict:
    """The trainable-VAD evidence: an emotion-conditioned formant corpus
    (`EMOTIONS`, seed 0), `SpevDataset(emotion_vad=True)`, the advanced
    model with ``use_vad`` trained for ``epochs``, then `measure_registers`
    with the projection's |w| and `per_emotion_eval` beside it.  Writes and
    returns the JSON of ``tools/emotion_register_demo.py``."""
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.data.synthetic import generate_formant_corpus
    from spev_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    work = work or tempfile.mkdtemp(prefix="spev_emo_")
    root = os.path.join(work, "corpus")
    tg = generate_formant_corpus(root, n_utterances=n_utterances, seed=0, emotions=EMOTIONS)
    ds = SpevDataset(root, textgrid_dir=tg, cache_dir=os.path.join(work, "cache"),
                     g2p_backend="rules", stats_sample=60, emotion_vad=True, device=dev)
    if sorted(ds.emotions) != sorted(EMOTIONS):
        raise AssertionError(f"the corpus's emotions are {ds.emotions}")
    trainer, _, va_idx = _train(ds, dict(use_vad=True), epochs, work, dev, hidden)
    ckpt = trainer.save("emo_demo", include_opt=False)
    w = trainer.model.advanced.vad_proj.weight.detach().abs().cpu().numpy()
    if not w.max() > 0:
        raise AssertionError("vad_proj never received gradient")
    print(f"vad_proj learned: |w| mean {w.mean():.4f} max {w.max():.4f}", flush=True)
    return measure_registers(ckpt, out_path, wav_dir=wav_dir, device=dev, extra={
        "epochs": epochs,
        "final_quality": _final_quality(trainer),
        "vad_proj_abs_mean": round(float(w.mean()), 5),
        "per_emotion_val": per_emotion_eval(ckpt, ds, va_idx, device=dev),
    })


def train_multispeaker(epochs: int = 150,
                       out_path: str = ".scratch/demo/multispeaker_metrics.json",
                       wav_dir: Optional[str] = None, device="cuda", *,
                       n_utterances: int = 150, hidden: int = 96,
                       work: Optional[str] = None) -> dict:
    """The multi-speaker evidence: a formant corpus of `N_SPEAKERS` voices
    (seed 0), `SpevDataset(multi_speaker=True)`, the advanced model with a
    speaker table trained for ``epochs``, then `per_speaker_eval` and
    `speaker_identity`.  Writes and
    returns the JSON of ``tools/multispeaker_demo.py``."""
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.data.synthetic import generate_formant_corpus
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    work = work or tempfile.mkdtemp(prefix="spev_ms_")
    root = os.path.join(work, "corpus")
    tg = generate_formant_corpus(root, n_utterances=n_utterances, seed=0,
                                 n_speakers=N_SPEAKERS)
    ds = SpevDataset(root, textgrid_dir=tg, cache_dir=os.path.join(work, "cache"),
                     g2p_backend="rules", stats_sample=60, multi_speaker=True, device=dev)
    if len(ds.speakers) != N_SPEAKERS:
        raise AssertionError(f"the corpus's speakers are {ds.speakers}")
    trainer, cfg, va_idx = _train(ds, dict(n_speakers=N_SPEAKERS), epochs, work, dev, hidden)
    ckpt = trainer.save("ms_demo")
    evaluation = per_speaker_eval(ckpt, ds, va_idx, device=dev)
    synth = Synthesizer(ckpt, hifigan_dir=None, model_cfg=cfg.model, g2p_backend="rules",
                        device=dev, **TRAIN_BUCKETS)
    synth.g2p = PhonemeReader()
    identity = speaker_identity(synth, wav_dir=wav_dir)
    out = {"epochs": epochs, "final_quality": _final_quality(trainer), **evaluation,
           **identity}
    _write_json(out_path, out)
    print(json.dumps({"per_speaker_val": out["per_speaker_val"],
                      "identity_f0_ordered": out["identity_f0_ordered"]}, indent=1))
    print("written:", out_path)
    return out
