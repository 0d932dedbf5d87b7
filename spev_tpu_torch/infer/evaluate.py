"""Objective quality of an acoustic checkpoint over a corpus.  Counterpart of
``spev_tpu.infer.evaluate`` (CLI: ``python -m spev_tpu_torch.cli.evaluate``).

Per utterance: the teacher-forced mel's MCD against the ground truth
(frame-aligned, since cached durations sum to the mel length), the
per-phoneme duration error of the decoded predictions (the reference's
decode, ``round(clamp(exp(log_d) - 1, 0, 500))``), and the per-phoneme F0
RMSE in Hz: predicted and target pitch are z-scored voiced log-F0 means,
which the checkpoint's stats turn back into Hz (``exp(z·p_std + p_mean)``);
phonemes whose target is exactly 0.0 (no voiced frame) are left out.  With
a vocoder, each predicted mel is also vocoded and its waveform's log-mel,
re-extracted by `FeatureExtractor.mel` (K2 on the card), is scored against
the ground truth (``vocoded_mcd_db``): the serving condition.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spev_tpu_torch.config import AudioConfig, ModelConfig
from spev_tpu_torch.data.batching import collate
from spev_tpu_torch.diag.quality import duration_error_pct, mel_cepstral_distortion
from spev_tpu_torch.models.advanced import apply_advanced
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.text.vocab import Vocab, pick_bucket
from spev_tpu_torch.utils.params import read_checkpoint, unpack_checkpoint
from spev_tpu_torch.utils.platform import fp32_precision, resolve_device

_TRACKS = ("pitch", "energy", "breath", "rough", "bright")


@torch.inference_mode()
def evaluate_checkpoint(
    checkpoint: str,
    ds,
    indices: Optional[Sequence[int]] = None,
    model_cfg: Optional[ModelConfig] = None,
    batch_size: int = 8,
    phoneme_buckets: Sequence[int] = (64, 128, 256),
    frame_buckets: Sequence[int] = (256, 512, 1024, 2048),
    vocoder=None,
    device="cuda",
) -> dict:
    """Evaluate ``checkpoint`` (``.pt`` or ``.spev``) on utterances
    ``indices`` of ``ds`` (all by default; anything with ``__len__``,
    ``lengths`` and ``load_utterance``).  Returns ``{"per_utterance": {i:
    {mcd_db, dur_err_pct, frames[, f0_rmse_hz][, vocoded_mcd_db]}},
    "aggregate": {...}, "skipped": [...]}``; the aggregate carries means,
    medians and pass flags against the reference's targets.

    Each (phoneme, frame) bucket's utterances run in batches of
    ``batch_size`` (the last padded by repeating its first utterance), in
    fp32 (TF32 off), with the speaker and VAD conditioning the checkpoint
    was trained with.  ``vocoder`` is an `infer.vocoder.Vocoder`; the
    re-extraction runs on ``device``.  device: "cuda" (the default) raises
    without a GPU."""
    dev = resolve_device(device)
    ckpt = read_checkpoint(checkpoint)
    sd, vocab_list, stats = unpack_checkpoint(ckpt)
    vocab = Vocab(vocab_list)
    p_stats = None
    if stats and "p_mean" in stats and "p_std" in stats:
        p_stats = (float(stats["p_mean"]), float(stats["p_std"]))
    if model_cfg is None:
        stored = ckpt.get("model_config")
        model_cfg = ModelConfig.from_dict(stored) if stored else ModelConfig()
    model_cfg = dataclasses.replace(model_cfg, vocab_size=len(vocab))
    model = FastSpeech2(model_cfg)
    model.load_state_dict(sd)
    model.to(dev).eval()
    # speaker / emotion checkpoints are scored with their conditioning, as
    # they were trained: without it the learned shifts count as error
    multi_speaker = "advanced.speaker_embedding.weight" in sd
    use_vad = "advanced.vad_proj.weight" in sd

    if indices is None:
        indices = range(len(ds))
    lengths = getattr(ds, "lengths", None)
    groups: Dict[tuple, list] = {}
    skipped = []
    for i in indices:
        if lengths is not None and i < len(lengths) and lengths[i] is not None:
            n, t = int(lengths[i][0]), int(lengths[i][1])
        else:
            u = ds.load_utterance(i)
            n, t = len(u["phs"]), int(u["mel"].shape[0])
        try:
            key = (pick_bucket(n, phoneme_buckets), pick_bucket(t, frame_buckets))
        except ValueError:
            skipped.append(i)
            continue
        groups.setdefault(key, []).append(i)

    def tensor(v, dtype=torch.float32):
        return None if v is None else torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    fx = None
    per: Dict[int, dict] = {}
    with fp32_precision():
        for (P, M), idxs in sorted(groups.items()):
            for start in range(0, len(idxs), batch_size):
                g = idxs[start : start + batch_size]
                pad = g + [g[0]] * (batch_size - len(g))  # the bucket's batch shape
                utts = [ds.load_utterance(i) for i in pad]
                b = collate(utts, vocab, P, M, model_cfg.n_mels)
                kw = {f"target_{k}": tensor(b[k]) for k in _TRACKS}
                kw["target_nasal"] = tensor(b.get("nasal"))
                out = apply_advanced(
                    model, tensor(b["ids"], torch.long), tensor(b["lens"], torch.int32), M,
                    speaker_ids=tensor(b.get("speaker_ids"), torch.long) if multi_speaker
                    else None,
                    vad=tensor(b.get("vad")) if use_vad else None,
                    target_durations=tensor(b["durs"]), **kw)
                mel = out["mel_pred"].float().cpu().numpy()
                mel_len = out["mel_len"].cpu().numpy()
                pitch_pred = out["pitch_pred"].float().cpu().numpy()
                log_dur = out["log_duration_pred"].float().cpu().numpy()
                # the reference's duration decode
                pred_durs = np.round(np.clip(np.exp(log_dur) - 1.0, 0.0, 500.0))
                for row, i in enumerate(g):
                    gt = np.asarray(utts[row]["mel"], np.float32)
                    L = min(int(mel_len[row]), gt.shape[0])
                    tgt_durs = np.asarray(b["durs"][row], np.float32)
                    per[i] = {
                        "mcd_db": round(float(mel_cepstral_distortion(mel[row, :L], gt[:L])), 3),
                        "dur_err_pct": round(float(duration_error_pct(pred_durs[row],
                                                                      tgt_durs)), 3),
                        "frames": int(gt.shape[0]),
                    }
                    if vocoder is not None:
                        if fx is None:
                            from spev_tpu_torch.data.dataset import FeatureExtractor

                            fx = FeatureExtractor(AudioConfig(), device=dev)
                        wav = np.asarray(vocoder.infer(mel[row, :L]), np.float32)
                        mel_v = fx.mel(wav).T
                        Lv = min(L, mel_v.shape[0])
                        per[i]["vocoded_mcd_db"] = round(float(
                            mel_cepstral_distortion(mel_v[:Lv], gt[:Lv])), 3)
                    # F0 RMSE (Hz) through the stats, over voiced target phonemes
                    if p_stats is not None:
                        tgt_p = np.asarray(b["pitch"][row], np.float32)
                        voiced = (tgt_durs > 0) & (tgt_p != 0.0)
                        if voiced.any():
                            hz_t = np.exp(tgt_p[voiced] * p_stats[1] + p_stats[0])
                            hz_p = np.exp(np.clip(pitch_pred[row][voiced], -2.5, 2.5)
                                          * p_stats[1] + p_stats[0])
                            per[i]["f0_rmse_hz"] = round(float(np.sqrt(
                                np.mean((hz_p - hz_t) ** 2))), 3)
    return {"per_utterance": per, "aggregate": _aggregate(per, skipped), "skipped": skipped}


def _aggregate(per: Dict[int, dict], skipped: list) -> dict:
    """Means, medians and the pass flags against the reference's targets
    (MCD < 6 dB, duration error < 10 %, F0 RMSE < 20 Hz)."""

    def finite(key):
        return [v[key] for v in per.values() if key in v and np.isfinite(v[key])]

    def mean(xs):
        return round(statistics.mean(xs), 3) if xs else float("nan")

    def median(xs):
        return round(statistics.median(xs), 3) if xs else float("nan")

    mcds, errs = finite("mcd_db"), finite("dur_err_pct")
    f0s, vmcds = finite("f0_rmse_hz"), finite("vocoded_mcd_db")
    agg = {
        "n_utterances": len(per),
        "n_skipped": len(skipped),
        "mcd_db_mean": mean(mcds),
        "mcd_db_median": median(mcds),
        "dur_err_pct_mean": mean(errs),
        "dur_err_pct_median": median(errs),
    }
    if f0s:
        agg["f0_rmse_hz_mean"] = mean(f0s)
        agg["f0_rmse_hz_median"] = median(f0s)
    if vmcds:
        agg["vocoded_mcd_db_mean"] = mean(vmcds)
        agg["vocoded_mcd_db_median"] = median(vmcds)
    agg["meets_mcd_target_6db"] = bool(mcds and agg["mcd_db_mean"] < 6.0)
    agg["meets_dur_err_target_10pct"] = bool(errs and agg["dur_err_pct_mean"] < 10.0)
    if f0s:
        agg["meets_f0_target_20hz"] = bool(agg["f0_rmse_hz_mean"] < 20.0)
    if vmcds:
        agg["meets_vocoded_mcd_target_6db"] = bool(agg["vocoded_mcd_db_mean"] < 6.0)
    return agg
