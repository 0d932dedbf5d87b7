"""Feature extraction and the dataset cache — counterpart of
``spev_tpu.data.dataset``.

1. **Stats pass** over at most ``stats_sample`` random wavs: voiced log-F0
   (pyin at hop 512), log-RMS and log spectral centroid → global means and
   standard deviations (+1e-5 on the stds).
2. **Per-file pass**: load mono at the configured rate (files under
   ``min_samples`` are skipped); durations from a TextGrid's
   ``phones``/``phonemes`` tier or from the G2P with uniform durations;
   log-mel (kernel K2, fmax = sr/2), F0, voicing, RMS and centroid at hop
   256; the duration rescale to the mel length; per-phoneme z-scored and
   clipped targets (pitch, energy, breath, rough, bright, nasal).
3. **Cache**: one ``u_{i:05d}.npz`` per utterance and ``metadata.json``
   with ``files`` (basenames), ``stats`` (with ``frames_per_phoneme``),
   ``vocab``, ``speakers`` and ``lengths`` — the JAX package's layout, so
   either package trains from either cache.

Signals are zero-padded to multiples of 8192 samples before extraction and
the frames trimmed to ``1 + len(y)//hop``, as the JAX package does (its
jitted graphs compile once per bucket); the last frames of a padded signal
therefore equal the JAX package's, not those of an unpadded run.

The feature computations run on one device (the card unless the caller
passes ``device="cpu"``) with their products in fp32 (TF32 off inside, the
caller's settings restored), each stage inside a ``spev.*`` profiler range
(``spev.log_mel``, ``spev.f0`` with ``spev.pyin.*`` inside, ``spev.rms``,
``spev.centroid``).  The per-phoneme targets and the npz writing
stay numpy on the host, line for line.  Not ported yet (``ROADMAP.md``):
the parallel build (``build_workers > 1``), speaker and emotion-VAD labels,
and the JAX package's C++ wav decoder.
"""

from __future__ import annotations

import glob
import json
import os
import random
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.ops import features
from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
from spev_tpu_torch.text.g2p import G2P
from spev_tpu_torch.text.textgrid import intervals_to_durations, phone_intervals
from spev_tpu_torch.text.vocab import SPECIALS
from spev_tpu_torch.utils.platform import fp32_precision, resolve_device
from spev_tpu_torch.utils.wavio import read_wav, resample_linear

_SIG_BUCKET = 8192


class FeatureExtractor:
    """Per-signal DSP on one device, signals bucketed to 8192 samples."""

    def __init__(self, audio: AudioConfig = AudioConfig(), device="cuda"):
        """device: "cuda" (the default) raises when no GPU is present."""
        self.audio = audio
        self.device = resolve_device(device)

    def _signal(self, y: np.ndarray) -> torch.Tensor:
        """The signal zero-padded to a multiple of 8192 samples, on the device."""
        n = -(-len(y) // _SIG_BUCKET) * _SIG_BUCKET
        return torch.from_numpy(np.pad(y.astype(np.float32), (0, n - len(y)))).to(self.device)

    def _log_mel(self, y: torch.Tensor) -> torch.Tensor:
        a = self.audio
        return fused_log_mel(y, sr=a.sample_rate, n_fft=a.n_fft, hop_length=a.hop_length,
                             n_mels=a.n_mels, fmin=0.0, fmax=a.sample_rate / 2,
                             floor=a.mel_floor, clip_min=a.mel_clip_min,
                             clip_max=a.mel_clip_max)

    def _f0(self, y: torch.Tensor, hop_length: int):
        a = self.audio
        track = features.pyin_f0 if a.f0_method == "pyin" else features.yin_f0
        return track(y, sr=a.sample_rate, fmin=a.f0_min, fmax=a.f0_max, hop_length=hop_length)

    def _rms_centroid(self, y: torch.Tensor):
        a = self.audio
        with record_function("spev.rms"):
            rms = features.rms_energy(y, hop_length=a.hop_length)
        with record_function("spev.centroid"):
            cent = features.spectral_centroid(y, sr=a.sample_rate, hop_length=a.hop_length)
        return rms, cent

    def mel(self, y: np.ndarray) -> np.ndarray:
        """The log-mel alone, (n_mels, T): ``full_features(y)[0]`` without
        the F0, RMS and centroid."""
        with fp32_precision():
            m = self._log_mel(self._signal(y)).cpu().numpy()
        return m[:, : 1 + len(y) // self.audio.hop_length]

    def full_features(self, y: np.ndarray):
        """(mel (n_mels, T), f0, voiced_prob, log_rms, centroid), numpy,
        frame counts trimmed to the true signal length."""
        a = self.audio
        with fp32_precision():
            sig = self._signal(y)
            with record_function("spev.log_mel"):
                mel = self._log_mel(sig)
            with record_function("spev.f0"):
                f0, _, vprob = self._f0(sig, a.hop_length)
            rms, cent = self._rms_centroid(sig)
            mel, f0, vprob, rms, cent = (t.cpu().numpy() for t in (mel, f0, vprob, rms, cent))
        t = 1 + len(y) // a.hop_length
        return mel[:, :t], f0[:t], vprob[:t], np.log(rms[:t] + 1e-6), cent[:t]

    def stats_features(self, y: np.ndarray):
        """(f0 at hop 512, rms, centroid), numpy, trimmed to the true length."""
        with fp32_precision():
            sig = self._signal(y)
            with record_function("spev.f0"):
                f0, _, _ = self._f0(sig, 512)  # pyin's default hop (frame_length // 4)
            rms, cent = self._rms_centroid(sig)
            f0, rms, cent = (t.cpu().numpy() for t in (f0, rms, cent))
        t256 = 1 + len(y) // self.audio.hop_length
        t512 = 1 + len(y) // 512
        return f0[:t512], rms[:t256], cent[:t256]


def _rescale_durations(durs: List[int], phs: List[str], target: int):
    """Scale each duration (at least 1) to sum to ``target``: the remainder
    goes to the last phoneme, an excess is trimmed from the tail, dropping
    emptied phonemes.  Returns (phs, durs), or None when the total is not
    positive or the target cannot be met."""
    total = sum(durs)
    if total <= 0:
        return None
    scale = target / total
    new = [max(1, int(d * scale)) for d in durs]
    phs = list(phs)
    cur = sum(new)
    if cur < target:
        new[-1] += target - cur
    elif cur > target:
        diff = cur - target
        while diff > 0 and new:
            if new[-1] > diff:
                new[-1] -= diff
                diff = 0
            else:
                diff -= new[-1]
                new.pop()
                phs.pop()
                if not new:
                    break
    if not new or sum(new) != target:
        return None
    return phs, new


class SpevDataset:
    """Two-pass preprocessed dataset with a per-utterance npz cache."""

    def __init__(self, data_dir: Optional[str], textgrid_dir: Optional[str] = None,
                 cache_dir: str = "cache_spev", audio: AudioConfig = AudioConfig(),
                 g2p_backend: str = "auto", force_rebuild: bool = False, stats_sample: int = 500,
                 min_samples: int = 4000, seed: int = 1234, multi_speaker: bool = False,
                 emotion_vad: bool = False, build_workers: int = 1, device="cuda"):
        """Reads the cache in ``cache_dir`` when it holds one (no device is
        needed then), else builds it from the wavs under ``data_dir`` on
        ``device`` ("cuda" by default; raises without a GPU).  A
        ``metadata.json`` with no files is the footprint of a crashed build
        and is rebuilt.  ``force_rebuild`` deletes the cache first."""
        for flag, on in (("build_workers > 1", build_workers > 1),
                         ("multi_speaker=True", multi_speaker),
                         ("emotion_vad=True", emotion_vad)):
            if on:
                raise UserError(f"SpevDataset({flag}) is not ported to PyTorch yet "
                                "(ROADMAP.md, section 1)")
        self.audio = audio
        self.cache_dir = cache_dir
        meta_path = os.path.join(cache_dir, "metadata.json")
        if force_rebuild and os.path.exists(cache_dir):
            shutil.rmtree(cache_dir)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("files"):
                self.files = meta["files"]
                self.stats = meta["stats"]
                self.vocab = meta["vocab"]
                self.speakers = meta.get("speakers", [])
                self.emotions = meta.get("emotions", [])
                # None for caches built before the field existed: the batcher loads
                self.lengths = meta.get("lengths")
                return
        if data_dir is None:
            raise UserError(f"no usable feature cache at {cache_dir} (metadata.json with a "
                            "non-empty file list) and no data_dir to build one from")
        self._build(data_dir, textgrid_dir, FeatureExtractor(audio, device), G2P(g2p_backend),
                    stats_sample, min_samples, seed)

    def _build(self, data_dir, textgrid_dir, fx, g2p, stats_sample, min_samples, seed):
        wavs = sorted(glob.glob(os.path.join(os.path.abspath(data_dir), "**", "*.wav"),
                                recursive=True))
        if not wavs:
            raise FileNotFoundError(f"no wavs under {data_dir}")
        os.makedirs(self.cache_dir, exist_ok=True)

        # ---- pass 1: stats ----------------------------------------------
        sample = random.Random(seed).sample(wavs, min(len(wavs), stats_sample))
        all_p, all_e, all_c = [], [], []
        stats_errors, stats_first = 0, None
        for w in sample:
            try:
                y = self._load(w)
            except Exception as e:
                # a file that does not decode must not end the stats pass, but
                # the skip is counted and reported (pass 2 fails loudly when
                # every file fails); the extractor's own errors end the build
                stats_errors += 1
                if stats_first is None:
                    stats_first = (w, e)
                continue
            if len(y) < min_samples:
                continue
            f0, rms, cent = fx.stats_features(y)
            logf0 = np.log(np.nan_to_num(f0, nan=1e-8) + 1e-8)
            all_p.extend(logf0[logf0 > -5].tolist())
            all_e.extend(np.log(rms + 1e-6).tolist())
            all_c.extend(np.log(cent + 1e-8).tolist())
        if stats_errors:
            print(f"Warning: stats pass skipped {stats_errors}/{len(sample)} files on errors; "
                  f"first ({os.path.basename(stats_first[0])}): {stats_first[1]!r}")
        self.stats = {
            "p_mean": float(np.mean(all_p)) if all_p else 0.0,
            "p_std": float(np.std(all_p)) + 1e-5 if all_p else 1.0,
            "e_mean": float(np.mean(all_e)) if all_e else 0.0,
            "e_std": float(np.std(all_e)) + 1e-5 if all_e else 1.0,
            "c_mean": float(np.mean(all_c)) if all_c else 0.0,
            "c_std": float(np.std(all_c)) + 1e-5 if all_c else 1.0,
        }

        # ---- pass 2: per-file features ----------------------------------
        vocab_set = set(SPECIALS)
        self.files, self.lengths = [], []
        tot_frames = tot_phonemes = 0
        n_errors, first_error = 0, None
        for i, status, payload in self._serial_extract(wavs, textgrid_dir, fx, g2p, min_samples):
            if status == "error":
                # one bad file must not end a corpus build; all of them failing does
                n_errors += 1
                if first_error is None:
                    first_error = (wavs[i], payload)
                continue
            if status == "skip":
                continue
            path, phs, n_frames = payload
            tot_frames += n_frames
            tot_phonemes += len(phs)
            vocab_set.update(phs)
            self.files.append(path)
            self.lengths.append((len(phs), int(n_frames)))
        if n_errors:
            if not self.files:
                raise RuntimeError(
                    f"all {n_errors} wav files under {data_dir} failed feature extraction; "
                    f"first error ({first_error[0]}): {first_error[1]!r}") from first_error[1]
            print(f"Warning: skipped {n_errors}/{len(wavs)} files on errors; first "
                  f"({os.path.basename(first_error[0])}): {first_error[1]!r}")
        if not self.files:
            # zero usable utterances with zero errors fails here: metadata
            # with no files would be rebuilt on every construction
            raise UserError(f"no usable utterances under {data_dir}: all {len(wavs)} wavs "
                            f"were skipped (shorter than {min_samples} samples or empty)")

        # the corpus' mean frames per phoneme rides in stats → checkpoint →
        # Synthesizer (its frame-bucket estimate)
        self.stats["frames_per_phoneme"] = tot_frames / tot_phonemes if tot_phonemes else 10.0
        self.vocab = sorted(vocab_set)
        self.speakers, self.emotions = [], []
        # basenames keep the cache relocatable
        self.files = [os.path.basename(p) for p in self.files]
        # atomic write: a crash mid-dump leaves no truncated metadata.json
        meta_path = os.path.join(self.cache_dir, "metadata.json")
        with open(meta_path + ".tmp", "w") as f:
            json.dump({"files": self.files, "stats": self.stats, "vocab": self.vocab,
                       "speakers": self.speakers, "lengths": self.lengths}, f)
        os.replace(meta_path + ".tmp", meta_path)

    def _serial_extract(self, wavs, textgrid_dir, fx, g2p, min_samples):
        """Pass 2, one file at a time, with a one-ahead decode: file i+1 is
        read and resampled on a worker thread while the device extracts
        file i.  Yields (i, "ok" | "skip" | "error", payload).  A file that
        does not decode or transcribe is an "error"; the extractor's own
        errors (a kernel that does not build or launch) end the build."""
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="spev-build")
        try:
            pre = pool.submit(self._load, wavs[0])
            for i, wav_path in enumerate(wavs):
                try:
                    try:
                        y = pre.result()
                    finally:
                        if i + 1 < len(wavs):
                            pre = pool.submit(self._load, wavs[i + 1])
                    job = (self._transcript(wav_path, y, textgrid_dir, g2p)
                           if len(y) >= min_samples else None)
                except Exception as e:
                    yield i, "error", e
                    continue
                entry = None if job is None else self._process_file(i, y, *job, fx)
                yield (i, "skip", None) if entry is None else (i, "ok", entry)
        finally:
            pool.shutdown(wait=False)

    def _load(self, path: str) -> np.ndarray:
        y, sr = read_wav(path)
        if sr != self.audio.sample_rate:
            y = resample_linear(y, sr, self.audio.sample_rate)
        return y

    def _transcript(self, wav_path, y, textgrid_dir, g2p):
        """(phonemes, durations in frames) from a TextGrid's phones tier, else
        from the ``.txt`` transcript through the G2P; None when neither."""
        basename = os.path.splitext(os.path.basename(wav_path))[0]

        phs, durs = [], []
        if textgrid_dir:
            cands = glob.glob(os.path.join(textgrid_dir, "**", f"{basename}.TextGrid"),
                              recursive=True)
            if cands:
                try:
                    ivs = phone_intervals(cands[0])
                    if ivs:
                        phs, durs = intervals_to_durations(ivs, self.audio.sample_rate,
                                                           self.audio.hop_length)
                except Exception:
                    pass  # an unreadable TextGrid falls back to the transcript
        if not phs:
            txt_path = os.path.splitext(wav_path)[0] + ".txt"
            if os.path.exists(txt_path):
                with open(txt_path) as f:
                    text = f.read().strip()
                phs = g2p.phonemes(text)
                durs = [int((len(y) / self.audio.hop_length) / len(phs))] * len(phs)
        return (phs, durs) if phs else None

    def _process_file(self, i, y, phs, durs, fx):
        """Features and per-phoneme targets of one utterance, written to
        ``u_{i:05d}.npz``: (path, phonemes, frames), or None when the
        durations cannot be rescaled to the mel length."""
        mel, f0, vprob, log_rms, cent = fx.full_features(y)
        min_l = min(mel.shape[1], len(f0), len(log_rms))
        mel = mel[:, :min_l]

        res = _rescale_durations(durs, phs, min_l)
        if res is None:
            return None
        phs, durs = res

        logf0 = np.log(np.nan_to_num(f0, nan=1e-8) + 1e-8)
        logcent = np.log(cent + 1e-8)
        # nasality proxy: the per-frame spectral tilt mid-band − high-band of
        # the log-mel, normalised per utterance to [0, 1]
        nm = mel.shape[0]
        tilt = mel[nm // 4 : nm // 2].mean(axis=0) - mel[(11 * nm) // 16 :].mean(axis=0)
        s = self.stats
        p, e, br, ro, bri, na = [], [], [], [], [], []
        tilt_mu, tilt_sd = float(tilt.mean()), float(tilt.std()) + 1e-5
        cur = 0
        for d in durs:
            sl = slice(cur, cur + d)
            seg = logf0[sl]
            voiced = seg[seg > -5]
            p_val = (voiced.mean() - s["p_mean"]) / s["p_std"] if voiced.size else 0.0
            p.append(np.clip(p_val, -2.5, 2.5))
            e.append(np.clip((log_rms[sl].mean() - s["e_mean"]) / s["e_std"], -2.5, 2.5))
            br.append(np.clip(1.0 - vprob[sl].mean(), 0.0, 0.8))
            ro.append(np.clip(voiced.std() if voiced.size else 0.0, 0.0, 1.5))
            bri.append(np.clip((logcent[sl].mean() - s["c_mean"]) / s["c_std"], -2.5, 2.5))
            na.append(np.clip(0.5 + 0.25 * (tilt[sl].mean() - tilt_mu) / tilt_sd, 0.0, 1.0))
            cur += d

        path = os.path.join(self.cache_dir, f"u_{i:05d}.npz")
        np.savez(
            path,
            phs=np.asarray(phs, dtype=object),
            durs=np.asarray(durs, np.int32),
            mel=mel.T.astype(np.float32),  # (T, n_mels)
            pitch=np.asarray(p, np.float32),
            energy=np.asarray(e, np.float32),
            breath=np.asarray(br, np.float32),
            rough=np.asarray(ro, np.float32),
            bright=np.asarray(bri, np.float32),
            nasal=np.asarray(na, np.float32),
        )
        return path, phs, int(np.sum(durs))

    def __len__(self):
        return len(self.files)

    def _resolve(self, entry: str) -> str:
        # metadata stores basenames; older caches stored full paths
        if os.path.exists(entry):
            return entry
        return os.path.join(self.cache_dir, os.path.basename(entry))

    def load_utterance(self, idx: int) -> dict:
        with np.load(self._resolve(self.files[idx]), allow_pickle=True) as u:
            return {k: u[k] for k in u.files if k != "allow_pickle"}
