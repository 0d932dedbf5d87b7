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
4. **Labels** (optional): ``multi_speaker`` takes the speaker from the file
   name's first ``_`` token and writes each npz's ``speaker_id`` (int32, the
   index in the sorted ``speakers``) after pass 2; ``emotion_vad`` takes the
   emotion from its last token (`data.emotion`, ``neutral`` when there is
   none), writes ``vad`` (float32 (3,)) into each npz and ``emotions`` and
   ``emotion_counts`` into ``metadata.json``.

Signals are zero-padded to multiples of 8192 samples before extraction and
the frames trimmed to ``1 + len(y)//hop``, as the JAX package does (its
jitted graphs compile once per bucket); the last frames of a padded signal
therefore equal the JAX package's, not those of an unpadded run.

The feature computations run on one device (the card unless the caller
passes ``device="cpu"``) with their products in fp32 (TF32 off inside, the
caller's settings restored), each stage inside a ``spev.*`` profiler range
(``spev.log_mel``, ``spev.f0`` with ``spev.pyin.*`` inside, ``spev.rms``,
``spev.centroid``).  The per-phoneme targets and the npz writing
stay numpy on the host, line for line.  Wavs are decoded by the C++ reader
(`spev_tpu_torch.utils.native`).

With ``build_workers > 1`` pass 2 runs in that many spawned processes, each
with its own extractor on the build's device (on the card every worker
launches K2; a CUDA card, unlike the JAX package's TPU, takes several
processes) and its own G2P.  Files go out in order, four to a task; the
parent keeps the error accounting, recounts the emotion labels and assigns
the speaker labels, so the cache equals the serial build's.
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

from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.data.emotion import EMOTION_VAD, emotion_from_basename
from spev_tpu_torch.diag.profiling import span
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.ops import features
from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
from spev_tpu_torch.text.g2p import G2P
from spev_tpu_torch.text.textgrid import intervals_to_durations, phone_intervals
from spev_tpu_torch.text.vocab import SPECIALS
from spev_tpu_torch.utils import native
from spev_tpu_torch.utils.platform import fp32_precision, resolve_device
from spev_tpu_torch.utils.wavio import resample_linear

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
        with span("spev.rms"):
            rms = features.rms_energy(y, hop_length=a.hop_length)
        with span("spev.centroid"):
            cent = features.spectral_centroid(y, sr=a.sample_rate, hop_length=a.hop_length)
        return rms, cent

    def mel(self, y: np.ndarray) -> np.ndarray:
        """The log-mel alone, (n_mels, T): ``full_features(y)[0]`` without
        the F0, RMS and centroid.  K2 runs no library product, so this
        leaves the process's TF32 settings alone: the vocoder trainer's
        crop batcher calls it from its prefetch thread while a step runs."""
        m = self._log_mel(self._signal(y)).cpu().numpy()
        return m[:, : 1 + len(y) // self.audio.hop_length]

    def full_features(self, y: np.ndarray):
        """(mel (n_mels, T), f0, voiced_prob, log_rms, centroid), numpy,
        frame counts trimmed to the true signal length."""
        a = self.audio
        with fp32_precision():
            sig = self._signal(y)
            with span("spev.log_mel"):
                mel = self._log_mel(sig)
            with span("spev.f0"):
                f0, _, vprob = self._f0(sig, a.hop_length)
            rms, cent = self._rms_centroid(sig)
            mel, f0, vprob, rms, cent = (t.cpu().numpy() for t in (mel, f0, vprob, rms, cent))
        t = 1 + len(y) // a.hop_length
        return mel[:, :t], f0[:t], vprob[:t], np.log(rms[:t] + 1e-6), cent[:t]

    def stats_features(self, y: np.ndarray):
        """(f0 at hop 512, rms, centroid), numpy, trimmed to the true length."""
        with fp32_precision():
            sig = self._signal(y)
            with span("spev.f0"):
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


# -- pass-2 workers (module level, so that a spawned process can import them) --

_BUILD_WORKER: dict = {}


def _build_worker_init(audio, stats, cache_dir, g2p_backend, textgrid_dir, min_samples,
                       emotion_vad, device, threads):
    """Once per worker process: a dataset shell holding the build's stats,
    an extractor on the build's device and a G2P.  ``threads``: the
    worker's intra-op CPU threads (the parent's split over the workers: N
    workers each spinning up every core's worth of threads make a CPU build
    many times slower than the serial one)."""
    torch.set_num_threads(threads)
    ds = SpevDataset.__new__(SpevDataset)
    ds.audio, ds.stats, ds.cache_dir = audio, stats, cache_dir
    ds.emotion_vad, ds._emotion_counts = emotion_vad, {}
    _BUILD_WORKER.update(ds=ds, fx=FeatureExtractor(audio, device), g2p=G2P(g2p_backend),
                         textgrid_dir=textgrid_dir, min_samples=min_samples)


def _build_worker_run(item):
    """(i, wav path) → (i, "ok" | "skip" | "error", payload), as a row of
    `SpevDataset._serial_extract`: a file that does not decode or transcribe
    is an "error" row with the exception's repr; the extractor's own errors
    are raised."""
    i, wav_path = item
    w = _BUILD_WORKER
    ds = w["ds"]
    try:
        y = ds._load(wav_path)
        job = (ds._transcript(wav_path, y, w["textgrid_dir"], w["g2p"])
               if len(y) >= w["min_samples"] else None)
    except Exception as e:
        return i, "error", repr(e)
    entry = None if job is None else ds._process_file(i, wav_path, y, *job, w["fx"])
    if entry is None:
        return i, "skip", None
    path, phs, n_frames = entry
    return i, "ok", (path, [str(p) for p in phs], int(n_frames))


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
        and is rebuilt.  ``force_rebuild`` deletes the cache first.  A cache
        built without emotion labels, read with ``emotion_vad``, is a
        `UserError`.  ``build_workers > 1`` runs pass 2 in that many
        spawned processes on ``device``."""
        self.audio = audio
        self.cache_dir = cache_dir
        self.multi_speaker = multi_speaker
        self.emotion_vad = emotion_vad
        meta_path = os.path.join(cache_dir, "metadata.json")
        if force_rebuild and os.path.exists(cache_dir):
            shutil.rmtree(cache_dir)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("files"):
                if emotion_vad and "emotions" not in meta:
                    raise UserError(f"cache at {cache_dir} was built without emotion-VAD labels; "
                                    "rebuild it (force_rebuild=True / --force_rebuild) to train "
                                    "the VAD pathway")
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
        self._build(data_dir, textgrid_dir, FeatureExtractor(audio, device), g2p_backend,
                    stats_sample, min_samples, seed, build_workers)

    def _build(self, data_dir, textgrid_dir, fx, g2p_backend, stats_sample, min_samples, seed,
               build_workers):
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
        speaker_set, entries = set(), []
        self._emotion_counts = {}
        self.files, self.lengths = [], []
        tot_frames = tot_phonemes = 0
        n_errors, first_error = 0, None
        if build_workers > 1:
            rows = self._parallel_extract(wavs, textgrid_dir, fx.device, g2p_backend,
                                          min_samples, build_workers)
        else:
            rows = self._serial_extract(wavs, textgrid_dir, fx, G2P(g2p_backend), min_samples)
        for i, status, payload in rows:
            if status == "error":
                # one bad file must not end a corpus build; all of them failing does
                n_errors += 1
                if first_error is None:
                    first_error = (wavs[i], payload)
                continue
            if status == "skip":
                continue
            path, phs, n_frames = payload
            if self.emotion_vad and build_workers > 1:
                # the workers' counts die with them
                emo = emotion_from_basename(os.path.splitext(os.path.basename(wavs[i]))[0])
                emo = emo or "neutral"
                self._emotion_counts[emo] = self._emotion_counts.get(emo, 0) + 1
            tot_frames += n_frames
            tot_phonemes += len(phs)
            vocab_set.update(phs)
            self.files.append(path)
            self.lengths.append((len(phs), int(n_frames)))
            if self.multi_speaker:
                spk = os.path.basename(wavs[i]).split("_")[0]
                speaker_set.add(spk)
                entries.append((path, spk))
        if n_errors:
            if not self.files:
                # a worker's error comes back as its repr
                cause = first_error[1] if isinstance(first_error[1], BaseException) else None
                raise RuntimeError(
                    f"all {n_errors} wav files under {data_dir} failed feature extraction; "
                    f"first error ({first_error[0]}): {first_error[1]!r}") from cause
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
        self.speakers = sorted(speaker_set)
        self.emotions = sorted(self._emotion_counts)
        spk_to_id = {s: k for k, s in enumerate(self.speakers)}
        for path, spk in entries:
            with np.load(path, allow_pickle=True) as u:
                data = {k: u[k] for k in u.files if k != "allow_pickle"}
            data["speaker_id"] = np.int32(spk_to_id[spk])
            np.savez(path, **data)
        # basenames keep the cache relocatable
        self.files = [os.path.basename(p) for p in self.files]
        meta = {"files": self.files, "stats": self.stats, "vocab": self.vocab,
                "speakers": self.speakers, "lengths": self.lengths}
        if self.emotion_vad:
            meta["emotions"] = self.emotions
            meta["emotion_counts"] = self._emotion_counts
        # atomic write: a crash mid-dump leaves no truncated metadata.json
        meta_path = os.path.join(self.cache_dir, "metadata.json")
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta, f)
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
                entry = None if job is None else self._process_file(i, wav_path, y, *job, fx)
                yield (i, "skip", None) if entry is None else (i, "ok", entry)
        finally:
            pool.shutdown(wait=False)

    def _parallel_extract(self, wavs, textgrid_dir, device, g2p_backend, min_samples,
                          build_workers):
        """Pass 2 over ``build_workers`` spawned processes, in file order,
        four files to a task.  Yields the rows of `_serial_extract` (an
        "error" row carries the exception's repr); an extractor error in a
        worker is raised here and ends the build."""
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ex = ProcessPoolExecutor(
            max_workers=build_workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_build_worker_init,
            initargs=(self.audio, self.stats, self.cache_dir, g2p_backend, textgrid_dir,
                      min_samples, self.emotion_vad, device,
                      max(1, torch.get_num_threads() // build_workers)))
        try:
            yield from ex.map(_build_worker_run, enumerate(wavs), chunksize=4)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def _load(self, path: str) -> np.ndarray:
        y, sr = native.read_wav(path)
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

    def _process_file(self, i, wav_path, y, phs, durs, fx):
        """Features and per-phoneme targets of one utterance, written to
        ``u_{i:05d}.npz`` (with ``vad`` under ``emotion_vad``): (path,
        phonemes, frames), or None when the durations cannot be rescaled to
        the mel length."""
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

        extra = {}
        if self.emotion_vad:
            basename = os.path.splitext(os.path.basename(wav_path))[0]
            emo = emotion_from_basename(basename) or "neutral"
            self._emotion_counts[emo] = self._emotion_counts.get(emo, 0) + 1
            extra["vad"] = np.asarray(EMOTION_VAD[emo], np.float32)
        path = os.path.join(self.cache_dir, f"u_{i:05d}.npz")
        np.savez(
            path,
            **extra,
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
