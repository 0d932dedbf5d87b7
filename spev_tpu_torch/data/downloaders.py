"""Dataset downloaders and preppers → ``{id}.wav`` + ``{id}.txt`` pairs
(counterpart of ``spev_tpu.data.downloaders``).

- **LJSpeech** (one speaker): the tar.bz2 archive, extracted; each wav
  resampled to 22050 Hz mono, silence trimmed (top_db 25), peak-normalised,
  written with the normalised-text column of ``metadata.csv``.
- **LibriTTS-R dev_clean** (many speakers): resampled and trimmed, not
  normalised; the ``.normalized.txt`` (else ``.txt``) transcript copied.
- **ESD**: speaker folders of emotion folders and a tab-separated
  ``{speaker}.txt``; each pair is named ``{utt_id}_{emotion}``, so the
  emotion survives in the file name (`data.emotion.emotion_from_basename`).
- **Jenny**: ``metadata.csv`` of ``id|transcript`` rows; the audio is found
  by id anywhere under the tree, wav or flac (flac needs ``soundfile``; a
  flac file is skipped without it).

Only `download_and_extract` touches the network, and only when the archive
is not in ``out_dir`` yet; everything else works on local trees.
"""

from __future__ import annotations

import glob
import os
import shutil
import tarfile
from typing import Optional

import numpy as np

from spev_tpu_torch.utils.wavio import read_wav, resample_linear, write_wav

LJSPEECH_URL = "https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2"
LIBRITTS_R_URL = "https://www.openslr.org/resources/141/dev_clean.tar.gz"


def download_and_extract(url: str, out_dir: str, filename: Optional[str] = None) -> str:
    """Extract the tar archive ``out_dir/<filename>`` into ``out_dir``,
    downloading it from ``url`` first when it is not there.  Members that
    would land outside ``out_dir`` (absolute paths, ``..``, links out) are
    refused (tarfile's "data" filter)."""
    os.makedirs(out_dir, exist_ok=True)
    filename = filename or url.split("/")[-1]
    archive = os.path.join(out_dir, filename)
    if not os.path.exists(archive):
        import urllib.request

        print(f"downloading {url} ...")
        urllib.request.urlretrieve(url, archive + ".part")
        os.replace(archive + ".part", archive)
    print(f"extracting {archive} ...")
    with tarfile.open(archive) as tf:
        tf.extractall(out_dir, filter="data")
    return out_dir


def _trim_silence(y: np.ndarray, top_db: float = 25.0, frame: int = 2048, hop: int = 512):
    """Cut the leading and trailing frames whose RMS lies more than
    ``top_db`` below the peak frame's (librosa.effects.trim's rule)."""
    if len(y) < frame:
        return y
    n = 1 + (len(y) - frame) // hop
    rms = np.asarray([np.sqrt(np.mean(y[i * hop:i * hop + frame] ** 2)) for i in range(n)])
    ref = rms.max()
    if ref <= 0:
        return y
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.nonzero(db > -top_db)[0]
    if keep.size == 0:
        return y
    start = keep[0] * hop
    end = min(len(y), keep[-1] * hop + frame)
    return y[start:end]


def _normalize(y: np.ndarray) -> np.ndarray:
    peak = np.abs(y).max()
    return y / peak if peak > 0 else y


def process_single_speaker(lj_root: str, out_dir: str, sr: int = 22050, limit=None) -> int:
    """LJSpeech → pairs (resampled, trimmed, normalised; the normalised-text
    column).  Returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    with open(os.path.join(lj_root, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            wav_id, norm_text = parts[0], parts[2]
            src = os.path.join(lj_root, "wavs", wav_id + ".wav")
            if not os.path.exists(src):
                continue
            y, in_sr = read_wav(src)
            y = _normalize(_trim_silence(resample_linear(y, in_sr, sr), top_db=25.0))
            write_wav(os.path.join(out_dir, wav_id + ".wav"), y, sr)
            with open(os.path.join(out_dir, wav_id + ".txt"), "w", encoding="utf-8") as tf:
                tf.write(norm_text)
            count += 1
            if limit and count >= limit:
                break
    return count


def process_multi_speaker(libritts_root: str, out_dir: str, sr: int = 22050, limit=None) -> int:
    """LibriTTS-R → pairs (resampled and trimmed, not normalised).  Returns
    the number written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for wav in sorted(glob.glob(os.path.join(libritts_root, "**", "*.wav"), recursive=True)):
        txt = wav.replace(".wav", ".normalized.txt")
        if not os.path.exists(txt):
            txt = wav.replace(".wav", ".txt")
            if not os.path.exists(txt):
                continue
        base = os.path.splitext(os.path.basename(wav))[0]
        y, in_sr = read_wav(wav)
        y = _trim_silence(resample_linear(y, in_sr, sr), top_db=25.0)
        write_wav(os.path.join(out_dir, base + ".wav"), y, sr)
        shutil.copyfile(txt, os.path.join(out_dir, base + ".txt"))
        count += 1
        if limit and count >= limit:
            break
    return count


def prep_esd(in_dir: str, out_dir: str, limit=None) -> int:
    """ESD → pairs ``{utt_id}_{emotion}`` (the wavs copied as they are).
    An utterance without a transcript line is left out.  Returns the number
    written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for speaker in sorted(os.listdir(in_dir)):
        spk_dir = os.path.join(in_dir, speaker)
        if not os.path.isdir(spk_dir):
            continue
        transcripts = {}
        tfile = os.path.join(spk_dir, f"{speaker}.txt")
        if os.path.exists(tfile):
            with open(tfile, encoding="utf-8", errors="ignore") as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        transcripts[parts[0]] = parts[1]
        for wav in sorted(glob.glob(os.path.join(spk_dir, "**", "*.wav"), recursive=True)):
            utt_id = os.path.splitext(os.path.basename(wav))[0]
            if utt_id not in transcripts:
                continue
            base = f"{utt_id}_{os.path.basename(os.path.dirname(wav)).lower()}"
            shutil.copyfile(wav, os.path.join(out_dir, base + ".wav"))
            with open(os.path.join(out_dir, base + ".txt"), "w", encoding="utf-8") as f:
                f.write(transcripts[utt_id])
            count += 1
            if limit and count >= limit:
                return count
    return count


def prep_jenny(in_dir: str, out_dir: str, limit=None) -> int:
    """Jenny → pairs: each ``metadata.csv`` row's audio (the first wav, else
    flac, named by its id under ``in_dir``), a wav copied as it is, a flac
    decoded with ``soundfile`` and written as 16-bit PCM (skipped when
    ``soundfile`` is not installed).  Returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            utt_id, text = parts[0].strip(), parts[1].strip()
            found = None
            for ext in (".wav", ".flac"):
                cands = glob.glob(os.path.join(in_dir, "**", utt_id + ext), recursive=True)
                if cands:
                    found = cands[0]
                    break
            if not found:
                continue
            if found.endswith(".flac"):
                try:
                    import soundfile as sf
                except ImportError:
                    continue
                y, sr = sf.read(found)
                write_wav(os.path.join(out_dir, utt_id + ".wav"), y, sr)
            else:
                shutil.copyfile(found, os.path.join(out_dir, utt_id + ".wav"))
            with open(os.path.join(out_dir, utt_id + ".txt"), "w", encoding="utf-8") as tf:
                tf.write(text)
            count += 1
            if limit and count >= limit:
                break
    return count
