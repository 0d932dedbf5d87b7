"""Measured evidence for the GAN vocoder: the counterparts of the JAX
package's ``tools/gan_copysynth.py``, ``tools/prep_gta_work.py`` and
``tools/gta_demo.py``, with their names, arguments, work-dir layout and JSON
keys.

- `copy_synthesis`: a trained generator vocodes each wav's own mel (the
  standard vocoder metric: no acoustic model in the loop), scored by the
  round trip's MCD beside the Griffin-Lim column.
- The GTA demo, in a work dir: `train_gta_acoustic` (the formant setup of
  `diag.convergence`, trained) or `prepare_gta_work` (an existing
  checkpoint and corpus) write ``acoustic.spev``, ``corpus/``,
  ``corpus_train/`` (the train split only) and ``meta.json``;
  `run_finetune` trains one arm from a baseline generator through
  ``cli.vocoder`` (``control`` on ground-truth mels, ``gta`` on the
  acoustic model's teacher-forced mels); `evaluate_arms` scores each arm on
  the held-out utterances, vocoding the predicted mel (the serving
  condition) and the ground-truth mel (copy synthesis).

Every mel of a wav is K2 on the card (``FeatureExtractor``), the predicted
mels are K1 (`infer.gta.compute_gta_mels`), and the Griffin-Lim column is
K3.  Every entry point that touches the device takes ``device`` ("cuda" by
default; raises without a GPU).
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np

ARMS = (("gta", True), ("control", False))


def _vocoder(path: str, config: str, device):
    """A ``gen_*.spev`` of ``cli.vocoder``'s ``config`` as a `Vocoder`."""
    from spev_tpu_torch.cli.vocoder import generator_config
    from spev_tpu_torch.infer.vocoder import Vocoder
    from spev_tpu_torch.train.vocoder_trainer import load_generator

    return Vocoder(generator=load_generator(path, generator_config(config)), device=device)


def _corpus_wavs(root: str) -> List[str]:
    return sorted(glob.glob(os.path.join(root, "**", "*.wav"), recursive=True))


def utterance_wavs(corpus: str, files: Sequence[str], indices: Sequence[int]) -> List[str]:
    """For each ``i`` of ``indices``, the wav under ``corpus`` that the cache
    file ``files[i]`` was built from: ``u_{w:05d}.npz`` names the ``w``-th
    wav of the corpus's sorted recursive glob."""
    wavs = _corpus_wavs(corpus)
    return [wavs[int(re.match(r"u_(\d+)\.npz$", os.path.basename(files[i])).group(1))]
            for i in indices]


# -- copy synthesis -------------------------------------------------------------


def copy_synthesis(gen_checkpoint: str, wavs: Sequence[str], config: str = "v3",
                   out_dir: Optional[str] = None, skip_gl: bool = False,
                   device="cuda") -> dict:
    """``tools/gan_copysynth.py``: each wav's log-mel (``full_features``) is
    vocoded by the generator of ``gen_checkpoint`` (a ``gen_*.spev`` of
    ``config``) and, unless ``skip_gl``, by Griffin-Lim; each round trip's
    mel against the original's, truncated to the shortest, gives the MCD.
    With ``out_dir`` the GAN audio is written as
    ``<name>_copysynth_gan.wav`` (clipped, 22050 Hz).  Prints the tool's
    lines and returns ``per_utterance`` ({name: {mcd_gan_db, mcd_gl_db}},
    ``mcd_gl_db`` None with ``skip_gl``) and the GAN column's
    ``mean_mcd_gan_db``, ``min_mcd_gan_db`` and ``max_mcd_gan_db``."""
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.data.dataset import FeatureExtractor
    from spev_tpu_torch.diag.quality import mel_cepstral_distortion
    from spev_tpu_torch.infer.vocoder import Vocoder
    from spev_tpu_torch.utils.wavio import read_wav, write_wav

    voc = _vocoder(gen_checkpoint, config, device)
    gl = None if skip_gl else Vocoder(None, device=device)
    fx = FeatureExtractor(AudioConfig(), device=device)
    rows, mcds = {}, []
    for path in wavs:
        y, _sr = read_wav(path)
        mel = fx.full_features(y)[0].T
        wav_gan = voc.infer(mel)
        mel_gan = fx.full_features(wav_gan[: len(y)])[0].T
        T = min(len(mel), len(mel_gan))
        mcd_gl, line = None, ""
        if gl is not None:
            wav_gl = gl.infer(mel)
            mel_gl = fx.full_features(wav_gl[: len(y)])[0].T
            T = min(T, len(mel_gl))
            mcd_gl = float(mel_cepstral_distortion(mel_gl[:T], mel[:T]))
            line = f" vs GL {mcd_gl:.2f} dB"
        mcd_gan = float(mel_cepstral_distortion(mel_gan[:T], mel[:T]))
        mcds.append(mcd_gan)
        name = os.path.splitext(os.path.basename(path))[0]
        rows[name] = {"mcd_gan_db": mcd_gan, "mcd_gl_db": mcd_gl}
        print(f"{name}: copy-synthesis MCD GAN {mcd_gan:.2f} dB{line}", flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            write_wav(os.path.join(out_dir, f"{name}_copysynth_gan.wav"),
                      np.clip(wav_gan, -1, 1), 22050)
    out = {"per_utterance": rows, "mean_mcd_gan_db": float(np.mean(mcds)),
           "min_mcd_gan_db": min(mcds), "max_mcd_gan_db": max(mcds)}
    print(f"mean over {len(mcds)}: {out['mean_mcd_gan_db']:.3f} dB "
          f"(min {out['min_mcd_gan_db']:.2f} max {out['max_mcd_gan_db']:.2f})", flush=True)
    return out


# -- the GTA demo's work dir -------------------------------------------------------


def _write_layout(work: str, acoustic: str, corpus: str, files: List[str],
                  va_idx: List[int], meta: dict) -> dict:
    """``acoustic.spev``, ``corpus/`` (a copy of ``corpus``),
    ``corpus_train/`` (each wav that no held-out cache file names, with its
    transcript and TextGrid) and ``meta.json`` (``meta`` with ``va_idx`` and
    ``val_wavs``).  Returns the meta written."""
    os.makedirs(work, exist_ok=True)
    shutil.copy(acoustic, os.path.join(work, "acoustic.spev"))
    full = os.path.join(work, "corpus")
    if os.path.isdir(full):
        shutil.rmtree(full)
    shutil.copytree(corpus, full)
    held = set(utterance_wavs(full, files, va_idx))
    tr_dir = os.path.join(work, "corpus_train")
    tg_dir = os.path.join(tr_dir, "textgrids")
    if os.path.isdir(tr_dir):
        shutil.rmtree(tr_dir)
    os.makedirs(tg_dir)
    for path in _corpus_wavs(full):
        if path in held:
            continue
        base = os.path.splitext(os.path.basename(path))[0]
        shutil.copy(path, tr_dir)
        txt = os.path.join(full, base + ".txt")
        if os.path.exists(txt):
            shutil.copy(txt, tr_dir)
        tg = os.path.join(full, "textgrids", base + ".TextGrid")
        if os.path.exists(tg):
            shutil.copy(tg, tg_dir)
    meta = {**meta, "va_idx": [int(i) for i in va_idx],
            "val_wavs": [os.path.basename(w) for w in sorted(held)]}
    order = ("epochs", "acoustic", "va_idx", "val_wavs", "final_quality")
    meta = {k: meta[k] for k in sorted(meta, key=order.index)}
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def prepare_gta_work(work: str, acoustic: str, corpus: str, cache: str,
                     val_fraction: float = 0.05, seed: int = 0, device="cuda") -> dict:
    """``tools/prep_gta_work.py``: a GTA work dir from an existing acoustic
    checkpoint and its corpus and cache (the held-out indices under the
    CLI's split, ``val_fraction`` and ``seed``).  The cache is read without
    a device; only a missing one is built, on ``device``.  Returns
    ``meta.json``'s contents."""
    from spev_tpu_torch.data.batching import train_val_split
    from spev_tpu_torch.data.dataset import SpevDataset

    ds = SpevDataset(corpus, textgrid_dir=os.path.join(corpus, "textgrids"), cache_dir=cache,
                     g2p_backend="rules", device=device)
    _tr, va_idx = train_val_split(len(ds), val_fraction, seed=seed)
    meta = _write_layout(work, acoustic, corpus, ds.files, va_idx,
                         {"acoustic": os.path.abspath(acoustic), "final_quality": {}})
    print(f"seeded {work}: {len(_corpus_wavs(corpus))} wavs, {len(va_idx)} held out")
    return meta


def train_gta_acoustic(work: str, epochs: int, device="cuda") -> dict:
    """``tools/gta_demo.py``'s train phase: the formant setup
    (`convergence.build_quality_setup`, built under ``work/setup``) trained
    ``epochs`` with the dashboard read every epoch, then the work dir's
    layout with its split.  Returns ``meta.json``'s contents."""
    from spev_tpu_torch.diag import convergence as cv

    s = cv.build_quality_setup(epochs, device=device, work=os.path.join(work, "setup"))
    cv.run_dashboard(s, epochs, on_epoch=cv.progress(epochs))
    ckpt = s.trainer.save("gta_demo")
    quality = {k: round(float(v), 3) for k, v in s.trainer.last_quality.items()}
    meta = _write_layout(work, ckpt, s.corpus_root, s.ds.files, s.va_idx,
                         {"epochs": epochs, "final_quality": quality})
    print("phase train done:", work, flush=True)
    return meta


# -- the fine-tune arms --------------------------------------------------------------


def arm_name(gta: bool, resume_state: Optional[str] = None) -> str:
    """The arm's run name: ``gta_ft`` or ``control_ft``, ``_rs`` added when
    it resumes a full GAN state."""
    return ("gta_ft" if gta else "control_ft") + ("_rs" if resume_state else "")


def finetune_argv(work: str, baseline_gen: str, steps: int, gta: bool, config: str = "v3",
                  batch_size: int = 16, segment_frames: int = 32, disc_warmup: int = 0,
                  resume_state: Optional[str] = None) -> List[str]:
    """``cli.vocoder``'s arguments for one arm, as ``tools/gta_demo.py``
    builds them: the train split only, its own cache, logs every 200 steps,
    one save at the end; from ``resume_state`` (the whole GAN state) or
    else a generator-only start from ``baseline_gen`` (with
    ``--disc_warmup``); ``gta`` conditions on the work dir's acoustic
    model."""
    name = arm_name(gta, resume_state)
    argv = ["--data_dir", os.path.join(work, "corpus_train"),
            "--textgrid_dir", os.path.join(work, "corpus_train", "textgrids"),
            "--cache_dir", os.path.join(work, f"cache_voc_{name}"),
            "--config", config,
            "--steps", str(steps), "--batch_size", str(batch_size),
            "--segment_frames", str(segment_frames),
            "--log_every", "200", "--save_every", str(steps),
            "--name", name]
    if resume_state:
        argv += ["--resume_state", resume_state]
    else:
        argv += ["--finetune_from", baseline_gen]
        if disc_warmup:
            argv += ["--disc_warmup", str(disc_warmup)]
    if gta:
        argv += ["--gta_checkpoint", os.path.join(work, "acoustic.spev")]
    return argv


def run_finetune(work: str, baseline_gen: str, steps: int, gta: bool, config: str = "v3",
                 batch_size: int = 16, segment_frames: int = 32, disc_warmup: int = 0,
                 resume_state: Optional[str] = None, device="cuda") -> str:
    """One arm through ``cli.vocoder`` (in this process, from ``work``, as
    the JAX tool's subprocess runs there), skipped when its generator
    exists.  Returns ``work/checkpoints/<arm>/gen_<steps>.spev``."""
    from spev_tpu_torch.cli import vocoder as voc_cli

    name = arm_name(gta, resume_state)
    out = os.path.join(work, "checkpoints", name, f"gen_{steps:08d}.spev")
    if os.path.exists(out):
        print(f"{name}: exists, skipping")
        return out
    argv = finetune_argv(work, baseline_gen, steps, gta, config, batch_size, segment_frames,
                         disc_warmup, resume_state) + ["--device", str(device)]
    print("run: cli.vocoder " + " ".join(argv), flush=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc = voc_cli.main(argv)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"cli.vocoder exited with {rc} for the {name} arm")
    return out


# -- evaluation ----------------------------------------------------------------------


def evaluate_arms(work: str, baseline_gen: str, gens: Dict[str, str], out_path: str,
                  config: str = "v3", wav_dir: Optional[str] = None, device="cuda") -> dict:
    """``tools/gta_demo.py``'s eval phase: the work dir's corpus built into
    ``cache_eval`` on ``device``, the acoustic model's teacher-forced mels
    of every utterance, then for each held-out utterance of ``meta.json``
    and each arm (``baseline`` and ``gens``) the MCD of the vocoded
    predicted mel (``pred_mcd``) and of the vocoded ground-truth mel
    (``copy_mcd``) against the ground-truth mel.  With ``wav_dir`` the first
    three utterances' predicted-mel audio is written as
    ``val{j}_predmel_{arm}.wav``.  Writes and returns the JAX tool's JSON:
    ``summary_mean_mcd_db``, ``per_utterance``, ``n_val``, ``acoustic``."""
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.data.dataset import FeatureExtractor, SpevDataset
    from spev_tpu_torch.diag.quality import mel_cepstral_distortion
    from spev_tpu_torch.infer.gta import compute_gta_mels
    from spev_tpu_torch.utils.wavio import read_wav, write_wav

    with open(os.path.join(work, "meta.json")) as f:
        meta = json.load(f)
    corpus = os.path.join(work, "corpus")
    ds = SpevDataset(corpus, textgrid_dir=os.path.join(corpus, "textgrids"),
                     cache_dir=os.path.join(work, "cache_eval"), g2p_backend="rules",
                     stats_sample=60, device=device)
    pred_mels = compute_gta_mels(os.path.join(work, "acoustic.spev"), ds, device=device)
    vocs = {arm: _vocoder(path, config, device)
            for arm, path in {"baseline": baseline_gen, **gens}.items()}
    fx = FeatureExtractor(AudioConfig(), device=device)
    audio_sr = AudioConfig().sample_rate
    gt_wavs = utterance_wavs(corpus, ds.files, meta["va_idx"])
    results = {arm: {"pred_mcd": [], "copy_mcd": []} for arm in vocs}
    rows = {}
    for j, idx in enumerate(meta["va_idx"]):
        y_gt, _sr = read_wav(gt_wavs[j])
        mel_gt = np.asarray(fx.mel(y_gt), np.float32).T
        row = {}
        for arm, voc in vocs.items():
            wav_pred = voc.infer(pred_mels[idx])
            wav_copy = voc.infer(mel_gt)
            mcd_p = float(mel_cepstral_distortion(np.asarray(fx.mel(wav_pred), np.float32).T,
                                                  mel_gt))
            mcd_c = float(mel_cepstral_distortion(np.asarray(fx.mel(wav_copy), np.float32).T,
                                                  mel_gt))
            results[arm]["pred_mcd"].append(mcd_p)
            results[arm]["copy_mcd"].append(mcd_c)
            row[arm] = {"pred_mcd_db": round(mcd_p, 2), "copy_mcd_db": round(mcd_c, 2)}
            if wav_dir and j < 3:
                os.makedirs(wav_dir, exist_ok=True)
                write_wav(os.path.join(wav_dir, f"val{j}_predmel_{arm}.wav"),
                          np.clip(wav_pred, -1, 1), audio_sr)
        rows[f"val{j}"] = row
        print(f"val{j}: " + "  ".join(
            f"{arm} pred {row[arm]['pred_mcd_db']} / copy {row[arm]['copy_mcd_db']} dB"
            for arm in vocs), flush=True)
    summary = {arm: {k: round(statistics.mean(v), 2) for k, v in results[arm].items()}
               for arm in results}
    out = {"summary_mean_mcd_db": summary, "per_utterance": rows,
           "n_val": len(meta["va_idx"]), "acoustic": meta["final_quality"]}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary, indent=1))
    return out
