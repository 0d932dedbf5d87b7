"""The formant-corpus quality gate: the counterparts of the JAX package's
``tools/demo_common.py``, ``tools/gate_calibration.py``,
``tools/quality_trajectory.py`` and ``tools/make_demo.py``, and of the bars
of ``tests/test_convergence.py``.

One setup serves them all (`build_quality_setup`): a 120-utterance formant
corpus (seed 0), its cache built on the device (K2 once per utterance),
the hidden-96 model with ``vp_output_norm=False``, a 90/10 split and one
bucket.  `run_dashboard` trains it epoch by epoch (K1 a forward, K1b a
step) and reads ``validate``'s dashboard; `freerun_frame_errors` and
`write_demo` synthesize held-out utterances free-running with Griffin-Lim
(K1 a pass, K3 33 times a vocoding).  `gate_summary` is
``tools/gate_calibration.py``'s JSON and `gate_failures` the bars it is
held to, in one place for the tests, the tools and ``chip_smoke.py``.

Every entry point takes ``device`` ("cuda" by default; raises without a
GPU).  ``n_utterances`` exists so that the CPU tests can run small; its
default is the JAX setup's.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import shutil
import tempfile
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np

# the JAX setup's one bucket, for training, validation and synthesis
BUCKETS = dict(phoneme_buckets=(32,), frame_buckets=(256,))
# the bars of tests/test_convergence.py:88-131 (the code's, not
# docs/QUALITY.md's older 60 dB / 0.45x)
DURERR_BAR_PCT = 10.0
MCD_RATIO_BAR = 0.29
MCD_BAR_DB = 40.0
FREERUN_BAR_PCT = 9.0
TREND_KEYS = ("mcd", "durerr", "val")
# the name each line of `gate_failures` starts with
BARS = ("durerr", "mcd_ratio", "mcd", "freerun", "trend")


def trainer_setup(ds, epochs: int, work: str, device, *, hidden: int = 96,
                  learning_rate: float = 2e-3, **model_kw) -> SimpleNamespace:
    """The JAX tools' trainer on a built dataset: hidden/embed ``hidden``,
    per-phoneme predictors (``vp_output_norm=False``), B=16, 50 warmup
    steps, 2 duration-only epochs, a 0.1 validation split (seed 0) and one
    bucket.  ``model_kw`` adds model fields (the advanced tools' ``use_vad``,
    ``n_speakers``).  Returns the fields of ``tools/demo_common.py``'s
    namespace but the corpus's."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher, train_val_split
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    vocab = Vocab(ds.vocab)
    cfg = SpevConfig(
        model=ModelConfig(vocab_size=len(vocab), embed_dim=hidden, hidden_dim=hidden, n_mels=80,
                          max_frames=256, vp_output_norm=False, **model_kw),
        train=TrainConfig(batch_size=16, warmup_steps=50, epochs=epochs, warmup_epochs=2,
                          learning_rate=learning_rate),
    )
    tr_idx, va_idx = train_val_split(len(ds), 0.1, seed=0)
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(work, "ck"),
                      log_dir=os.path.join(work, "logs"), device=device)
    bt = BucketBatcher(ds, vocab, batch_size=16, indices=tr_idx, **BUCKETS)
    bv = BucketBatcher(ds, vocab, batch_size=16, indices=va_idx, **BUCKETS)
    return SimpleNamespace(work=work, ds=ds, vocab=vocab, cfg=cfg, trainer=trainer, bt=bt,
                           bv=bv, va_idx=va_idx)


def build_quality_setup(epochs: int, lr_mult: float = 1.0, device="cuda",
                        n_utterances: int = 120, work: Optional[str] = None) -> SimpleNamespace:
    """``tools/demo_common.py``'s setup: the formant corpus (seed 0,
    ``n_utterances``), `SpevDataset` with the rules G2P and 60 stats
    utterances built on ``device``, and `trainer_setup`'s hidden-96 trainer
    at lr ``2e-3 * lr_mult`` (``lr_mult`` is the gate calibration's
    adversarial arm; 1.0 is the calibrated setup).  Returns JAX's fields:
    work, corpus_root, cache, ds, vocab, cfg, trainer, bt, bv, va_idx."""
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.data.synthetic import generate_formant_corpus
    from spev_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    work = work or tempfile.mkdtemp(prefix="spev_quality_")
    root, cache = os.path.join(work, "corpus"), os.path.join(work, "cache")
    tg_dir = generate_formant_corpus(root, n_utterances=n_utterances, seed=0)
    ds = SpevDataset(root, textgrid_dir=tg_dir, cache_dir=cache, g2p_backend="rules",
                     stats_sample=60, device=dev)
    s = trainer_setup(ds, epochs, work, dev, learning_rate=2e-3 * lr_mult)
    s.corpus_root, s.cache = root, cache
    return s


def run_dashboard(setup, epochs: int,
                  on_epoch: Optional[Callable[[int, dict], None]] = None) -> List[dict]:
    """``epochs`` of `Trainer.train_epoch` over the train batcher, each
    followed by ``validate`` on the held-out batcher; one row a epoch of
    ``loss`` (the epoch's mean train loss), ``val`` (val mel L1), ``mcd``
    and ``durerr`` (``last_quality``'s val MCD and duration error, NaN when
    absent), passed to ``on_epoch(epoch, row)`` as it comes."""
    hist = []
    for epoch in range(epochs):
        m = setup.trainer.train_epoch(setup.bt.epoch(epoch))
        val = setup.trainer.validate(setup.bv.epoch(0))
        q = setup.trainer.last_quality
        hist.append({"loss": float(m["train_loss"]), "val": float(val),
                     "mcd": float(q.get("val_mcd_db", math.nan)),
                     "durerr": float(q.get("val_dur_err_pct", math.nan))})
        if on_epoch is not None:
            on_epoch(epoch, hist[-1])
    return hist


def progress(epochs: int, every: int = 10) -> Callable[[int, dict], None]:
    """An ``on_epoch`` that prints the JAX tools' progress line every
    ``every`` epochs and at the last of ``epochs``."""
    def on_epoch(epoch: int, row: dict) -> None:
        if epoch % every == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: loss {row['loss']:.3f} val {row['val']:.3f} "
                  f"MCD {row['mcd']:.1f} durerr {row['durerr']:.1f}%", flush=True)
    return on_epoch


def _synthesizer(trainer, cfg, name: str, include_opt: bool, device):
    from spev_tpu_torch.infer.synthesis import Synthesizer

    ckpt = trainer.save(name, include_opt=include_opt)
    return Synthesizer(ckpt, hifigan_dir=None, model_cfg=cfg.model, g2p_backend="rules",
                       device=device, **BUCKETS)


def freerun_frame_errors(trainer, ds, vocab, cfg, va_idx, device="cuda") -> List[float]:
    """Free-running frame-count error per held-out utterance, in %: the
    trainer saved without its optimizer, a Griffin-Lim `Synthesizer` at the
    setup's bucket, and each utterance's cached phonemes through
    ``phonemes_to_ids`` → ``synthesize_ids`` (predicted durations, no
    teacher forcing); ``|frames - gt| / gt * 100`` against the cached mel's
    frames.  ``vocab`` is unused, as in ``tools/gate_calibration.py``: the
    checkpoint carries it."""
    synth = _synthesizer(trainer, cfg, "gate_cal", False, device)
    errs = []
    for idx in va_idx:
        u = ds.load_utterance(idx)
        phs = [str(p) for p in u["phs"]]
        gt = int(np.asarray(u["mel"]).shape[0])
        _, mel = synth.synthesize_ids(synth.phonemes_to_ids(phs))
        errs.append(abs(len(mel) - gt) / gt * 100.0)
    return errs


def gate_summary(hist: List[dict], errors: List[float], epochs: int, lr_mult: float) -> dict:
    """``tools/gate_calibration.py``'s JSON, key for key: epoch 0's MCD, the
    median MCD of the last 5 epochs and its ratio to epoch 0's, the median
    duration error of the last 3, the free-running errors' median and max,
    and for MCD, duration error and val loss the medians of the first and
    the last third of the epochs."""
    k = len(hist) // 3

    def med(key, rows):
        return float(np.median([h[key] for h in rows]))

    return {
        "epochs": epochs,
        "lr_mult": lr_mult,
        "mcd0": hist[0]["mcd"],
        "mcd_final_med5": med("mcd", hist[-5:]),
        "mcd_ratio": med("mcd", hist[-5:]) / hist[0]["mcd"],
        "durerr_final_med3": med("durerr", hist[-3:]),
        "freerun_frame_err_pct_median": float(np.median(errors)),
        "freerun_frame_err_pct_max": float(np.max(errors)),
        "trend": {key: [med(key, hist[:k]), med(key, hist[-k:])] for key in TREND_KEYS},
    }


def gate_failures(summary: dict) -> List[str]:
    """The bars of ``tests/test_convergence.py`` that ``summary`` breaks,
    one line each, starting with the bar's name in `BARS` and a colon (a
    NaN breaks its bar): the last 3 epochs' median
    duration error under 10 %; the last 5 epochs' median MCD under 0.29x
    epoch 0's and under 40 dB; the median free-running frame error under
    9 %; MCD, duration error and val loss each lower in the last third of
    the epochs than in the first."""
    s, failed = summary, []
    if not s["durerr_final_med3"] < DURERR_BAR_PCT:
        failed.append(f"durerr: duration error {s['durerr_final_med3']:.2f} % (median of the "
                      f"last 3 epochs) is not under {DURERR_BAR_PCT} %")
    if not s["mcd_final_med5"] < MCD_RATIO_BAR * s["mcd0"]:
        failed.append(f"mcd_ratio: MCD {s['mcd_final_med5']:.2f} dB (median of the last 5 "
                      f"epochs) is not under {MCD_RATIO_BAR}x epoch 0's {s['mcd0']:.2f} dB")
    if not s["mcd_final_med5"] < MCD_BAR_DB:
        failed.append(f"mcd: MCD {s['mcd_final_med5']:.2f} dB (median of the last 5 epochs) "
                      f"is not under {MCD_BAR_DB} dB")
    if not s["freerun_frame_err_pct_median"] < FREERUN_BAR_PCT:
        failed.append(f"freerun: free-running frame error "
                      f"{s['freerun_frame_err_pct_median']:.2f} % (median) is not under "
                      f"{FREERUN_BAR_PCT} %")
    for key in TREND_KEYS:
        first, last = s["trend"][key]
        if not last < first:
            failed.append(f"trend: {key} did not fall from the first third's median "
                          f"{first:.4f} to the last third's {last:.4f}")
    return failed


def write_demo(setup, out_dir: str, gan_checkpoint: Optional[str] = None,
               gan_config: str = "v3") -> dict:
    """``tools/make_demo.py``'s page from a trained setup: the first three
    held-out utterances synthesized free-running from their cached
    phonemes (Griffin-Lim), each written as ``val{j}_gt.wav`` (the corpus
    wav its cache file indexes in the sorted recursive wav glob, never by
    position), ``val{j}_synth.wav``, with ``gan_checkpoint`` (a
    ``gen_*.spev`` of ``gan_config``) also ``val{j}_synth_gan.wav``, and
    ``val{j}_mels.png`` (skipped, with one line, without matplotlib); then
    ``demo_metrics.json`` (the final dashboard, the epochs trained, and per
    utterance its phonemes, predicted and ground-truth frames and MCD).
    Returns the metrics."""
    from spev_tpu_torch.cli.common import PNGS_SKIPPED
    from spev_tpu_torch.diag import plots
    from spev_tpu_torch.diag.quality import mel_cepstral_distortion
    from spev_tpu_torch.utils.wavio import write_wav

    ds, trainer = setup.ds, setup.trainer
    gan_voc = None
    if gan_checkpoint:
        from spev_tpu_torch.infer.vocoder import Vocoder
        from spev_tpu_torch.models.hifigan import HiFiGANConfig
        from spev_tpu_torch.train.vocoder_trainer import load_generator

        gcfg = HiFiGANConfig() if gan_config == "v1" else HiFiGANConfig.v3()
        gan_voc = Vocoder(generator=load_generator(gan_checkpoint, gcfg), device=trainer.device)
    synth = _synthesizer(trainer, setup.cfg, "demo", True, trainer.device)
    os.makedirs(out_dir, exist_ok=True)
    metrics = {"final_quality": {k: round(float(v), 2) for k, v in trainer.last_quality.items()},
               "epochs": trainer.epoch, "utterances": {}}
    all_wavs = sorted(glob.glob(os.path.join(os.path.abspath(setup.corpus_root), "**", "*.wav"),
                                recursive=True))
    pngs = plots.available()
    if not pngs:
        print(PNGS_SKIPPED)
    for j, idx in enumerate(setup.va_idx[:3]):
        u = ds.load_utterance(idx)
        phs = [str(p) for p in u["phs"]]
        mel_gt = np.asarray(u["mel"])
        wav, mel = synth.synthesize_ids(synth.phonemes_to_ids(phs))
        name = f"val{j}"
        wav_i = int(re.match(r"u_(\d+)\.npz$", ds.files[idx]).group(1))
        shutil.copy(all_wavs[wav_i], os.path.join(out_dir, f"{name}_gt.wav"))
        write_wav(os.path.join(out_dir, f"{name}_synth.wav"), np.clip(wav, -1, 1),
                  synth.audio.sample_rate)
        if gan_voc is not None:
            wav_gan = np.asarray(gan_voc.infer(mel))
            write_wav(os.path.join(out_dir, f"{name}_synth_gan.wav"), np.clip(wav_gan, -1, 1),
                      synth.audio.sample_rate)
        if pngs:
            plots.save_comparison_plot(mel_gt, mel, os.path.join(out_dir, f"{name}_mels.png"))
        T = min(len(mel), len(mel_gt))
        mcd = float(mel_cepstral_distortion(mel[:T], mel_gt[:T]))
        metrics["utterances"][name] = {
            "phonemes": len(phs), "frames_pred": int(len(mel)),
            "frames_gt": int(len(mel_gt)), "mcd_db_vs_gt": round(mcd, 2),
        }
        print(f"{name}: {len(phs)} phonemes -> {len(mel)} frames (gt {len(mel_gt)}), "
              f"MCD {mcd:.2f} dB", flush=True)
    with open(os.path.join(out_dir, "demo_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print("demo written to", out_dir)
    return metrics
