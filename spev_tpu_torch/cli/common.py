"""Shared CLI plumbing (counterpart of ``spev_tpu.cli.common``): the
training loop of ``cli.train``, ``cli.spev_tts``, ``cli.real_metrics`` and
``cli.spev_advanced``, and the guard that turns a user error into one
``error:`` line and exit status 2.

Mel PNGs (the validation comparison, the probes', an inference's) need
matplotlib; without it they are skipped with one line and the run goes on.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time
from typing import Optional

from spev_tpu_torch.errors import UserError
from spev_tpu_torch.ops.cuda import kernel_launches


def cli_guard(fn):
    """Run ``fn`` and return its exit status; a `UserError`,
    ``FileNotFoundError`` or ``NotADirectoryError`` (bad flag values, paths
    or inputs) becomes one ``error: ...`` line on stderr and status 2.
    Internal errors keep their tracebacks."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs) -> int:
        try:
            return fn(*args, **kwargs) or 0
        except (UserError, FileNotFoundError, NotADirectoryError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    return wrapper


PNGS_SKIPPED = "mel PNGs skipped: matplotlib is not installed"


def write_output(wav, output: str, mel=None) -> None:
    """Write the waveform at the audio config's rate and, given its mel
    (T, n_mels), ``<output>_mel.png`` beside it (skipped with one line when
    matplotlib is not installed)."""
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.diag import plots
    from spev_tpu_torch.utils.wavio import write_wav

    write_wav(output, wav, AudioConfig().sample_rate)
    print(f"wrote {output} ({len(wav)} samples)")
    if mel is None:
        return
    if not plots.available():
        print(PNGS_SKIPPED)
        return
    png = os.path.splitext(output)[0] + "_mel.png"
    plots.save_mel_plot(mel.T, png, title="Generated Mel Spectrogram")
    print(f"Mel spectrogram saved to {png}")


def write_outputs(wav, mel, output: str, sr: int = 22050) -> None:
    """The JAX package's form: the waveform at ``sr`` and ``<output>_mel.png``
    of its mel (T, n_mels) beside it (skipped with one line when matplotlib
    is not installed)."""
    from spev_tpu_torch.diag import plots
    from spev_tpu_torch.utils.wavio import write_wav

    write_wav(output, wav, sr)
    print(f"Audio saved to {output}")
    if not plots.available():
        print(PNGS_SKIPPED)
        return
    png = os.path.splitext(output)[0] + "_mel.png"
    plots.save_mel_plot(mel.T, png, title="Generated Mel Spectrogram")
    print(f"Mel spectrogram saved to {png}")


def add_cache_flags(p) -> None:
    """Dataset-cache flags shared by the training CLIs."""
    p.add_argument("--cache_dir", type=str, default="cache_spev",
                   help="feature-cache directory (npz + metadata.json)")
    p.add_argument("--force_rebuild", action="store_true",
                   help="delete and rebuild the feature cache (the reference's default "
                        "behavior)")


def run_training(args, warmup_epochs: int = 0, model_overrides: Optional[dict] = None):
    """Dataset (built on ``args.device`` when the cache is missing, with
    speaker labels under ``args.multi_speaker`` and emotion-VAD labels under
    ``args.emotion_labels``) → 95/5 split → bucketed batches → Trainer
    epochs with validation (a ``val_<epoch>.png`` every ``save_every``
    epochs), ``last``/``best`` checkpoints, and every 10 epochs the numbered
    ``ckpt_<n>`` snapshot and the synthesis probes.  Returns the Trainer.

    Under ``python -m torch.distributed.run`` (or the ``SPEV_*`` variables
    of `spev_tpu_torch.parallel.distributed.initialize`) it trains
    data-parallel over the process group's ranks: rank 0 builds a missing
    cache while the others wait, every rank takes its rows of each global
    batch, and rank 0 alone writes files and prints the epochs.  With
    ``args.model_axis`` S > 1 (``cli.train --model_axis S``) the ranks form
    a (world/S, S) data×model mesh: each group of S ranks shares the FFT
    blocks, every rank takes part in the saves' gathers, and rank 0's group
    runs the probes."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher, train_val_split
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.diag import plots
    from spev_tpu_torch.diag.metrics import log_metrics
    from spev_tpu_torch.diag.probes import test_inference_probe
    from spev_tpu_torch.parallel import distributed
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    distributed.initialize(device=args.device)
    main_rank = distributed.rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    multi_speaker = bool(getattr(args, "multi_speaker", False))
    emotion_labels = bool(getattr(args, "emotion_labels", False))
    if not main_rank:
        distributed.barrier()  # rank 0 builds a missing cache first
    ds = SpevDataset(args.data_dir, textgrid_dir=getattr(args, "textgrid_dir", None),
                     cache_dir=getattr(args, "cache_dir", "cache_spev"),
                     force_rebuild=main_rank and getattr(args, "force_rebuild", False),
                     multi_speaker=multi_speaker, emotion_vad=emotion_labels,
                     device=args.device)
    if main_rank:
        distributed.barrier()
    if emotion_labels and ds.emotions:
        say(f"Emotion-VAD labels: {', '.join(ds.emotions)}")
    vocab = Vocab(ds.vocab)
    say(f"Dataset: {len(ds)} utterances, vocab {len(vocab)}")

    model_overrides = dict(model_overrides or {})
    if multi_speaker:
        # the speaker table is sized from the corpus' labels; batches then
        # carry speaker_ids into the advanced model's speaker embedding
        model_overrides.setdefault("n_speakers", max(2, len(ds.speakers)))
        say(f"Multi-speaker: {len(ds.speakers)} speakers "
            f"({', '.join(ds.speakers[:8])}{'…' if len(ds.speakers) > 8 else ''})")
    train_kw = {}
    if getattr(args, "warmup_steps", None) is not None:
        train_kw["warmup_steps"] = int(args.warmup_steps)
    model_axis = int(getattr(args, "model_axis", 1) or 1)
    if model_axis > 1:
        train_kw.update(mesh_shape=(max(1, distributed.world_size() // model_axis), model_axis),
                        mesh_axes=("data", "model"))
    cfg = SpevConfig(
        model=ModelConfig(vocab_size=len(vocab), **model_overrides),
        train=TrainConfig(learning_rate=args.lr, batch_size=args.batch_size,
                          grad_accum=getattr(args, "grad_accum", 1), epochs=args.epochs,
                          warmup_epochs=warmup_epochs, **train_kw),
    )
    tr_idx, va_idx = train_val_split(len(ds), cfg.train.val_fraction, seed=cfg.train.seed)
    say(f"Dataset: {len(tr_idx)} Train, {len(va_idx)} Val")
    n_mels = cfg.model.n_mels
    train_b = BucketBatcher(ds, vocab, batch_size=cfg.train.batch_size, n_mels=n_mels,
                            indices=tr_idx)
    val_b = BucketBatcher(ds, vocab, batch_size=cfg.train.batch_size, n_mels=n_mels,
                          indices=va_idx)
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join("checkpoints", args.name),
                      log_dir=os.path.join("logs", args.name), device=args.device)
    if trainer.group is not None:
        import torch.distributed as dist

        say(f"Data-parallel over {trainer.mesh.data_size} rank(s), model axis "
            f"{trainer.mesh.model_size} ({dist.get_backend()})")
    if getattr(args, "resume", None):
        say(f"Resuming from {args.resume}")
        trainer.restore(args.resume)
    pngs = plots.available()
    if not pngs:
        say(PNGS_SKIPPED)

    # the resumable `last` (parameters and optimizer, three times the
    # parameters' bytes) and the validation PNG every save_every epochs and
    # at the end; `best` (parameters only) on every improvement
    save_every = max(1, int(getattr(args, "save_every", 10) or 10))
    step0, train_s = trainer.step, 0.0
    for epoch in range(trainer.epoch, cfg.train.epochs):
        t0 = time.perf_counter()
        metrics = trainer.train_epoch(train_b.epoch(epoch))  # ends on a host read
        train_s += time.perf_counter() - t0
        cadence = (epoch + 1) % save_every == 0 or epoch + 1 == cfg.train.epochs
        val_loss = trainer.validate(val_b.epoch(0),
                                    save_plot_epoch=epoch if cadence and pngs else None)
        quality = trainer.last_quality
        if main_rank:
            log_metrics(trainer.log_dir, epoch, {**metrics, "val_mel": val_loss, **quality})
            qstr = ""
            if "val_mcd_db" in quality:
                qstr = f" | MCD {quality['val_mcd_db']:.2f} dB"
                if "val_dur_err_pct" in quality:
                    qstr += f" | dur err {quality['val_dur_err_pct']:.1f}%"
            print(f"Epoch {epoch + 1}: train {metrics['train_loss']:.4f} | "
                  f"val mel {val_loss:.4f}{qstr}")
        # every rank saves (rank 0 writes; on a model axis the ranks gather)
        if cadence:
            trainer.save("last")
        if trainer.maybe_save_best(val_loss):
            say(f"New best model saved (val {val_loss:.4f})")
        if (epoch + 1) % 10 == 0:
            # numbered snapshots, parameters only (the resumable state is
            # `last`), and the synthesis probes on rank 0's model group (on
            # a model axis their forward is collective)
            trainer.save(f"ckpt_{epoch + 1}", include_opt=False)
            if trainer.mesh.data_index == 0:
                test_inference_probe(trainer, log_dir=trainer.log_dir, epoch=epoch)
    steps = trainer.step - step0
    say(f"Trained {steps} steps in {train_s:.2f} s ({1e3 * train_s / max(steps, 1):.2f} ms a "
        f"step); kernel launches {json.dumps(kernel_launches())}")
    return trainer
