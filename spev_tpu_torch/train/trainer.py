"""Acoustic-model trainer: train and eval steps, the NaN-skip policy,
warmup, validation and checkpoints (counterpart of
``spev_tpu.train.trainer``).

- **Clip**: global-norm clip in optax's form, ``g / ‖g‖ · max`` only when
  ``‖g‖ ≥ max`` (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6``
  and would give another result).
- **AdamW**: ``torch.optim.AdamW`` with betas (0.9, 0.98), eps 1e-9 and
  weight decay 0.01 on every parameter.  optax decays every leaf, so every
  parameter gets a gradient (zeros where autograd has none) before a step.
- **Warmup**: the n-th *applied* update runs at ``lr · min(n / warmup, 1)``.
- **NaN skip**: ``ok = isfinite(loss) & isfinite(‖g‖)``, read on the host
  once per step together with the step's metrics.  When it is false the
  parameters, the optimizer state and the step counter stay as they were,
  ``skipped`` is 1, and an epoch aborts after more than ``max_nan_batches``
  such steps (the reference's per-batch semantics).
- **Gradient accumulation** (``grad_accum > 1``): the batch is split into
  micro-batches; those with a non-finite loss are left out of the mean, and
  a window with none finite is skipped.
- **Two phases**: ``variance_weight`` is 0 during ``warmup_epochs``.
- **Dropout** masks come from one ``torch.Generator`` on the training
  device seeded from ``TrainConfig.seed`` (JAX's bits cannot be matched);
  the weights are drawn on the CPU from the same seed.  Shuffling is
  `BucketBatcher`'s ``random.Random(seed + epoch)``.

The model runs fp32 eagerly: each step turns TF32 off for matmuls and
cuDNN convolutions (PyTorch's default runs cuDNN convolutions in TF32) and
restores the process's settings afterwards.  The length regulator's forward
and backward are the CUDA kernels K1 and K1b on the card.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Iterable, List

import numpy as np
import torch

from spev_tpu_torch.config import SpevConfig
from spev_tpu_torch.data.prefetch import prefetch
from spev_tpu_torch.diag.quality import duration_error_pct, mel_cepstral_distortion
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.train.checkpoint import save_checkpoint
from spev_tpu_torch.train.loss import compute_losses
from spev_tpu_torch.utils.params import read_checkpoint
from spev_tpu_torch.utils.platform import fp32_precision, resolve_device

_TRACKS = ("pitch", "energy", "breath", "rough", "bright")


def forward_losses(model: FastSpeech2, cfg: SpevConfig, batch: dict, variance_weight: float,
                   generator=None):
    """Teacher-forced forward at the batch's buckets, then the losses.
    Returns (outputs, (loss, metrics))."""
    kw = {f"target_{k}": batch[k] for k in _TRACKS}
    if cfg.model.use_nasality and "nasal" in batch:
        kw["target_nasal"] = batch["nasal"]
    out = model(batch["ids"], batch["lens"], batch["mel"].shape[1],
                target_durations=batch["durs"], dropout_generator=generator, **kw)
    return out, compute_losses(out, batch, cfg.train, variance_weight)


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def loss_and_grads(model: FastSpeech2, cfg: SpevConfig, batch: dict, variance_weight: float,
                   generator=None):
    """(loss, metrics, one gradient per ``model.parameters()``).  With
    ``grad_accum`` > 1 the mean over the micro-batches whose loss is
    finite; the loss is NaN when none is."""
    params = list(model.parameters())
    accum = max(1, int(cfg.train.grad_accum))
    if accum == 1:
        _, (loss, metrics) = forward_losses(model, cfg, batch, variance_weight, generator)
        return loss, metrics, _grads(loss, params)
    mb = batch["ids"].shape[0] // accum
    gsum = [torch.zeros_like(p) for p in params]
    lsum = msum = None
    nok = torch.zeros((), device=batch["ids"].device)
    zero = torch.zeros((), device=batch["ids"].device)
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        _, (loss, metrics) = forward_losses(model, cfg, micro, variance_weight, generator)
        finite = torch.isfinite(loss.detach())
        gsum = [a + torch.where(finite, g, zero) for a, g in zip(gsum, _grads(loss, params))]
        keep = {k: torch.where(finite, v.detach(), zero) for k, v in metrics.items()}
        msum = keep if msum is None else {k: msum[k] + keep[k] for k in msum}
        lsum = keep["loss"] if lsum is None else lsum + keep["loss"]
        nok = nok + finite.to(torch.float32)
    denom = torch.clamp_min(nok, 1.0)
    loss = torch.where(nok > 0, lsum / denom, torch.full_like(lsum, float("nan")))
    return loss, {k: v / denom for k, v in msum.items()}, [g / denom for g in gsum]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Trainer:
    """Host-side training loop on one device: epochs, NaN budget,
    validation, ``last``/``best`` checkpoints carrying vocab, stats, step
    and the model config."""

    def __init__(self, cfg: SpevConfig, vocab, stats: dict, ckpt_dir: str = "checkpoints/run",
                 log_dir: str = "logs/run", device="cuda"):
        """device: "cuda" (the default) raises when no GPU is present; pass
        "cpu" to train on the CPU."""
        if cfg.model.n_speakers > 1 or cfg.model.use_vad:
            raise UserError("multi-speaker and VAD (advanced) training are not ported to "
                            "PyTorch yet (ROADMAP.md, 'Advanced surface')")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = list(getattr(vocab, "symbols", vocab))
        self.stats = stats
        self.ckpt_dir, self.log_dir = ckpt_dir, log_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        os.makedirs(log_dir, exist_ok=True)
        self.model = FastSpeech2.random_init(cfg.model, seed=cfg.train.seed).to(self.device)
        self.params = list(self.model.parameters())
        self.optimizer = self._new_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.step = 0  # applied updates (the reference's step_num)
        self.epoch = 0
        self.nan_count = 0
        self.best_val = math.inf
        self.last_quality: dict = {}

    def _new_optimizer(self) -> torch.optim.AdamW:
        tc = self.cfg.train
        return torch.optim.AdamW(self.params, lr=tc.learning_rate, betas=tc.betas, eps=tc.eps,
                                 weight_decay=tc.weight_decay)

    def to_device(self, batch: dict) -> dict:
        """A numpy batch from `BucketBatcher` as tensors on the device."""
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}
        out["ids"] = out["ids"].long()
        return out

    def apply_gradients(self, grads: List[torch.Tensor], loss: torch.Tensor,
                        metrics: dict) -> dict:
        """Clip, warm up and apply one AdamW update, unless the loss or the
        gradient norm is not finite.  One host read per call.  Returns the
        metrics as floats with ``grad_norm``, ``skipped`` and ``lr``."""
        tc = self.cfg.train
        gnorm = global_norm(grads)
        vals = torch.stack([loss.detach(), gnorm] + [v.detach() for v in metrics.values()]).tolist()
        lr = tc.learning_rate * min((self.step + 1) / tc.warmup_steps, 1.0)
        ok = math.isfinite(vals[0]) and math.isfinite(vals[1])
        if ok:
            clip = vals[1] >= tc.grad_clip_norm
            for p, g in zip(self.params, grads):
                p.grad = g / gnorm * tc.grad_clip_norm if clip else g
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.step += 1
        for p in self.params:
            p.grad = None
        out = dict(zip(metrics, vals[2:]))
        out.update(grad_norm=vals[1], skipped=0.0 if ok else 1.0, lr=lr)
        return out

    def gradients(self, batch: dict, variance_weight: float = 1.0):
        """(loss, metrics, gradients) of a device batch in train mode, in
        fp32 (dropout masks from the trainer's generator; set the config's
        dropout rates to 0 to turn it off)."""
        self.model.train()
        with fp32_precision():
            return loss_and_grads(self.model, self.cfg, batch, variance_weight, self.generator)

    def train_step(self, batch: dict, variance_weight: float = 1.0) -> dict:
        """One update on a device batch."""
        loss, metrics, grads = self.gradients(batch, variance_weight)
        return self.apply_gradients(grads, loss, metrics)

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """The plain mel L1 and the pitch + energy MSE, plus the first
        sample's mel pair and the batch's duration predictions (device
        tensors), in fp32."""
        self.model.eval()
        with fp32_precision():
            out, (_, m) = forward_losses(self.model, self.cfg, batch, 1.0)
        return {"val_mel": m["l_mel"], "val_aux": m["l_pitch"] + m["l_energy"],
                "mel_pred_0": out["mel_pred"][0], "mel_target_0": batch["mel"][0],
                "mel_len_0": batch["mel_lens"][0], "log_dur_pred": out["log_duration_pred"]}

    def train_epoch(self, batches: Iterable[dict]) -> dict:
        """One epoch over numpy batch dicts (loaded ``prefetch_batches``
        ahead).  Returns the last step's metrics and ``train_loss``, the mean
        over applied steps.  Raises RuntimeError when the NaN budget is
        exhausted."""
        tc = self.cfg.train
        vw = 0.0 if self.epoch < tc.warmup_epochs else 1.0
        total, n, last = 0.0, 0, {}
        for batch in prefetch(batches, depth=tc.prefetch_batches):
            m = self.train_step(self.to_device(batch), vw)
            if m["skipped"] > 0.5:
                self.nan_count += 1
                if self.nan_count > tc.max_nan_batches:
                    raise RuntimeError(f"Too many NaN batches ({self.nan_count}). "
                                       "Stopping training.")
                continue
            total += m["loss"]
            n += 1
            last = m
        self.epoch += 1
        return {**last, "train_loss": total / max(n, 1)}

    def validate(self, batches: Iterable[dict]) -> float:
        """Mean val mel L1 over the finite batches; the first batch's quality
        numbers go to ``last_quality``."""
        tot, n = 0.0, 0
        self.last_quality = {}
        for i, batch in enumerate(batches):
            m = self.eval_step(self.to_device(batch))
            v = float(m["val_mel"])
            if math.isfinite(v):
                tot += v
                n += 1
            if i == 0:
                self.last_quality = self._first_batch_quality(
                    {k: t.cpu().numpy() for k, t in m.items()}, batch)
        return tot / max(n, 1)

    @staticmethod
    def _first_batch_quality(m: dict, batch: dict) -> dict:
        """MCD of the first sample and the teacher-forced duration error of
        the batch's valid phonemes, against the reference's targets (MCD <
        6 dB, duration error < 10 %)."""
        L = int(m["mel_len_0"])
        out = {"val_mcd_db": mel_cepstral_distortion(m["mel_pred_0"][:L], m["mel_target_0"][:L])}
        pred = np.round(np.clip(np.exp(m["log_dur_pred"].astype(np.float32)) - 1.0, 0.0, 500.0))
        tgt = np.asarray(batch["durs"], np.float32)
        mask = tgt > 0
        if mask.any():
            out["val_dur_err_pct"] = duration_error_pct(pred[mask], tgt[mask])
        return out

    def save(self, name: str = "last", include_opt: bool = True) -> str:
        """``<ckpt_dir>/<name>.pt``; ``include_opt=False`` writes the
        inference checkpoint, without the optimizer."""
        path = os.path.join(self.ckpt_dir, f"{name}.pt")
        save_checkpoint(path, self.model, self.optimizer if include_opt else None, self.step,
                        self.epoch, self.vocab, self.stats, self.cfg.model)
        return path

    def maybe_save_best(self, val_loss: float) -> bool:
        """``best.pt`` without the optimizer on every improvement."""
        if math.isfinite(val_loss) and val_loss < self.best_val:
            self.best_val = val_loss
            self.save("best", include_opt=False)
            return True
        return False

    def restore(self, path: str) -> None:
        """Weights, step and epoch from a checkpoint.  ``last.pt`` carries
        the optimizer, so training continues exactly; from a checkpoint
        without it (``best.pt``) the optimizer restarts, with a warning, and
        the warmup continues from the saved step."""
        ckpt = read_checkpoint(path)
        self.model.load_state_dict(ckpt["model"])
        if ckpt.get("optimizer") is None:
            warnings.warn(f"{path} has no optimizer state (an inference checkpoint such as "
                          "best.pt): the optimizer restarts; resume from last.pt for exact "
                          "continuation", stacklevel=2)
            self.optimizer = self._new_optimizer()
        else:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = int(ckpt["step_num"])
        self.epoch = int(ckpt["epoch"])
