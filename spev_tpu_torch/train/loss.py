"""Masked multi-term training loss with the reference's semantics
(counterpart of ``spev_tpu.train.loss``):

    loss = 1.0·L1(mel) + 0.5·MSE(log_dur)
         + vw·(0.1·MSE(pitch) + 0.1·MSE(energy) + 0.05·(MSE(breath) + MSE(rough) + MSE(bright)))

- The mel L1 is **unmasked** inside the batch-max target frame count: a
  ``t < batch_max`` mask and a ``B · batch_max · n_mels`` denominator, so
  zero-padded frames inside the batch max count, as in the reference.
- The predictor MSEs are masked by phoneme validity and divided by
  ``max(sum(mask), 1)``.
- ``variance_weight`` (vw) is 0 during the duration-only warmup epochs; it
  also multiplies the nasal term when the model has one.
- **Data parallelism** (``group``): each rank holds some rows of a global
  batch.  The denominators are those of the global batch (``batch_max`` a
  MAX, the row and valid-phoneme counts SUMs over the group), so each
  rank's loss is its rows' share and the sum over ranks is the global
  batch's loss, exactly as under the JAX package's sharding.
"""

from __future__ import annotations

import torch

from spev_tpu_torch.config import TrainConfig


def xla_abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with derivative +1 at d = 0, as XLA's abs in the JAX package
    (``torch.abs`` gives 0 there)."""
    return torch.where(d >= 0, d, -d)


def _masked_mse(pred, target, mask, count):
    return torch.sum(torch.square(pred - target) * mask) / torch.clamp_min(count, 1.0)


def global_denominators(batch_max: torch.Tensor, n_valid: torch.Tensor, rows: int, group):
    """(batch_max, valid phonemes, rows) of the global batch: a MAX and one
    SUM all-reduce over ``group``."""
    import torch.distributed as dist

    batch_max = batch_max.detach().clone()
    sums = torch.stack([n_valid.detach(), torch.tensor(float(rows), device=n_valid.device)])
    dist.all_reduce(batch_max, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(sums, group=group)
    return batch_max, sums[0], sums[1]


def compute_losses(outputs: dict, batch: dict, cfg: TrainConfig,
                   variance_weight: float = 1.0, group=None):
    """outputs: the teacher-forced `FastSpeech2` output dict; batch: 'mel'
    (B, M, n_mels), 'log_durs', 'pitch', 'energy', 'breath', 'rough',
    'bright' (B, P) and 'mel_lens' (B,) tensors padded to the buckets.
    group: the process group of a data-parallel step (this rank's share of
    the global batch's loss), or None.  Returns (total loss, metrics dict
    of 0-d tensors)."""
    src_valid = (~outputs["src_mask"]).to(torch.float32)
    mel_pred, mel_tgt = outputs["mel_pred"], batch["mel"]
    B, M, n_mels = mel_pred.shape
    batch_max = torch.max(batch["mel_lens"]).to(torch.float32)
    n_valid = torch.sum(src_valid)
    if group is not None:
        batch_max, n_valid, B = global_denominators(batch_max, n_valid, B, group)
    in_batch_max = (torch.arange(M, dtype=torch.float32, device=mel_pred.device)[None, :]
                    < batch_max).to(torch.float32)
    # XLA's |d|: padded frames inside the batch max, where a zero-bias head
    # predicts exactly the zero target, then push the bias
    l_mel = torch.sum(xla_abs(mel_pred - mel_tgt) * in_batch_max[..., None]) / (
        B * batch_max * n_mels)

    def mse(name, target):
        return _masked_mse(outputs[name], batch[target], src_valid, n_valid)

    l_dur = mse("log_duration_pred", "log_durs")
    l_pitch = mse("pitch_pred", "pitch")
    l_energy = mse("energy_pred", "energy")
    l_aux = mse("breath_pred", "breath") + mse("rough_pred", "rough") + mse("bright_pred", "bright")
    total = (cfg.w_mel * l_mel + cfg.w_duration * l_dur
             + variance_weight * (cfg.w_pitch * l_pitch + cfg.w_energy * l_energy
                                  + cfg.w_aux * l_aux))
    metrics = {"loss": total, "l_mel": l_mel, "l_dur": l_dur, "l_pitch": l_pitch,
               "l_energy": l_energy, "l_aux": l_aux}
    if "nasal_pred" in outputs and "nasal" in batch:
        l_nasal = mse("nasal_pred", "nasal")
        total = total + variance_weight * cfg.w_nasal * l_nasal
        metrics["loss"] = total
        metrics["l_nasal"] = l_nasal
    return total, metrics
