"""The plain training step: collation, FastSpeech 2's teacher-forced losses,
the global-norm clip and AdamW, one utterance at a time.

The loss is the configuration's:

    loss = w_mel * L1(mel) + w_duration * MSE(log_dur)
         + w_pitch * MSE(pitch) + w_energy * MSE(energy)
         + w_aux * (MSE(breath) + MSE(rough) + MSE(bright))

- L1(mel) sums |pred - target| over every row's first ``batch_max`` frames
  (the largest target frame count in the batch) and divides by
  B * batch_max * n_mels.  A row's frames past its own count hold a zero
  target; the model's output there is its mel head's bias (the decoder zeroes
  padded frames), clamped to [-10, 2].  |d| has derivative +1 at d = 0.
- The MSEs run over valid phonemes and divide by the batch's valid count;
  ``log_dur`` targets are log(max(d, 1) + 1).
- Clip: g * (max_norm / ||g||) when ||g|| >= max_norm.
- AdamW (decoupled decay), the n-th update at lr * min(n / warmup, 1):
  p *= 1 - lr_n * wd; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
  p -= lr_n / (1 - b1^n) * m / (sqrt(v) / sqrt(1 - b2^n) + eps).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ttsbench.reference.models import fastspeech2

TRACKS = ("pitch", "energy", "breath", "rough", "bright")


def _abs(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d >= 0, d, -d)


def utterance_key(n_phonemes: int, frames: int, ids) -> tuple:
    return (int(n_phonemes), int(frames), tuple(int(i) for i in ids))


def index_utterances(utterances: list, symbols: list) -> dict:
    """{key: index}: each utterance by its phoneme count, frame count and
    ids (unknown marks as 0, the training convention)."""
    index = {s: i for i, s in enumerate(symbols)}
    return {utterance_key(len(u["phs"]), u["mel"].shape[0],
                          [index.get(str(p), 0) for p in u["phs"]]): i
            for i, u in enumerate(utterances)}


def rows_of_batch(batch: dict, keys: dict) -> list:
    """The dataset index of each row of a collated batch (its phoneme
    count, frame count and ids), or None for a row that is no utterance."""
    out = []
    for b in range(len(batch["lens"])):
        n = int(batch["lens"][b])
        out.append(keys.get(utterance_key(n, batch["mel_lens"][b], batch["ids"][b, :n])))
    return out


def batch_loss(p: dict, cfg: dict, tc: dict, rows: list, symbols: list, device,
               autocast_dtype=None) -> torch.Tensor:
    """The loss of a batch of utterances (repeated rows included)."""
    index = {s: i for i, s in enumerate(symbols)}
    batch_max = max(u["mel"].shape[0] for u in rows)
    n_valid = sum(len(u["phs"]) for u in rows)
    B, n_mels = len(rows), cfg["n_mels"]
    mel_sum = 0.0
    mse = {k: 0.0 for k in ("log_duration", "pitch", "energy", "breath", "rough", "bright")}
    for u in rows:
        ids = torch.as_tensor([index.get(str(ph), 0) for ph in u["phs"]], device=device)
        durs = torch.as_tensor(np.asarray(u["durs"], np.float32), device=device)
        tracks = {k: torch.as_tensor(np.asarray(u[k], np.float32), device=device)
                  for k in TRACKS}
        with torch.autocast(device_type=torch.device(device).type, dtype=autocast_dtype,
                            enabled=autocast_dtype is not None):
            out = fastspeech2(p, cfg, ids, durations=durs, tracks=tracks, max_frames=10 ** 9)
        out = {k: v.float() for k, v in out.items()}
        mel_t = torch.as_tensor(np.asarray(u["mel"], np.float32), device=device)
        L = mel_t.shape[0]
        mel_sum = mel_sum + _abs(out["mel"] - mel_t).sum()
        if batch_max > L:
            pad = _abs(p["mel_linear.bias"].float().clamp(-10.0, 2.0)).sum()
            mel_sum = mel_sum + (batch_max - L) * pad
        target_ld = torch.log(torch.clamp_min(durs, 1.0) + 1.0)
        mse["log_duration"] = mse["log_duration"] + (out["log_duration_pred"] - target_ld).square().sum()
        for k in TRACKS:
            mse[k] = mse[k] + (out[f"{k}_pred"] - tracks[k]).square().sum()
    l_mel = mel_sum / (B * batch_max * n_mels)
    m = {k: v / max(n_valid, 1) for k, v in mse.items()}
    return (tc["w_mel"] * l_mel + tc["w_duration"] * m["log_duration"]
            + tc["w_pitch"] * m["pitch"] + tc["w_energy"] * m["energy"]
            + tc["w_aux"] * (m["breath"] + m["rough"] + m["bright"]))


class Trainer:
    """The reference's own parameters and AdamW state, stepped on batches of
    utterances.  ``autocast_dtype`` runs the products of the forward and
    backward at a lower precision (the control)."""

    def __init__(self, params: dict, cfg: dict, tc: dict, symbols: list, device,
                 autocast_dtype=None):
        self.p = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
                  for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.cfg, self.tc, self.symbols, self.device = cfg, tc, symbols, device
        self.autocast_dtype = autocast_dtype
        self.n = 0

    def step(self, rows: list) -> dict:
        """One update; returns the loss and the clipped gradient."""
        tc = self.tc
        loss = batch_loss(self.p, self.cfg, tc, rows, self.symbols, self.device,
                          self.autocast_dtype)
        grads = torch.autograd.grad(loss, list(self.p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g.float()
                 for (k, v), g in zip(self.p.items(), grads)}
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        if norm >= tc["grad_clip_norm"]:
            grads = {k: g * (tc["grad_clip_norm"] / norm) for k, g in grads.items()}
        self.n += 1
        b1, b2 = tc["betas"]
        lr = tc["learning_rate"] * min(self.n / tc["warmup_steps"], 1.0)
        with torch.no_grad():
            for k, p in self.p.items():
                g = grads[k]
                p.mul_(1.0 - lr * tc["weight_decay"])
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = self.v[k].sqrt() / math.sqrt(1.0 - b2 ** self.n) + tc["eps"]
                p.addcdiv_(self.m[k], denom, value=-lr / (1.0 - b1 ** self.n))
        return {"loss": float(loss.detach()), "grads": {k: g.detach().cpu() for k, g in grads.items()}}

    def params_cpu(self) -> dict:
        return {k: v.detach().cpu().clone() for k, v in self.p.items()}

