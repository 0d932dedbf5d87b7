"""Loss-trajectory probe of the bf16-discriminator mode: the counterpart of
the JAX package's ``tools/disc_bf16_probe.py``.

Runs the fused GAN step twice from the same init on the same synthetic
batch stream, once with fp32 discriminators and once with ``--disc_dtype
bf16``, and reports ``d_loss``, ``g_loss`` and ``g_mel`` at checkpoints
along the way and the steps per second of each.  bf16-D changes only the
discriminators' compute dtype (fp32 master weights and AdamW moments,
losses accumulated in fp32), so the trajectories should track each other
to bf16 rounding while the step gets faster.

Nothing is written to disk (the JAX tool appends its summary to
``docs/train_profile.jsonl``); the runner ``tools/torch_disc_bf16_probe.py``
writes a JSONL file where asked.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.diag.disc_profile import card, device_label
from spev_tpu_torch.models.hifigan import HiFiGANConfig
from spev_tpu_torch.train.vocoder_trainer import (init_vocoder_train_state,
                                                  make_vocoder_train_step)
from spev_tpu_torch.utils.platform import resolve_device

MODES = ("f32", "bf16")
TRACKED = ("d_loss", "g_loss", "g_mel")
VARIANT = "vocoder/v3/disc_bf16_probe"
# the JAX package's bar for bf16-D's first step against fp32's, a share of
# max(1, |fp32|) (tests/test_vocoder_training.py)
BF16_BAR = 0.08


def synthetic_pool(batch_size: int, segment_frames: int, seed: int = 0,
                   audio: AudioConfig = AudioConfig()) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The JAX tool's four (mel (B, F, n_mels), wav (B, F·hop)) float32
    batches, drawn in its order from ``default_rng(seed)``: a normal(-4, 2)
    mel, then a sine at 120 + 40k Hz plus 0.02 normal noise."""
    B, T = batch_size, segment_frames
    rng = np.random.default_rng(seed)
    pool = []
    for k in range(4):
        mel = rng.normal(-4, 2, (B, T, audio.n_mels))
        wav = (0.2 * np.sin(2 * np.pi * (120 + 40 * k) / audio.sample_rate
                            * np.arange(B * T * audio.hop_length).reshape(B, -1))
               + 0.02 * rng.normal(0, 1, (B, T * audio.hop_length)))
        pool.append((mel.astype(np.float32), wav.astype(np.float32)))
    return pool


def checkpoints(steps: int) -> List[int]:
    """The JAX tool's ``sorted({1, s//4, s//2, s})``."""
    return sorted({1, steps // 4, steps // 2, steps})


def first_step_gaps(res: Dict) -> Dict[str, float]:
    """|bf16 − fp32| / max(1, |fp32|) of each tracked loss at step 1 of a
    `bf16_probe` result: under `BF16_BAR` where bf16-D tracks fp32."""
    f32, bf16 = res["f32"]["traj"][1], res["bf16"]["traj"][1]
    return {k: abs(bf16[k] - f32[k]) / max(1.0, abs(f32[k])) for k in TRACKED}


def _fp32_state(state) -> bool:
    """Every master weight and AdamW moment of both networks in fp32."""
    for net, opt in ((state.generator, state.gen_opt), (state.discriminators, state.disc_opt)):
        for p in net.parameters():
            moments = opt.state.get(p, {})
            if p.dtype != torch.float32 or any(
                    moments[k].dtype != torch.float32 for k in ("exp_avg", "exp_avg_sq")
                    if k in moments):
                return False
    return True


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bf16_probe(steps: int = 200, batch_size: int = 16, segment_frames: int = 32,
               precision: str = "default", seed: int = 0, cfg: Optional[HiFiGANConfig] = None,
               periods: Optional[Sequence[int]] = None, n_scales: int = 3,
               device="cuda") -> Dict:
    """Both modes' runs and the JAX tool's summary.  Each mode builds the
    fused step at ``precision``, takes one warm-up step on the pool's first
    batch from a copy of `init_vocoder_train_state(cfg, seed=seed)`, starts
    again from another copy, then times ``steps`` steps over ``pool[i % 4]``
    (synchronised at the end).  Returns ``{"f32": run, "bf16": run, "summary": ..., "card": ...}``;
    a run is ``{"traj": {step: {d_loss, g_loss, g_mel}}, "steps_per_s",
    "skipped_last"}`` with the count of skipped steps, whether every loss was
    finite and whether the masters and moments stayed fp32 beside them.
    ``cfg`` (V3 by default), ``periods`` and ``n_scales`` cut the model for a
    test.  device: "cuda" (the default) raises without a GPU."""
    dev = resolve_device(device)
    cfg = cfg or HiFiGANConfig.v3()
    audio = AudioConfig()
    pool = [tuple(torch.from_numpy(a).to(dev) for a in b)
            for b in synthetic_pool(batch_size, segment_frames, seed, audio)]
    marks = checkpoints(steps)
    label = device_label(dev)
    init = init_vocoder_train_state(cfg, periods=periods, n_scales=n_scales, seed=seed,
                                    device=dev)
    results = {}
    for mode in MODES:
        step = make_vocoder_train_step(cfg, audio, fused=True,
                                       disc_dtype=None if mode == "f32" else "bf16",
                                       precision=precision)
        state, _ = step(copy.deepcopy(init), *pool[0])  # warm-up outside the timed window
        state = copy.deepcopy(init)
        traj, skipped, finite = {}, 0, True
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            state, m = step(state, *pool[i % len(pool)])
            skipped += int(m["skipped"])
            finite = finite and all(math.isfinite(m[k]) for k in TRACKED)
            if i in marks:
                traj[i] = {k: m[k] for k in TRACKED}
        _sync(dev)
        wall = time.perf_counter() - t0
        results[mode] = {"traj": traj, "steps_per_s": steps / wall, "skipped_last": m["skipped"],
                         "skipped_steps": skipped, "finite": finite,
                         "fp32_state": _fp32_state(state), "precision": precision,
                         "seed": seed, "device": label}
        del state
    f32, bf16 = results["f32"], results["bf16"]
    results["summary"] = {
        "variant": VARIANT,
        "steps": steps,
        "speedup": bf16["steps_per_s"] / f32["steps_per_s"],
        "final_g_mel_f32": f32["traj"][steps]["g_mel"],
        "final_g_mel_bf16": bf16["traj"][steps]["g_mel"],
        "final_d_loss_f32": f32["traj"][steps]["d_loss"],
        "final_d_loss_bf16": bf16["traj"][steps]["d_loss"],
        "steps_per_s_f32": f32["steps_per_s"],
        "steps_per_s_bf16": bf16["steps_per_s"],
        "device": label,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    results["card"] = None if dev.type == "cpu" else card()
    return results
