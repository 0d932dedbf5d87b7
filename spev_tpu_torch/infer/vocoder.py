"""Vocoder: HiFi-GAN when a generator or checkpoint directory is given,
Griffin-Lim otherwise — counterpart of ``spev_tpu.infer.vocoder``.

The Griffin-Lim fallback feeds ``exp(log_mel)`` into NNLS + Griffin-Lim with
the audio config's fmin/fmax.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.diag.profiling import spanned
from spev_tpu_torch.models.hifigan import HiFiGANGenerator
from spev_tpu_torch.ops.griffin_lim import mel_to_audio
from spev_tpu_torch.utils.platform import resolve_device


class Vocoder:
    """log-mel (T, n_mels) → waveform.

    hifigan_dir: directory with config.json + a g_* checkpoint; when absent
      (or None) and no ``generator`` is given, Griffin-Lim is used.
    device: where it runs; "cuda" (the default) raises without a GPU.
    """

    def __init__(
        self,
        hifigan_dir: Optional[str] = None,
        audio: AudioConfig = AudioConfig(),
        generator: Optional[HiFiGANGenerator] = None,
        frame_buckets: tuple = (256, 512, 1024, 2048),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.audio = audio
        self.frame_buckets = tuple(sorted(frame_buckets))
        if generator is None and hifigan_dir and os.path.exists(
            os.path.join(hifigan_dir, "config.json")
        ):
            try:
                generator = HiFiGANGenerator.from_pretrained(hifigan_dir)
            except FileNotFoundError:
                generator = None
        self.generator = None if generator is None else generator.to(self.device).eval()

    @property
    def is_neural(self) -> bool:
        return self.generator is not None

    @torch.inference_mode()
    @spanned("spev.vocoder")
    def run(self, mel: torch.Tensor, mel_len: torch.Tensor) -> torch.Tensor:
        """Batched vocoding of bucket-padded log-mels (B, M, n_mels) on the
        vocoder's device → (B, M·hop).  HiFi-GAN masks by ``mel_len``;
        Griffin-Lim vocodes each row over the whole bucket."""
        if self.generator is not None:
            return self.generator(mel, mel_len)
        a = self.audio
        return torch.stack([
            mel_to_audio(torch.exp(m).T.contiguous(), sr=a.sample_rate, n_fft=a.n_fft,
                         hop_length=a.hop_length, fmin=a.fmin, fmax=a.fmax)
            for m in mel
        ])

    def infer(self, log_mel) -> np.ndarray:
        """log_mel (T, n_mels), an array or a tensor on any device →
        waveform np.float32.  The HiFi-GAN path pads T to a frame bucket
        (beyond the top bucket, a multiple of it) with the mel floor and
        masks, so the valid prefix is exact."""
        mel = torch.as_tensor(log_mel, dtype=torch.float32, device=self.device)
        T = int(mel.shape[0])
        if self.generator is None:
            return self.run(mel[None], torch.tensor([T], device=self.device))[0].cpu().numpy()
        top = self.frame_buckets[-1]
        bucket = next((b for b in self.frame_buckets if T <= b), -(-T // top) * top)
        if bucket > T:
            mel = F.pad(mel, (0, 0, 0, bucket - T), value=self.audio.mel_clip_min)
        hop = self.generator.cfg.hop_recovery
        wav = self.run(mel[None], torch.tensor([T], device=self.device))[0]
        return wav[: T * hop].cpu().numpy()
