"""Configuration dataclasses (the numerics contract of the reference model).

Own copy of the serving part of ``spev_tpu.config``: the audio constants the
vocoders use, the clamp contract and the acoustic-model hyperparameters.
The TPU-only switches of the JAX package (Pallas length regulation, vmapped
predictors, rematerialisation), training-only fields (dropout) and the
advanced surface that is not ported yet (VAD, speakers) are left out;
`ModelConfig.from_dict` ignores them in a stored config.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Audio/DSP constants."""

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    fmin: float = 0.0
    fmax: float = 8000.0
    # the log-mel floor: vocoder bucket padding takes this value
    mel_clip_min: float = -10.0


@dataclass(frozen=True)
class ClampConfig:
    """Predictor/feature clamp ranges — the model contract."""

    log_dur: Tuple[float, float] = (-4.0, 4.0)
    pitch: Tuple[float, float] = (-2.5, 2.5)
    energy: Tuple[float, float] = (-2.5, 2.5)
    bright: Tuple[float, float] = (-2.5, 2.5)
    breath: Tuple[float, float] = (0.0, 0.8)
    rough: Tuple[float, float] = (0.0, 1.5)
    # post-length-regulation clamps
    pitch_expanded: Tuple[float, float] = (-3.0, 3.0)
    energy_expanded: Tuple[float, float] = (-3.0, 3.0)
    bright_expanded: Tuple[float, float] = (-3.0, 3.0)
    breath_expanded: Tuple[float, float] = (0.0, 1.0)
    rough_expanded: Tuple[float, float] = (0.0, 2.0)
    # duration decode: round(clamp((exp(log_dur)-1)*d_control, 0, 500))
    duration_max: float = 500.0
    # length-regulator per-duration guard
    duration_guard_max: float = 1000.0
    # mel output clamp
    mel: Tuple[float, float] = (-10.0, 2.0)


@dataclass(frozen=True)
class ModelConfig:
    """FastSpeech2 acoustic-model hyperparameters."""

    vocab_size: int = 256
    embed_dim: int = 256
    hidden_dim: int = 256
    n_mels: int = 80
    n_heads: int = 2
    n_encoder_layers: int = 4
    n_decoder_layers: int = 4
    ffn_kernel_size: int = 9
    ffn_expansion: int = 4
    vp_layers: int = 2
    vp_kernel_size: int = 3
    # The variance predictors end in LayerNorm over a single feature, which
    # outputs exactly its bias (a learned constant).  Kept for checkpoint
    # parity; False gives per-phoneme predictors.
    vp_output_norm: bool = True
    clamps: ClampConfig = field(default_factory=ClampConfig)
    # learned nasality channel: a seventh predictor and embedding conv
    use_nasality: bool = False
    # default frame bucket of a forward pass (padding is masked out)
    max_frames: int = 2048

    @staticmethod
    def from_dict(stored: dict) -> "ModelConfig":
        """Rebuild from a stored field dict, ignoring keys this config does
        not have (the JAX package stores its TPU-only switches too)."""
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in stored.items() if k in names})
