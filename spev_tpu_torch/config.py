"""Configuration dataclasses (the numerics contract of the reference model).

Own copy of ``spev_tpu.config``: the audio constants the vocoders use, the
clamp contract, the acoustic-model hyperparameters and the trainer's.  The
TPU-only switches of the JAX package (Pallas length regulation, vmapped
predictors, rematerialisation, matmul precision, the dropout PRNG, the mesh,
the metrics window) are left out; `ModelConfig.from_dict` ignores them in a
stored config.  The advanced surface (VAD, speakers) keeps its two switches
so that a config asking for it is refused rather than silently dropped.
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
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    # log-mel dynamic range: clip(log(max(mel, mel_floor)), mel_clip_min,
    # mel_clip_max); vocoder bucket padding takes mel_clip_min
    mel_floor: float = 1e-5
    mel_clip_min: float = -10.0
    mel_clip_max: float = 2.0
    # F0 extraction range and tracker: 'pyin' = the full candidate-lattice
    # HMM (librosa.pyin semantics), 'yin_lite' = the best-trough fast path
    f0_min: float = 60.0
    f0_max: float = 500.0
    f0_method: str = "pyin"


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
    dropout: float = 0.1
    vp_layers: int = 2
    vp_kernel_size: int = 3
    vp_dropout: float = 0.1
    # The variance predictors end in LayerNorm over a single feature, which
    # outputs exactly its bias (a learned constant).  Kept for checkpoint
    # parity; False gives per-phoneme predictors.
    vp_output_norm: bool = True
    clamps: ClampConfig = field(default_factory=ClampConfig)
    # advanced surface, not ported: the Trainer refuses either switch
    use_vad: bool = False
    n_speakers: int = 1
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


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and trainer hyperparameters (the reference's values).  The
    port trains in fp32 (the Trainer turns TF32 off for its steps) and reads
    each step's skip flag on the host."""

    learning_rate: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.01
    warmup_steps: int = 4000
    grad_clip_norm: float = 1.0
    batch_size: int = 16
    grad_accum: int = 1
    epochs: int = 100
    val_fraction: float = 0.05
    max_nan_batches: int = 10
    # loss weights
    w_mel: float = 1.0
    w_duration: float = 0.5
    w_pitch: float = 0.1
    w_energy: float = 0.1
    w_aux: float = 0.05
    # learned nasality channel weight, active only with model.use_nasality
    w_nasal: float = 0.1
    # two-phase schedule: the first `warmup_epochs` train mel + duration
    # only; the variance-predictor losses join afterwards
    warmup_epochs: int = 0
    # batches staged ahead of the device by a background thread (npz loads
    # and collate overlap the step); 0 disables
    prefetch_batches: int = 2
    # seeds the weights and the dropout generator
    seed: int = 0


@dataclass(frozen=True)
class SpevConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
