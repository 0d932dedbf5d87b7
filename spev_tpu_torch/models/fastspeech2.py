"""FastSpeech 2 acoustic model with six variance predictors.

Counterpart of ``spev_tpu.models.fastspeech2``: phoneme embedding → encoder
FFT blocks → duration/pitch/energy/bright/breath/rough[/nasal] predictors
with the clamp contract → length regulation of the hidden states and every
variance track in one call of kernel K1 → variance-embedding convs →
decoder FFT blocks → linear mel head clamped to [-10, 2].

Parameter names are the reference state-dict names, so a reference ``.pt``
loads with ``load_state_dict``.  A config with VAD or several speakers adds
``advanced`` (`spev_tpu_torch.models.advanced.AdvancedExtras`), which
`apply_advanced` reads.  Training: in train mode, with a
``dropout_generator``, dropout runs at the JAX package's sites (after the
attention and after ``conv2`` in each FFT block, after the zero-pad of each
predictor layer); without one the forward is deterministic.  Gradients pass
the length regulator through kernel K1b.

With ``ModelConfig.remat`` each FFT block of the encoder and decoder runs
under ``torch.utils.checkpoint`` while gradients are recorded (`remat_block`):
``'full'`` keeps only the block's input and recomputes the block in the
backward, ``'dots'`` keeps the outputs of its matmuls and convolutions too
(the counterpart of ``jax.checkpoint_policies.dots_saveable``).  The length
regulator stays outside every checkpoint, so K1 runs once a forward and K1b
once a backward whatever the policy.

Padded positions are zeroed before every conv and after every block, so each
conv sees the implicit zero padding at the true sequence end that an
unpadded input would give.  The frame axis is the static bucket
``max_frames`` with an explicit ``mel_len`` and mask.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.diag.profiling import span
from spev_tpu_torch.models import modules as m
from spev_tpu_torch.models.advanced import AdvancedExtras
from spev_tpu_torch.ops.length_regulator import length_regulate_fused
from spev_tpu_torch.parallel import tensor_parallel as tp

PREDICTORS = ("duration", "pitch", "energy", "bright", "breath", "rough")
# the variance tracks, in the order they are stacked for K1 and embedded
EMBEDDED = ("pitch", "energy", "breath", "rough", "bright")


def _zero_pad(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    return x.masked_fill(pad_mask[..., None], 0.0)


class FFTBlock(nn.Module):
    """Self-attention + residual LN, conv FFN (ReLU) + residual LN.

    With ``model_group`` (S ranks; `spev_tpu_torch.parallel.tensor_parallel`)
    the attention holds n_heads/S heads, ``conv1`` inner/S output channels
    and ``conv2`` inner/S input channels; ``conv2``'s partial outputs are
    summed over the group before its bias.  Both dropouts act on the summed,
    replicated tensors."""

    def __init__(self, cfg: ModelConfig, model_group=None):
        super().__init__()
        h, k = cfg.hidden_dim, cfg.ffn_kernel_size
        inner = cfg.hidden_dim * cfg.ffn_expansion // tp.model_size(model_group)
        self.model_group = model_group
        self.attention = m.MultiheadAttention(h, cfg.n_heads, model_group)
        self.norm1 = m.LayerNorm(h)
        self.conv1 = m.Conv1d(h, inner, k)
        self.conv2 = m.Conv1d(inner, h, k)
        self.norm2 = m.LayerNorm(h)
        self.rate = cfg.dropout

    def _ffn(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        group = self.model_group
        if group is None:
            return self.conv2(_zero_pad(torch.relu(self.conv1(x)), pad_mask))
        h = _zero_pad(torch.relu(self.conv1(tp.copy_to_model(x, group))), pad_mask)
        return tp.reduce_from_model(m.conv1d(h, self.conv2.weight, None), group) + self.conv2.bias

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                g: Optional[torch.Generator] = None) -> torch.Tensor:
        attn = self.attention(x, key_padding_mask=pad_mask)
        x = self.norm1(x + m.dropout(attn, self.rate, g, self.training))
        x = _zero_pad(x, pad_mask)
        x = self.norm2(x + m.dropout(self._ffn(x, pad_mask), self.rate, g, self.training))
        return _zero_pad(x, pad_mask)


_DOTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
         torch.ops.aten.convolution}


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(block: FFTBlock, x: torch.Tensor, pad_mask: torch.Tensor,
                g: Optional[torch.Generator], policy: str = "full") -> torch.Tensor:
    """``block(x, pad_mask, g)`` under a non-reentrant checkpoint.

    The checkpoint restores only the default generators, and dropout draws
    from ``g``: the block runs with a generator set to ``g``'s state before
    it, in the forward and again in the recompute, so both draw the same
    masks, and ``g`` is then advanced to where the block left it, as
    without remat."""
    state = None if g is None else g.get_state()
    used = []

    def run(x):
        gen = None
        if state is not None:
            gen = torch.Generator(device=g.device)
            gen.set_state(state)
            used.append(gen)
        return block(x, pad_mask, gen)

    context = (functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
               if policy == "dots" else None)
    kw = {"context_fn": context} if context else {}
    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False, **kw)
    if g is not None:
        g.set_state(used[0].get_state())
    return out


class VariancePredictor(nn.Module):
    """vp_layers × [conv(k=3) → ReLU → LN] → Linear(→1) → LayerNorm(1).

    ``layers`` keeps the reference's Sequential indices (conv at 4i, norm at
    4i+2; ReLU and dropout between them carry no parameters)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_dim
        layers = []
        for _ in range(cfg.vp_layers):
            layers += [m.Conv1d(h, h, cfg.vp_kernel_size), nn.ReLU(), m.LayerNorm(h), nn.Identity()]
        self.layers = nn.ModuleList(layers)
        self.proj = m.Linear(h, 1)
        self.output_norm = m.LayerNorm(1)
        self.use_output_norm = cfg.vp_output_norm
        self.rate = cfg.vp_dropout

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                g: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(0, len(self.layers), 4):
            h = self.layers[i + 2](torch.relu(self.layers[i](h)))
            h = m.dropout(_zero_pad(h, pad_mask), self.rate, g, self.training)
        out = self.proj(h)
        if self.use_output_norm:
            out = self.output_norm(out)
        return out[..., 0]


class FastSpeech2(nn.Module):
    def __init__(self, cfg: ModelConfig, model_group=None):
        """model_group: the process group of a 'model' mesh axis; its ranks
        share the FFT blocks (load the shards with
        `spev_tpu_torch.parallel.mesh.shard_state_dict`).  None: the whole
        model here."""
        super().__init__()
        if model_group is not None:
            tp.check_model_axis(cfg, tp.model_size(model_group))
        self.cfg = cfg
        self.embedding = m.Embedding(cfg.vocab_size, cfg.embed_dim, padding_idx=0)
        self.encoder_blocks = nn.ModuleList(FFTBlock(cfg, model_group)
                                            for _ in range(cfg.n_encoder_layers))
        self.decoder_blocks = nn.ModuleList(FFTBlock(cfg, model_group)
                                            for _ in range(cfg.n_decoder_layers))
        for name in PREDICTORS + (("nasal",) if cfg.use_nasality else ()):
            setattr(self, f"{name}_predictor", VariancePredictor(cfg))
        for name in EMBEDDED + (("nasal",) if cfg.use_nasality else ()):
            setattr(self, f"{name}_embedding", m.Conv1d(1, cfg.hidden_dim, 3))
        self.mel_linear = m.Linear(cfg.hidden_dim, cfg.n_mels)
        self.advanced = (AdvancedExtras(cfg.hidden_dim, cfg.n_speakers)
                         if cfg.use_vad or cfg.n_speakers > 1 else None)

    @staticmethod
    def random_init(cfg: ModelConfig, seed: int = 0) -> "FastSpeech2":
        """A model with seeded weights drawn on the CPU: torch-default
        distributions, N(0, 0.01²) variance-embedding convs and mel head with
        zero biases; ``advanced`` as `AdvancedExtras.init_` makes it."""
        g = torch.Generator().manual_seed(seed)
        model = FastSpeech2(cfg)
        for mod in model.modules():
            m.init_module_(mod, g)
        with torch.no_grad():
            for name, mod in model.named_children():
                if name.endswith("_embedding") or name == "mel_linear":
                    m.normal_init_(mod.weight, 0.01, g)
                    mod.bias.zero_()
        if model.advanced is not None:
            model.advanced.init_(g)
        return model.eval()

    def _block(self, block: FFTBlock, x: torch.Tensor, pad_mask: torch.Tensor,
               g: Optional[torch.Generator]) -> torch.Tensor:
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_block(block, x, pad_mask, g, self.cfg.remat_policy)
        return block(x, pad_mask, g)

    def forward(
        self,
        phoneme_ids: torch.Tensor,
        lengths: torch.Tensor,
        max_frames: Optional[int] = None,
        *,
        target_durations: Optional[torch.Tensor] = None,
        target_pitch: Optional[torch.Tensor] = None,
        target_energy: Optional[torch.Tensor] = None,
        target_breath: Optional[torch.Tensor] = None,
        target_rough: Optional[torch.Tensor] = None,
        target_bright: Optional[torch.Tensor] = None,
        target_nasal: Optional[torch.Tensor] = None,
        d_control=1.0,
        p_control=1.0,
        e_control=1.0,
        encoder_bias: Optional[torch.Tensor] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> dict:
        """phoneme_ids (B, P) int, zero-padded; lengths (B,).  Passing
        ``target_durations`` selects the teacher-forced path;
        target_breath/rough/bright alone override the predictions.  The
        d/p/e controls are a scalar or a (B, 1) / (B, P) tensor.
        ``encoder_bias`` (B, P, H) is added after the encoder stack.
        max_frames: the frame bucket M (default ``cfg.max_frames``).
        dropout_generator: draws the dropout masks in train mode (on the
        model's device); None gives a deterministic forward."""
        cfg, clamps = self.cfg, self.cfg.clamps
        M = int(max_frames or cfg.max_frames)
        B, P = phoneme_ids.shape
        dev = phoneme_ids.device
        src_mask = torch.arange(P, device=dev)[None, :] >= lengths.to(dev)[:, None]

        g = dropout_generator
        with span("spev.fs2.encoder"):
            x = self.embedding(phoneme_ids)
            for block in self.encoder_blocks:
                x = self._block(block, x, src_mask, g)
            if encoder_bias is not None:
                x = _zero_pad(x + encoder_bias, src_mask)

        with span("spev.fs2.variance"):
            has_nasal = cfg.use_nasality
            names = PREDICTORS + (("nasal",) if has_nasal else ())
            raw = {n: getattr(self, f"{n}_predictor")(x, src_mask, g) for n in names}
            log_dur_pred = raw["duration"].clamp(*clamps.log_dur)
            pitch_pred = raw["pitch"].clamp(*clamps.pitch)
            energy_pred = raw["energy"].clamp(*clamps.energy)
            bright_pred = raw["bright"].clamp(*clamps.bright)
            breath_pred = raw["breath"].clamp(*clamps.breath)
            rough_pred = raw["rough"].clamp(*clamps.rough)
            nasal_pred = raw["nasal"].clamp(0.0, 1.0) if has_nasal else None

            if target_durations is not None:
                durations = target_durations
                pitch, energy = target_pitch, target_energy
                breath, rough, bright = target_breath, target_rough, target_bright
            else:
                # round half to even, as torch.round does
                durations = torch.round(
                    ((torch.exp(log_dur_pred) - 1.0) * d_control).clamp(0.0, clamps.duration_max)
                )
                durations = durations.masked_fill(src_mask, 0.0)
                pitch = pitch_pred * p_control
                energy = energy_pred * e_control
                breath = breath_pred if target_breath is None else target_breath
                rough = rough_pred if target_rough is None else target_rough
                bright = bright_pred if target_bright is None else target_bright
            nasal = None
            if has_nasal:
                nasal = nasal_pred if target_nasal is None else target_nasal

            tracks = [pitch, energy, breath, rough, bright] + ([nasal] if has_nasal else [])
            feats = torch.stack([t.to(torch.float32) for t in tracks], dim=-1)
            x_exp, feats_f, mel_len = length_regulate_fused(
                x, feats, durations, M, clamps.duration_guard_max
            )
            lo_hi = (clamps.pitch_expanded, clamps.energy_expanded, clamps.breath_expanded,
                     clamps.rough_expanded, clamps.bright_expanded, (0.0, 1.0))
            dec = x_exp
            for i, name in enumerate(EMBEDDED + (("nasal",) if has_nasal else ())):
                track = feats_f[..., i].clamp(*lo_hi[i])
                dec = dec + getattr(self, f"{name}_embedding")(track[..., None])

        with span("spev.fs2.decoder"):
            frame_mask = torch.arange(M, device=dev)[None, :] >= mel_len[:, None]
            for block in self.decoder_blocks:
                dec = self._block(block, dec, frame_mask, g)
            mel = self.mel_linear(dec).clamp(*clamps.mel)

        return {
            "mel_pred": mel,
            "log_duration_pred": log_dur_pred,
            "pitch_pred": pitch_pred,
            "energy_pred": energy_pred,
            "breath_pred": breath_pred,
            "rough_pred": rough_pred,
            "bright_pred": bright_pred,
            **({"nasal_pred": nasal_pred} if has_nasal else {}),
            "src_mask": src_mask,
            "mel_len": mel_len,
            "frame_mask": frame_mask,
            "durations": durations,
        }
