"""Static-shape length regulation (counterpart of
``spev_tpu.ops.length_regulator`` and of ``length_regulate_fused`` in
``spev_tpu.ops.pallas.length_regulator_kernel``).

    ends   = cumsum(sanitised durations)            # (B, T) int32
    frame2ph[j] = #{t : ends[t] <= j}, clamped to T-1
    out[j] = x[frame2ph[j]] where j < total, else 0

Edge cases, as in the reference: a duration that is non-finite, negative or
above the guard (1000) counts as 0, and the rest are truncated to int32;
zero-duration phonemes get no frame; an all-zero row gives one zero frame
(``mel_len`` is ``max(min(total, M), 1)``); the output is right-padded with
zeros to the frame bucket M.

`length_regulate_fused` is the model's path: hidden states and every
variance track in one call of kernel K1 (`ops.cuda.length_regulator_kernel`),
differentiable in both through the backward kernel K1b; on CPU tensors each
is its plain version.  Durations get no gradient, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spev_tpu_torch.ops.cuda.length_regulator_kernel import (N_TRACKS, expand_by_ends, lr_fused,
                                                             lr_fused_bwd)


def sanitize_durations(durations: torch.Tensor, guard_max: float = 1000.0) -> torch.Tensor:
    """Non-finite, negative or > guard_max → 0, then truncate to int32."""
    d = durations.to(torch.float32)
    ok = torch.isfinite(d) & (d >= 0) & (d <= guard_max)
    return torch.where(ok, d, torch.zeros((), device=d.device)).to(torch.int32)


def regulate_lengths(durations: torch.Tensor, guard_max: float = 1000.0):
    """(ends (B, T) int32, total (B,) int32) of the sanitised durations."""
    ends = torch.cumsum(sanitize_durations(durations, guard_max), dim=-1, dtype=torch.int32)
    return ends, ends[..., -1]


def _mel_len(total: torch.Tensor, max_frames: int) -> torch.Tensor:
    return total.clamp(max=max_frames).clamp(min=1).to(torch.int32)


def length_regulate(x: torch.Tensor, durations: torch.Tensor, max_frames: int,
                    guard_max: float = 1000.0):
    """Expand (B, T, H) phoneme features to (B, M, H) frames; returns
    (expanded, mel_len (B,) int32)."""
    ends, total = regulate_lengths(durations, guard_max)
    (expanded,) = expand_by_ends(ends, max_frames, x)
    return expanded, _mel_len(total, max_frames)


def length_regulate_feature(f: torch.Tensor, durations: torch.Tensor, max_frames: int,
                            guard_max: float = 1000.0) -> torch.Tensor:
    """Expand a scalar per-phoneme feature (B, T) to (B, M)."""
    expanded, _ = length_regulate(f[..., None], durations, max_frames, guard_max)
    return expanded[..., 0]


class LRFused(torch.autograd.Function):
    """K1 forward, K1b backward: the counterpart of ``_lr_fused`` and its
    ``custom_vjp``.  On CPU tensors both are their plain versions, so the CPU
    exercises the same wiring as the card.  Gradients flow to x and fpad;
    the integer ``ends`` get none."""

    @staticmethod
    def forward(ctx, x, fpad, ends, max_frames: int):
        ctx.save_for_backward(ends)
        return lr_fused(x, fpad, ends, max_frames)

    @staticmethod
    def backward(ctx, gx, gf):
        (ends,) = ctx.saved_tensors
        gx_ph, gf_ph = lr_fused_bwd(gx.contiguous(), gf.contiguous(), ends, ends.shape[1])
        return gx_ph, (gf_ph if ctx.needs_input_grad[1] else None), None, None


def length_regulate_fused(x: torch.Tensor, features: torch.Tensor, durations: torch.Tensor,
                          max_frames: int, guard_max: float = 1000.0):
    """Hidden states (B, T, H) and up to 8 tracks (B, T, F) expanded together
    by one K1 call (one K1b call in the backward).  Returns (x (B, M, H),
    features (B, M, F), mel_len (B,))."""
    F_ = features.shape[-1]
    if F_ > N_TRACKS:
        raise ValueError(f"at most {N_TRACKS} variance tracks, got {F_}")
    ends, total = regulate_lengths(durations, guard_max)
    fpad = F.pad(features.to(torch.float32), (0, N_TRACKS - F_))
    x_out, f_out = LRFused.apply(x.to(torch.float32).contiguous(), fpad.contiguous(),
                                 ends.contiguous(), int(max_frames))
    return x_out, f_out[..., :F_], _mel_len(total, max_frames)
