"""Least bytes a kernel moves: each input byte read once, each output byte
written once, from the call's shapes and valid frames (the method of the
kernel table in ``PERF.md``).  fp32 tensors and int32 ends throughout."""

from __future__ import annotations

F32 = 4
I32 = 4


def k1(B: int, T: int, H: int, F: int, M: int) -> int:
    """Kernel K1 (``lr_fused``): reads ends (B, T), x (B, T, H) and the
    tracks (B, T, F); writes x (B, M, H) and the tracks (B, M, F), the zero
    frames past each row's total included."""
    return B * T * I32 + B * T * (H + F) * F32 + B * M * (H + F) * F32


def k1b(B: int, T: int, H: int, F: int, valid_frames: int) -> int:
    """Kernel K1b (``lr_fused_backward``): reads ends (B, T) and the frame
    gradients of the valid frames only, (valid, H + F); writes the phoneme
    gradients (B, T, H + F)."""
    return B * T * I32 + valid_frames * (H + F) * F32 + B * T * (H + F) * F32
