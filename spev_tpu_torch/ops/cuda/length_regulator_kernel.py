"""K1: fused length regulation — wrapper, plain version and launch count.

Counterpart of ``spev_tpu/ops/pallas/length_regulator_kernel.py``
(``_lr_fused_call`` → ``_lr_kernel``).  Given the int32 cumulative frame
ends of each row, frame j takes phoneme ``min(#{t : ends[t] <= j}, T-1)``
and is zero unless ``j < ends[-1]``; the hidden states (B, T, H) and the
eight lane-padded variance tracks (B, T, 8) are expanded in one pass.

On the card this is the CUDA kernel in ``spev_tpu_torch/csrc/
length_regulator.cu`` (a fused gather: ends staged in shared memory, a
binary search per frame, 16-byte copies).  It is bound by the bytes it
writes, B·M·(H+8)·4, against the card's 3.35 TB/s; see the source note.
The result is a copy, so the kernel is bit-equal to `lr_fused_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from spev_tpu_torch.ops.cuda import build

N_TRACKS = 8  # variance tracks, zero-padded to 8 lanes
_MAX_T = 48 * 1024 // 4  # ends[b, :T] must fit the default shared memory


def expand_by_ends(ends: torch.Tensor, max_frames: int, *tensors: torch.Tensor):
    """Plain frame expansion by int32 frame ends (B, T): frame j takes row
    ``min(#{t : ends[t] <= j}, T-1)`` of each (B, T, C) tensor, and zeros
    where ``j >= ends[:, -1]``.  Returns one (B, M, C) tensor per input."""
    B, T = ends.shape
    j = torch.arange(max_frames, dtype=torch.int32, device=ends.device)
    idx = torch.searchsorted(ends, j.expand(B, -1).contiguous(), right=True).clamp_max(T - 1)
    valid = (j[None, :] < ends[:, -1:])[..., None]
    rows = torch.arange(B, device=ends.device)[:, None]
    return tuple(torch.where(valid, t[rows, idx], t.new_zeros(())) for t in tensors)


def lr_fused_plain(x: torch.Tensor, fpad: torch.Tensor, ends: torch.Tensor,
                   max_frames: int):
    """Plain PyTorch version: a searchsorted frame→phoneme map and an index."""
    return expand_by_ends(ends, max_frames, x, fpad)


def _lib() -> ctypes.CDLL:
    lib = build.load("length_regulator")
    fn = lib.lr_fused_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def lr_fused(x: torch.Tensor, fpad: torch.Tensor, ends: torch.Tensor, max_frames: int):
    """Expand x (B, T, H) f32 and fpad (B, T, 8) f32 by int32 frame ends
    (B, T) to ((B, M, H), (B, M, 8)).  CPU tensors take `lr_fused_plain`;
    CUDA tensors launch K1 (counted in ``lr_fused.launches``) or raise."""
    if x.dim() != 3 or fpad.dim() != 3 or ends.dim() != 2:
        raise ValueError("lr_fused: expected x (B,T,H), fpad (B,T,8), ends (B,T)")
    B, T, H = x.shape
    M = int(max_frames)
    if fpad.shape != (B, T, N_TRACKS) or ends.shape != (B, T):
        raise ValueError(f"lr_fused: shapes {tuple(x.shape)}, {tuple(fpad.shape)}, "
                         f"{tuple(ends.shape)} do not agree")
    if x.dtype != torch.float32 or fpad.dtype != torch.float32 or ends.dtype != torch.int32:
        raise TypeError("lr_fused: x and fpad must be float32 and ends int32")
    if not (x.device == fpad.device == ends.device):
        raise ValueError("lr_fused: inputs lie on different devices")
    if x.device.type == "cpu":
        return lr_fused_plain(x, fpad, ends, M)
    if x.device.type != "cuda":
        raise ValueError(f"lr_fused: unsupported device {x.device}")
    if not (x.is_contiguous() and fpad.is_contiguous() and ends.is_contiguous()):
        raise ValueError("lr_fused: inputs must be contiguous")
    if not (1 <= B <= 65535 and 1 <= T <= _MAX_T and H >= 1 and M >= 1):
        raise ValueError(f"lr_fused: unsupported sizes B={B} T={T} H={H} M={M}")
    xout = torch.empty((B, M, H), dtype=torch.float32, device=x.device)
    fout = torch.empty((B, M, N_TRACKS), dtype=torch.float32, device=x.device)
    ptrs = (ends.data_ptr(), x.data_ptr(), fpad.data_ptr(), xout.data_ptr(), fout.data_ptr())
    vec = int(H % 4 == 0 and all(p % 16 == 0 for p in ptrs[1:]))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lr_fused_forward(*ptrs, B, T, H, M, vec, stream)
    build.check(rc, "lr_fused")
    lr_fused.launches += 1
    return xout, fout


lr_fused.launches = 0
