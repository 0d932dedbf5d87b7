"""K1 and K1b: fused length regulation and its backward — wrappers, plain
versions and launch counts.

Counterpart of ``spev_tpu/ops/pallas/length_regulator_kernel.py``
(``_lr_fused`` with its ``custom_vjp``: ``_lr_fused_call`` → ``_lr_kernel``
forward, ``_lr_fused_bwd`` → ``_lr_bwd_kernel`` backward).  Given the int32
cumulative frame ends of each row, frame j takes phoneme
``min(#{t : ends[t] <= j}, T-1)`` and is zero unless ``j < ends[-1]``; the
hidden states (B, T, H) and the eight lane-padded variance tracks (B, T, 8)
are expanded in one pass.  The backward sums each phoneme's frame
cotangents (a segment-sum); ``ends`` is integer and gets no gradient.

On the card both are the CUDA kernels in ``spev_tpu_torch/csrc/
length_regulator.cu``: K1 a fused gather (one warp per frame counts the
ends at or below it with a warp reduction, then 16-byte copies), bound by
the bytes it writes, B·M·(H+8)·4; K1b a segment-sum that cuts every
phoneme into pieces of at most 12 frames, read by 4-lane groups over
16-channel slices (the tracks one or two more) and combined in piece order,
bound by the bytes it reads, at most B·M·(H+8)·4.  See the source notes.
K1's result is a copy, so it is bit-equal to `lr_fused_plain`; K1b sums in
a fixed order without atomics, so its bits repeat from launch to launch.

`ops.length_regulator.LRFused` joins the two in a ``torch.autograd.Function``
(the counterpart of ``_lr_fused`` with its ``custom_vjp``); CPU tensors
take the plain versions through the same Function.
"""

from __future__ import annotations

import ctypes

import torch

from spev_tpu_torch.ops.cuda import build

N_TRACKS = 8  # variance tracks, zero-padded to 8 lanes
# K1's warp for each frame reads all of ends[b, :T], 128 a pass (K1b reads
# two); far above any phoneme bucket, it keeps that scan to 96 passes
_MAX_PHONEMES = 12288


def _frame_phoneme(ends: torch.Tensor, max_frames: int):
    """(idx (B, M) int64, valid (B, M) bool): frame j's phoneme
    ``min(#{t : ends[t] <= j}, T-1)`` and whether ``j < ends[:, -1]``."""
    B, T = ends.shape
    j = torch.arange(max_frames, dtype=torch.int32, device=ends.device)
    idx = torch.searchsorted(ends, j.expand(B, -1).contiguous(), right=True).clamp_max(T - 1)
    return idx, j[None, :] < ends[:, -1:]


def expand_by_ends(ends: torch.Tensor, max_frames: int, *tensors: torch.Tensor):
    """Plain frame expansion by int32 frame ends (B, T): frame j takes row
    ``min(#{t : ends[t] <= j}, T-1)`` of each (B, T, C) tensor, and zeros
    where ``j >= ends[:, -1]``.  Returns one (B, M, C) tensor per input."""
    idx, valid = _frame_phoneme(ends, max_frames)
    rows = torch.arange(ends.shape[0], device=ends.device)[:, None]
    return tuple(torch.where(valid[..., None], t[rows, idx], t.new_zeros(())) for t in tensors)


def lr_fused_plain(x: torch.Tensor, fpad: torch.Tensor, ends: torch.Tensor,
                   max_frames: int):
    """Plain PyTorch version of K1: a searchsorted frame→phoneme map and an index."""
    return expand_by_ends(ends, max_frames, x, fpad)


def lr_fused_bwd_plain(gx: torch.Tensor, gf: torch.Tensor, ends: torch.Tensor, T: int):
    """Plain PyTorch version of K1b: each frame's cotangent ``index_add_``-ed
    into its phoneme's row, frames past the row's total into a spare row
    that is dropped (no data-dependent shapes, so a CUDA graph can hold it).
    The sums run in float64 and are rounded once, so the result does not
    depend on the order of the card's atomic adds and sits within float32
    rounding of the exact segment sum: the kernel's own rounding is all a
    comparison with it sees.  gx (B, M, H), gf (B, M, 8) → ((B, T, H),
    (B, T, 8)) float32."""
    B, M, H = gx.shape
    idx, valid = _frame_phoneme(ends, M)
    rows = idx + T * torch.arange(B, device=ends.device)[:, None]
    dst = torch.where(valid, rows, B * T).reshape(-1)

    def segment_sum(g):
        C = g.shape[-1]
        out = torch.zeros((B * T + 1, C), dtype=torch.float64, device=g.device)
        out.index_add_(0, dst, g.reshape(B * M, C).to(torch.float64))
        return out[:-1].view(B, T, C).to(torch.float32)

    return segment_sum(gx), segment_sum(gf)


def _lib() -> ctypes.CDLL:
    lib = build.load("length_regulator")
    for fn in (lib.lr_fused_forward, lib.lr_fused_backward):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _vec_rows(H: int, *tensors: torch.Tensor) -> bool:
    """Whether K1 and K1b take their 16-byte bodies: H % 4 == 0 and every
    float tensor 16-byte aligned, so that every row of H (and of 8) floats is."""
    return H % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(name: str, fn, ends, a, b, out_a, out_b, B, T, H, M) -> None:
    """Launch one of the two kernels on the current stream and raise on a
    refused launch.  16-byte accesses when every float row is aligned."""
    ptrs = (ends.data_ptr(), a.data_ptr(), b.data_ptr(), out_a.data_ptr(), out_b.data_ptr())
    vec = int(_vec_rows(H, a, b, out_a, out_b))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(*ptrs, B, T, H, M, vec, stream)
    build.check(rc, name)


def _check_card(name: str, tensors, B: int, T: int, H: int, M: int) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not (1 <= B <= 65535 and 1 <= T <= _MAX_PHONEMES and H >= 1 and M >= 1):
        raise ValueError(f"{name}: unsupported sizes B={B} T={T} H={H} M={M}")


def lr_fused_bwd(gx: torch.Tensor, gf: torch.Tensor, ends: torch.Tensor, T: int):
    """Segment-sum the frame cotangents gx (B, M, H) f32 and gf (B, M, 8)
    f32 into their phonemes by int32 frame ends (B, T) → ((B, T, H),
    (B, T, 8)).  CPU tensors take `lr_fused_bwd_plain`; CUDA tensors launch
    K1b (counted in ``lr_fused_bwd.launches``) or raise."""
    if gx.dim() != 3 or gf.dim() != 3 or ends.dim() != 2:
        raise ValueError("lr_fused_bwd: expected gx (B,M,H), gf (B,M,8), ends (B,T)")
    B, M, H = gx.shape
    if gf.shape != (B, M, N_TRACKS) or ends.shape != (B, T):
        raise ValueError(f"lr_fused_bwd: shapes {tuple(gx.shape)}, {tuple(gf.shape)}, "
                         f"{tuple(ends.shape)} do not agree with T={T}")
    if gx.dtype != torch.float32 or gf.dtype != torch.float32 or ends.dtype != torch.int32:
        raise TypeError("lr_fused_bwd: gx and gf must be float32 and ends int32")
    if not (gx.device == gf.device == ends.device):
        raise ValueError("lr_fused_bwd: inputs lie on different devices")
    if gx.device.type == "cpu":
        return lr_fused_bwd_plain(gx, gf, ends, T)
    _check_card("lr_fused_bwd", (gx, gf, ends), B, T, H, M)
    gxout = torch.empty((B, T, H), dtype=torch.float32, device=gx.device)
    gfout = torch.empty((B, T, N_TRACKS), dtype=torch.float32, device=gx.device)
    _launch("lr_fused_bwd", _lib().lr_fused_backward, ends, gx, gf, gxout, gfout, B, T, H, M)
    lr_fused_bwd.launches += 1
    return gxout, gfout


lr_fused_bwd.launches = 0


def lr_fused(x: torch.Tensor, fpad: torch.Tensor, ends: torch.Tensor, max_frames: int):
    """Expand x (B, T, H) f32 and fpad (B, T, 8) f32 by int32 frame ends
    (B, T) to ((B, M, H), (B, M, 8)).  CPU tensors take `lr_fused_plain`;
    CUDA tensors launch K1 (counted in ``lr_fused.launches``) or raise.  Not
    differentiable by itself: `ops.length_regulator.LRFused` pairs it with
    `lr_fused_bwd`."""
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
    _check_card("lr_fused", (x, fpad, ends), B, T, H, M)
    xout = torch.empty((B, M, H), dtype=torch.float32, device=x.device)
    fout = torch.empty((B, M, N_TRACKS), dtype=torch.float32, device=x.device)
    _launch("lr_fused", _lib().lr_fused_forward, ends, x, fpad, xout, fout, B, T, H, M)
    lr_fused.launches += 1
    return xout, fout


lr_fused.launches = 0
