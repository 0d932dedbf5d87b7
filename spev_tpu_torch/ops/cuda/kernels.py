"""K3: windowed-frame overlap-add — wrapper, plain version and launch count.

Counterpart of ``spev_tpu/ops/pallas/kernels.py`` (``overlap_add`` →
``_ola_kernel``): the inverse-STFT frames (T, n_fft), already multiplied by
the synthesis window, are overlap-added at ``hop`` and each sample divided
by ``max(Σ window², 1e-8)`` over the same frames (COLA normalisation).

On the card this is the CUDA kernel in ``spev_tpu_torch/csrc/
overlap_add.cu``: one thread per output sample, the k = n_fft/hop
contributions summed in the fixed order d = 0..k-1 with the window-square
sum taken in the same loop.  It is bound by the bytes it moves (frames read
once, output written once) against the card's 3.35 TB/s; see the source note.
"""

from __future__ import annotations

import ctypes

import torch

from spev_tpu_torch.ops.cuda import build


def overlap_add_plain(frames: torch.Tensor, window: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Plain PyTorch version: k shifted slice-adds in the kernel's order."""
    T, n_fft = frames.shape
    k = n_fft // hop_length
    acc = frames.new_zeros((T + k - 1, hop_length))
    wsq = frames.new_zeros((T + k - 1, hop_length))
    w2 = window * window
    for d in range(k):
        cols = slice(d * hop_length, (d + 1) * hop_length)
        acc[d : d + T] += frames[:, cols]
        wsq[d : d + T] += w2[cols]
    return (acc / wsq.clamp_min(1e-8)).reshape(-1)


def _lib() -> ctypes.CDLL:
    lib = build.load("overlap_add")
    fn = lib.overlap_add_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def overlap_add(frames: torch.Tensor, window: torch.Tensor, hop_length: int) -> torch.Tensor:
    """frames (T, n_fft) f32, window (n_fft,) f32 → signal of length
    n_fft + hop·(T-1).  CPU tensors take `overlap_add_plain`; CUDA tensors
    launch K3 (counted in ``overlap_add.launches``) or raise."""
    if frames.dim() != 2 or window.dim() != 1 or window.shape[0] != frames.shape[1]:
        raise ValueError("overlap_add: expected frames (T, n_fft) and window (n_fft,)")
    T, n_fft = frames.shape
    hop = int(hop_length)
    if hop < 1 or n_fft % hop != 0 or T < 1:
        raise ValueError(f"overlap_add: need T >= 1 and hop | n_fft (T={T}, n_fft={n_fft}, hop={hop})")
    if frames.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("overlap_add: frames and window must be float32")
    if frames.device != window.device:
        raise ValueError("overlap_add: inputs lie on different devices")
    if frames.device.type == "cpu":
        return overlap_add_plain(frames, window, hop)
    if frames.device.type != "cuda":
        raise ValueError(f"overlap_add: unsupported device {frames.device}")
    if not (frames.is_contiguous() and window.is_contiguous()):
        raise ValueError("overlap_add: inputs must be contiguous")
    out_len = n_fft + hop * (T - 1)
    if T * n_fft >= 2**31:
        raise ValueError(f"overlap_add: {T} frames of {n_fft} exceed the kernel's int indexing")
    out = torch.empty((out_len,), dtype=torch.float32, device=frames.device)
    lib = _lib()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.overlap_add_forward(frames.data_ptr(), window.data_ptr(), out.data_ptr(),
                                     T, n_fft, hop, stream)
    build.check(rc, "overlap_add")
    overlap_add.launches += 1
    return out


overlap_add.launches = 0
