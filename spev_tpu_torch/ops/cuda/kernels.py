"""K2 (fused log-mel) and K3 (windowed-frame overlap-add): wrappers, plain
versions and launch counts.  Counterpart of ``spev_tpu/ops/pallas/kernels.py``.

K2 (``fused_log_mel`` → ``_mel_kernel``): reflect-pad by n_fft/2, frame at
hop, Hann window, rDFT as two fp32 products against the cos/sin bases,
power, slaney mel product, ``clip(log(max(mel, floor)), clip_min,
clip_max)``; (n_mels, 1 + len(y)//hop).  On the card it is
``spev_tpu_torch/csrc/log_mel.cu``: for a power-of-two n_fft a block takes
1-4 frames, stages its span of y (reflect padding by index arithmetic) and
its tables in shared memory with one batch of cp.async copies, runs a real
FFT of n_fft there (Stockham radix-8/4/2 passes on n_fft/2 complex points,
twiddles from `ops.stft.fft_twiddles`) and sums each mel band over its
nonzero bins only (`ops.stft.mel_band_ranges`, taps from
`ops.stft.mel_taps_by_parity`); any other n_fft takes the dense body
(8-frame tiles, one thread per bin, fmaf chains against cos/sin bases).
Every sum has a fixed order.  Its bound is the function's least work, an
FFT per frame and the filterbank's nonzero taps (~30 kflop a frame at n_fft
1024, against the card's fp32 rate); see the source note.

K3 (``overlap_add`` → ``_ola_kernel``): the inverse-STFT frames (T, n_fft),
already multiplied by the synthesis window, are overlap-added at ``hop`` and
each sample divided by ``max(Σ window², 1e-8)`` over the same frames (COLA
normalisation).  On the card this is ``spev_tpu_torch/csrc/overlap_add.cu``:
each thread takes four consecutive samples of one output row (16-byte loads
and stores), row and offset from the grid, (hop, k) fixed at compile time
for the configurations' (n_fft, hop) = (1024, 256) and (512, 128), every
load issued before the first add; the k contributions are summed in the
fixed order d = 0..k-1, so the result is bit-equal to `overlap_add_plain`.
A scalar body takes any other (n_fft, hop) and unaligned pointers
(`_ola_vec` decides).  It is bound by the bytes it moves (frames read once,
output written once) against the card's 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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


def _ola_vec(n_fft: int, hop: int, *tensors: torch.Tensor) -> bool:
    """Whether K3 takes its vector body, four samples a thread with 16-byte
    accesses and (hop, k) fixed at compile time: (n_fft, hop) is (1024, 256)
    or (512, 128), and every pointer is 16-byte aligned."""
    return ((n_fft, hop) in ((1024, 256), (512, 128))
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _lib() -> ctypes.CDLL:
    lib = build.load("overlap_add")
    fn = lib.overlap_add_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    vec = int(_ola_vec(n_fft, hop, frames, window, out))
    lib = _lib()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.overlap_add_forward(frames.data_ptr(), window.data_ptr(), out.data_ptr(),
                                     T, n_fft, hop, vec, stream)
    build.check(rc, "overlap_add")
    overlap_add.launches += 1
    return out


overlap_add.launches = 0


def _log_mel_constants(sr, n_fft, n_mels, fmin, fmax, device):
    """Window, cos/sin bases (n_fft, n_freqs) and filterbank (n_mels,
    n_freqs) on ``device``, made once (``ops.stft.device_constant``)."""
    from spev_tpu_torch.ops import stft

    return (stft.device_constant(stft.hann_window, n_fft, device=device),
            stft.device_constant(stft._dft_cos, n_fft, device=device),
            stft.device_constant(stft._dft_sin, n_fft, device=device),
            stft.device_constant(stft.mel_filterbank, sr, n_fft, n_mels, fmin, fmax,
                                 device=device))


def fused_log_mel_plain(y: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                        hop_length: int = 256, n_mels: int = 80, fmin: float = 0.0,
                        fmax: float = 8000.0, floor: float = 1e-5, clip_min: float = -10.0,
                        clip_max: float = 2.0) -> torch.Tensor:
    """Plain PyTorch version of K2: the same steps as torch ops on the same
    float32 windowed frames and constants, evaluated in float64 and rounded
    to float32 once.  In frames where a loud stretch meets near-silence, a
    float32 evaluation of the quiet mel bands is off by up to ~1.4e-4 in the
    log (K2's own chains; another float32 order lands elsewhere), so an
    exact oracle lets the comparison see only the kernel's rounding."""
    win, cos_b, sin_b, fb = _log_mel_constants(sr, n_fft, n_mels, fmin, fmax, y.device)
    padded = F.pad(y[None], (n_fft // 2, n_fft // 2), mode="reflect")[0]
    frames = (padded.unfold(0, n_fft, hop_length) * win[None, :]).double()
    re = frames @ cos_b.double()
    im = frames @ sin_b.double()
    mel = (re * re + im * im) @ fb.double().T
    out = torch.clamp(torch.log(torch.clamp_min(mel, floor)), clip_min, clip_max)
    return out.T.float().contiguous()


def _log_mel_lib() -> ctypes.CDLL:
    lib = build.load("log_mel")
    lib.log_mel_forward.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                                    + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                                    + [ctypes.c_void_p])
    lib.log_mel_dense_forward.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                                          + [ctypes.c_void_p])
    lib.log_mel_forward.restype = lib.log_mel_dense_forward.restype = ctypes.c_int
    return lib


def fused_log_mel(y: torch.Tensor, sr: int = 22050, n_fft: int = 1024, hop_length: int = 256,
                  n_mels: int = 80, fmin: float = 0.0, fmax: float = 8000.0,
                  floor: float = 1e-5, clip_min: float = -10.0,
                  clip_max: float = 2.0) -> torch.Tensor:
    """Log-mel spectrogram of a 1-D float32 signal, (n_mels, 1 + len(y)//hop).
    CPU tensors take `fused_log_mel_plain`; CUDA tensors launch K2 (counted
    in ``fused_log_mel.launches``) or raise: its FFT body for a power-of-two
    n_fft (and fmin < fmax), its dense body otherwise."""
    if y.dim() != 1:
        raise ValueError(f"fused_log_mel: expected a 1-D signal, got shape {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError("fused_log_mel: the signal must be float32")
    hop = int(hop_length)
    n_freqs = n_fft // 2 + 1
    if hop < 1 or n_fft % 4 != 0 or n_freqs > 576 or n_mels < 1:
        raise ValueError(f"fused_log_mel: need hop >= 1, n_fft a multiple of 4 up to 1148 "
                         f"and n_mels >= 1 (hop={hop}, n_fft={n_fft}, n_mels={n_mels})")
    if y.shape[0] <= n_fft // 2:
        raise ValueError(f"fused_log_mel: {y.shape[0]} samples are too few to reflect-pad "
                         f"by {n_fft // 2}")
    if y.device.type == "cpu":
        return fused_log_mel_plain(y, sr, n_fft, hop, n_mels, fmin, fmax, floor, clip_min,
                                   clip_max)
    if y.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device {y.device}")
    if not y.is_contiguous():
        raise ValueError("fused_log_mel: the signal must be contiguous")
    n_frames = 1 + y.shape[0] // hop
    if (y.shape[0] + n_fft >= 2**31 or n_frames * n_fft >= 2**31
            or n_frames * n_mels >= 2**31):
        raise ValueError(f"fused_log_mel: {n_frames} frames exceed the kernel's int indexing")
    from spev_tpu_torch.ops import stft

    dev = y.device
    out = torch.empty((n_mels, n_frames), dtype=torch.float32, device=dev)
    lib = _log_mel_lib()
    scalars = (float(floor), float(clip_min), float(clip_max))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the FFT body; its taps table needs fmin < fmax (slaney triangles)
        if n_fft & (n_fft - 1) == 0 and fmin < fmax:
            mel = (sr, n_fft, n_mels, fmin, fmax)
            win = stft.device_constant(stft.hann_window, n_fft, device=dev)
            tw = stft.device_constant(stft.fft_twiddles, n_fft, device=dev)
            bands = stft.device_constant(stft.mel_band_ranges, *mel, device=dev,
                                         dtype=torch.int32)
            taps = stft.device_constant(stft.mel_taps_by_parity, *mel, device=dev)
            rc = lib.log_mel_forward(y.data_ptr(), y.shape[0], win.data_ptr(), tw.data_ptr(),
                                     bands.data_ptr(), taps.data_ptr(), out.data_ptr(),
                                     n_frames, n_fft, hop, n_mels, *scalars, stream)
        else:
            win, cos_b, sin_b, fb = _log_mel_constants(sr, n_fft, n_mels, fmin, fmax, dev)
            rc = lib.log_mel_dense_forward(y.data_ptr(), y.shape[0], win.data_ptr(),
                                           cos_b.data_ptr(), sin_b.data_ptr(), fb.data_ptr(),
                                           out.data_ptr(), n_frames, n_fft, hop, n_freqs,
                                           n_mels, *scalars, stream)
    build.check(rc, "fused_log_mel")
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0
