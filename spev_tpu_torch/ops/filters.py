"""IIR filtering for procedural vocal-event synthesis.  Counterpart of
``spev_tpu.ops.filters``.

Filter design stays on the host (scipy, tiny constant-size math).  Filter
application takes a tensor on any device.  A sequential recurrence would
cost several launches per sample on a GPU (~9k samples for one 0.4 s
inhale), so each transposed-direct-form-II section runs in blocks of
``BLOCK`` samples, written as its state-space form (state s, A, B, C, D;
``y[n] = C s + D x[n]``, ``s ← A s + B x[n]``):

- within a block, the zero-state response is the product with the
  lower-triangular Toeplitz matrix of the impulse response (exact);
- the state entering block b is ``Σ_{c<b} (A^L)^{b-1-c} e_c``, where e_c
  is block c's zero-state end state, the between-block update
  ``s ← A^L s + e``; it is summed by doubling (⌈log2 blocks⌉ steps of
  ``V[d:] += V[:-d] (A^L)^dᵀ``), not block by block;
- its free response ``C A^k s`` is added to each block.

The matrices are built on the host in float64 and applied in float32.
`biquad_plain`, the sequential recurrence, is the oracle the tests use.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

try:  # host-side design only
    from scipy import signal as _scipy_signal
except ImportError:  # pragma: no cover
    _scipy_signal = None

BLOCK = 64


def butter_sos(order: int, cutoff, btype: str = "lowpass", fs: float | None = None) -> np.ndarray:
    """Design a Butterworth filter as second-order sections (host-side)."""
    if _scipy_signal is None:  # pragma: no cover
        raise RuntimeError("scipy is required for filter design")
    return _scipy_signal.butter(order, cutoff, btype=btype, fs=fs, output="sos").astype(np.float32)


def butter_ba(order: int, cutoff, btype: str = "lowpass", fs: float | None = None):
    if _scipy_signal is None:  # pragma: no cover
        raise RuntimeError("scipy is required for filter design")
    b, a = _scipy_signal.butter(order, cutoff, btype=btype, fs=fs)
    return b.astype(np.float32), a.astype(np.float32)


@lru_cache(maxsize=32)
def _block_matrices(b: tuple, a: tuple):
    """Host float64 matrices of the section ``b``/``a`` (a[0] == 1, equal
    lengths N+1): the Toeplitz impulse matrix (L, L), the end-state map
    (N, L), the free-response map (L, N) and A^L."""
    b, a = np.asarray(b, np.float64), np.asarray(a, np.float64)
    N, L = len(a) - 1, BLOCK
    A = np.zeros((N, N))
    A[:, 0] = -a[1:]
    A[np.arange(N - 1), np.arange(1, N)] = 1.0  # the TDF-II shift
    B = b[1:] - a[1:] * b[0]
    C = np.zeros(N)
    C[0] = 1.0
    powers = [np.eye(N)]
    for _ in range(L):
        powers.append(A @ powers[-1])
    h = np.concatenate([[b[0]], [C @ powers[m - 1] @ B for m in range(1, L)]])
    k = np.arange(L)
    toeplitz = np.where(k[:, None] >= k[None, :], h[np.clip(k[:, None] - k[None, :], 0, L - 1)], 0.0)
    end_state = np.stack([powers[L - 1 - j] @ B for j in range(L)], axis=1)
    free = np.stack([C @ powers[m] for m in range(L)])
    return toeplitz, end_state, free, powers[L]


def _filter_blocks(x: torch.Tensor, b, a) -> torch.Tensor:
    """One TDF-II section (``b``, ``a`` normalised, equal lengths) over a
    1-D float32 tensor, in blocks."""
    n = x.shape[0]
    if n == 0:
        return x.clone()
    n_blocks = -(-n // BLOCK)
    toeplitz, end_state, free, P = _block_matrices(tuple(float(v) for v in b),
                                                   tuple(float(v) for v in a))

    def dev(m):
        return torch.as_tensor(m, dtype=torch.float32, device=x.device)

    X = F.pad(x, (0, n_blocks * BLOCK - n)).reshape(n_blocks, BLOCK)
    Y = X @ dev(toeplitz).T  # zero-state response of each block
    V = X @ dev(end_state).T  # zero-state end state e_c, (n_blocks, N)
    d = 1
    while d < n_blocks:  # V[b] ← Σ_{c<=b} (A^L)^{b-c} e_c, P = (A^L)^d
        V = V + F.pad(V[:-d] @ dev(P).T, (0, 0, d, 0))
        P, d = P @ P, 2 * d
    S = F.pad(V[:-1], (0, 0, 1, 0))  # the state entering each block
    Y = Y + S @ dev(free).T
    return Y.reshape(-1)[:n]


def biquad(x: torch.Tensor, b, a) -> torch.Tensor:
    """Single biquad section, b = (b0, b1, b2), a = (a0, a1, a2) with
    a0 == 1, zero initial state."""
    return _filter_blocks(x, np.asarray(b, np.float64)[:3], np.asarray(a, np.float64)[:3])


def sosfilt(sos, x: torch.Tensor) -> torch.Tensor:
    """Cascade of biquad sections (scipy ``sosfilt`` equivalent, zero
    initial conditions)."""
    sos = np.asarray(sos, np.float64)
    y = x
    for section in sos:
        y = biquad(y, section[:3], section[3:])
    return y


def lfilter(b, a, x: torch.Tensor) -> torch.Tensor:
    """Direct-form IIR filter (scipy ``lfilter`` equivalent, zero initial
    conditions): ``b`` and ``a`` are normalised by a[0] and padded to one
    length."""
    b = np.asarray(b, np.float32).astype(np.float64)
    a = np.asarray(a, np.float32).astype(np.float64)
    b, a = b / a[0], a / a[0]
    N = max(len(b), len(a))
    b, a = np.pad(b, (0, N - len(b))), np.pad(a, (0, N - len(a)))
    if N == 1:
        return x * float(b[0])
    return _filter_blocks(x, b, a)


def biquad_plain(x: torch.Tensor, b, a) -> torch.Tensor:
    """The transposed-direct-form-II recurrence, one sample at a time in
    float64 on the host (the tests' oracle for `biquad`)."""
    b0, b1, b2 = (float(v) for v in np.asarray(b, np.float64)[:3])
    a1, a2 = (float(v) for v in np.asarray(a, np.float64)[1:3])
    z1 = z2 = 0.0
    out = np.empty(x.shape[0], np.float64)
    for i, xn in enumerate(x.detach().cpu().double().numpy()):
        yn = b0 * xn + z1
        z1 = b1 * xn - a1 * yn + z2
        z2 = b2 * xn - a2 * yn
        out[i] = yn
    return torch.as_tensor(out, dtype=x.dtype, device=x.device)
