"""The index arithmetic and summation orders of K1b (length-regulation
backward) and K3 (overlap-add), mirrored in float32 numpy on the CPU, and the
wrappers' choice between their 16-byte and scalar bodies.

K1b (spev_tpu_torch/csrc/length_regulator.cu): each block takes 32 phonemes
of a row; each phoneme is cut into pieces of at most 12 frames; a round gives
each of 32 lane groups one piece, found by counting the phonemes whose
pieces end at or before it; a piece's frames are summed in order, and a
phoneme of several pieces sums them in piece order through shared memory,
carrying a partial from one round to the next.  The mirror runs that
schedule and is held within 1e-5 of `lr_fused_bwd_plain` (float64, rounded
once) with the cotangents scaled by a power of two so that the plain
result's max |.| is near 1, as `chip_smoke.py` holds the kernel.

K3 (spev_tpu_torch/csrc/overlap_add.cu): row and sample group from the
block and grid, the k contributions and window squares in the order
d = 0..k-1; bit-equal to `overlap_add_plain`.
"""

import math

import numpy as np
import pytest
import torch

from spev_tpu_torch.ops.cuda.kernels import _ola_vec, overlap_add, overlap_add_plain
from spev_tpu_torch.ops.cuda.length_regulator_kernel import (N_TRACKS, _vec_rows,
                                                             lr_fused_bwd_plain)
from spev_tpu_torch.ops.length_regulator import regulate_lengths
from spev_tpu_torch.ops.stft import hann_window

# K1b's constants (length_regulator.cu): phonemes a block, lane groups (and
# so pieces) a round, frames a piece, V's a lane group covers
PHONEMES, GROUPS, PIECE, SLICE = 32, 32, 12, 4


def _k1b_mirror(g: np.ndarray, ends: np.ndarray, T: int) -> np.ndarray:
    """K1b's schedule over the channels of g (B, M, C) float32 at once:
    (B, T, C) float32, every row written exactly once."""
    B, M, C = g.shape
    out = np.full((B, T, C), np.nan, np.float32)
    written = np.zeros((B, T), np.int64)
    zero = np.zeros(C, np.float32)
    for b in range(B):
        for t0 in range(0, T, PHONEMES):
            t = np.arange(t0, t0 + PHONEMES)
            e = ends[b]
            stop = np.where(t < T, np.minimum(e[np.minimum(t, T - 1)], M), 0)
            prev = np.where(t > 0, e[np.clip(t - 1, 0, T - 1)], 0)
            start = np.where(t < T, np.minimum(prev, stop), 0)
            n = (stop - start + PIECE - 1) // PIECE
            end = np.cumsum(n)
            pieces = int(end[-1])
            combine = bool((n > 1).any())
            for p in range(PHONEMES):  # no frame: exact zeros
                if n[p] == 0 and t0 + p < T:
                    out[b, t0 + p] = zero
                    written[b, t0 + p] += 1
            carry = [None, None]
            for r0 in range(0, pieces, GROUPS):
                slot, work = {}, []
                for grp in range(GROUPS):
                    k = r0 + grp
                    if k >= pieces:
                        continue
                    p = int((end <= k).sum())
                    first = int(end[p] - n[p])
                    j0 = int(start[p]) + (k - first) * PIECE
                    nj = min(PIECE, int(stop[p]) - j0)
                    assert 1 <= nj and 0 <= j0 and j0 + nj <= min(e[-1], M)
                    acc = g[b, j0]
                    for i in range(1, PIECE):  # the kernel adds zeros past nj
                        acc = acc + (g[b, j0 + i] if i < nj else zero)
                    if end[p] - first == 1:
                        out[b, t0 + p] = acc
                        written[b, t0 + p] += 1
                    else:
                        assert combine
                        slot[grp] = acc
                        work.append((k, p, first))
                rnd = r0 // GROUPS
                for k, p, first in work:  # after the barrier
                    last = min(int(end[p]), r0 + GROUPS) - 1
                    if k != last:
                        continue
                    carried = first < r0
                    s = carry[rnd & 1] if carried else slot[first - r0]
                    for kk in range(r0 if carried else first + 1, last + 1):
                        s = s + slot[kk - r0]
                    if end[p] > r0 + GROUPS:
                        carry[(rnd + 1) & 1] = s
                    else:
                        out[b, t0 + p] = s
                        written[b, t0 + p] += 1
    assert (written == 1).all()
    return out


def _durations(kind: str, B: int, T: int, rng) -> np.ndarray:
    d = rng.integers(1, 13, (B, T)).astype(np.float32)
    if kind == "guard":       # one phoneme a row at the 1000-frame guard
        d[:, 3] = 1000.0
    elif kind == "silence":   # 200-frame silences at each row's start and end
        d[:, 0] = 200.0
        d[:, -1] = 200.0
    elif kind == "edges":
        d[0, ::3] = 0.0       # zero-duration phonemes
        d[1, 5] = np.nan
        d[1, 9] = np.inf
        d[1, 12] = -3.0
        d[1, 20] = 1001.0     # past the guard: 0
        d[2, :] = 0.0         # all-zero row
        d[3, :] = 40.0        # saturates the bucket
    return d


@pytest.mark.parametrize("kind,B,T,M", [("guard", 2, 40, 1024), ("silence", 2, 70, 1024),
                                        ("edges", 4, 37, 256), ("plain", 3, 64, 256)])
def test_k1b_schedule_within_1e5_of_plain(kind, B, T, M):
    rng = np.random.default_rng(11)
    ends, _ = regulate_lengths(torch.from_numpy(_durations(kind, B, T, rng)))
    H = 12
    gx = torch.from_numpy(rng.standard_normal((B, M, H)).astype(np.float32))
    gf = torch.from_numpy(rng.standard_normal((B, M, N_TRACKS)).astype(np.float32))
    # unit scale: a power of two (exact in float32) bringing the plain max |.| near 1
    scaled = []
    for t, r in zip((gx, gf), lr_fused_bwd_plain(gx, gf, ends, T)):
        scaled.append(t * 2.0 ** -round(math.log2(r.abs().max().item())))
    ref = torch.cat(lr_fused_bwd_plain(*scaled, ends, T), dim=-1).numpy()
    got = _k1b_mirror(torch.cat(scaled, dim=-1).numpy(), ends.numpy(), T)
    assert 0.5 <= np.abs(ref).max() < 4.0
    assert np.abs(got - ref).max() <= 1e-5
    rows_zero = (ref == 0).all(-1)
    assert (got[rows_zero] == 0).all()  # zero-duration phonemes, all-zero rows, past the bucket


@pytest.mark.parametrize("H,vec", [(256, True), (256, False), (250, False), (4, True)])
def test_k1b_slices_cover_every_column(H, vec):
    """The launcher's channel slices (gx's, then gf's) cover each of the H
    gx columns and the 8 gf columns exactly once, in float4 and in float."""
    per = 4 if vec else 1
    hv, fv = H // per, N_TRACKS // per
    gx_slices = -(-hv // SLICE)
    slices = gx_slices + -(-fv // SLICE)
    cover = {False: np.zeros(H, np.int64), True: np.zeros(N_TRACKS, np.int64)}
    for s in range(slices):
        tracks = s >= gx_slices
        for c in range(SLICE):
            col = ((s - gx_slices) if tracks else s) * SLICE + c
            if col < (fv if tracks else hv):
                cover[tracks][col * per:(col + 1) * per] += 1
    assert (cover[False] == 1).all() and (cover[True] == 1).all()


def _k3_mirror(frames: np.ndarray, window: np.ndarray, hop: int) -> np.ndarray:
    """K3 over its launch: the vector body for (n_fft, hop) in {(1024, 256),
    (512, 128)} (128-thread blocks, hop/4 threads a row, four samples a
    thread), the scalar body otherwise (64 threads a row, one sample a
    thread, the grid's y striding the row); each sample summed over
    d = 0..k-1 where 0 <= r-d < T.  Every output sample is written exactly
    once."""
    T, n_fft = frames.shape
    k = n_fft // hop
    rows = T + k - 1
    if (n_fft, hop) in ((1024, 256), (512, 128)):
        per_thread, bx, gy = 4, hop // 4, 1
        by = 128 // bx
    else:
        per_thread, bx, by = 1, 64, 4
        gy = min(-(-hop // 64), 65535)
    width = hop // per_thread  # threads a row
    wsq = (window * window).astype(np.float32)
    out = np.full((rows, hop), np.nan, np.float32)
    written = np.zeros((rows, hop), np.int64)
    for block_x in range(-(-rows // by)):
        for ty in range(by):
            r = block_x * by + ty
            if r >= rows:
                continue
            q = (np.arange(bx)[None, :] + bx * np.arange(gy)[:, None]).reshape(-1)
            q = np.concatenate([q + i * gy * bx for i in range(-(-width // (gy * bx)))])
            q = q[q < width]
            cols = (per_thread * q[:, None] + np.arange(per_thread)).reshape(-1)
            acc = np.zeros(cols.shape, np.float32)
            ws = np.zeros(cols.shape, np.float32)
            for d in range(k):
                if 0 <= r - d < T:
                    acc = acc + frames[r - d, d * hop + cols]
                    ws = ws + wsq[d * hop + cols]
            out[r, cols] = acc / np.maximum(ws, np.float32(1e-8))
            written[r, cols] += 1
    assert (written == 1).all()
    return out.reshape(-1)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 128), (800, 200)])
@pytest.mark.parametrize("T", [1, 2, 3, 40])
def test_k3_schedule_bit_equal_to_plain(n_fft, hop, T):
    rng = np.random.default_rng(T * 7 + n_fft)
    window = hann_window(n_fft).astype(np.float32)
    frames = (rng.standard_normal((T, n_fft)).astype(np.float32) * window).astype(np.float32)
    ref = overlap_add_plain(torch.from_numpy(frames), torch.from_numpy(window), hop).numpy()
    got = _k3_mirror(frames, window, hop)
    assert got.shape == ref.shape == (n_fft + hop * (T - 1),)
    assert np.array_equal(got, ref)
    # the CPU wrapper is the plain version, so the two agree bit for bit
    assert torch.equal(overlap_add(torch.from_numpy(frames), torch.from_numpy(window), hop),
                       torch.from_numpy(ref))


def test_vector_or_scalar_body():
    frames = torch.zeros(8, 1024)
    window = torch.zeros(1024)
    out = torch.zeros(1024 + 256 * 7)
    assert _ola_vec(1024, 256, frames, window, out)
    assert _ola_vec(512, 128, torch.zeros(4, 512), torch.zeros(512), torch.zeros(896))
    shifted = torch.zeros(8 * 1024 + 1)[1:].view(8, 1024)  # storage offset of one float
    assert shifted.is_contiguous() and not _ola_vec(1024, 256, shifted, window, out)
    # (hop, k) not fixed at compile time: the scalar body
    assert not _ola_vec(800, 200, torch.zeros(4, 800), torch.zeros(800), torch.zeros(1400))
    assert not _ola_vec(1024, 512, frames, window, out)

    gx, gf = torch.zeros(2, 16, 256), torch.zeros(2, 16, N_TRACKS)
    assert _vec_rows(256, gx, gf)
    assert not _vec_rows(250, torch.zeros(2, 16, 250), gf)
    assert not _vec_rows(256, torch.zeros(2 * 16 * 256 + 1)[1:].view(2, 16, 256), gf)
