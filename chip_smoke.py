#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises, so the exit code is non-zero:

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``) and build
   every CUDA kernel from ``spev_tpu_torch/csrc`` (one nvcc per source, all
   at once).
2. K1 (fused length regulation) against its plain PyTorch version on the
   card: bit-equal (``torch.equal``) at B=16, T=128, H=256, M ∈ {768, 2048}
   with NaN, zero and all-zero duration rows.
2b. K1b (its backward, a segment-sum) against its plain version: within
   1e-5 with unit-normal cotangents at the same durations, at the same
   shapes and at the training path's (T, M) = (64, 256), (128, 512) and
   (128, 1024), and two launches bit-equal.  Timed beside the plain version and one
   ``index_add`` (never called by the port).
3. K3 (overlap-add) against its plain version: within 1e-5 at T ∈ {256,
   2048} frames.  Kernel, plain version and a library yardstick
   (``torch.gather`` / ``F.fold`` / ``index_add``, never called by the port)
   are timed with CUDA graphs of 20 launches replayed between CUDA events.
3b. K2 (fused log-mel) against its plain version (float64, rounded once):
   within 2e-4 and two launches bit-equal, on the 22050- and 5000-sample signals
   of the kernel tests and on bucketed 1, 4 and 10 s signals (24576, 90112,
   221184 samples), at fmax sr/2 (the dataset's) and 8000.  Timed beside
   its plain version, its bound (an FFT per frame and the filterbank's
   nonzero taps, or the signal's and output's bytes) and a library yardstick
   (``torch.stft`` → |.|² → mel product → log, never called by the port).
4. The full-width serving path through the user's entry points: a reference
   ``.pt`` of a default-config FastSpeech2 (seeded weights, duration bias
   log 7 → 6 frames per phoneme) and an upstream-style HiFi-GAN V1 directory
   (seeded weights) are written to a temporary directory; then 2 ×
   ``synthesize``, one ``synthesize_many`` of 8 texts at batch 4, one request
   through the CLI and one Griffin-Lim request (a Synthesizer with no
   HiFi-GAN).  The launch counts are zeroed just before and read just after:
   K1 must have run once per acoustic pass and K3 33 times for the
   Griffin-Lim request.  The inputs the path gave each kernel are kept, one
   set per distinct shape, and (4b) each kernel is checked against its
   plain version and timed on them, after the counts were read.
5. The card against the CPU: the same request through the port on the CPU
   (plain versions) and on the card (kernels) with TF32 off for matmuls and
   cuDNN: equal mel_len, mel MAE < 1e-4, HiFi-GAN waveform MAE < 1e-4.  The
   process's TF32 settings are restored afterwards: the Trainer sets its own.
6. The training path through the user's entry point: a feature cache of 96
   utterances written with numpy from a seed (the rules G2P's phonemes,
   lengths filling the (64, 256), (128, 512) and (128, 1024) buckets), then
   ``python -m spev_tpu_torch.cli.train`` in-process at the default config,
   batch 16, 2 epochs (1 duration-only), warmup 20 steps.  With the counts
   zeroed just before and read just after, K1 must have run once per
   forward (train and eval) and K1b once per train step's backward; every
   loss is finite.  Then ten steps on one (128, 1024) batch with dropout
   off must lower the loss (their steady-state time, frames per second and
   a one-step profile are printed; the profiled step must run no TF32
   kernel, with the process's cuDNN TF32 flag left at PyTorch's default),
   ``Synthesizer(best.pt)`` must give a
   finite waveform with the model config read from the checkpoint, and
   (6b) K1 and K1b are checked and timed on the inputs the run gave them
   (K1b's cotangents scaled by a power of two, exact in float32, to a
   plain result of max |.| near 1, so that its 1e-5 bar is a real test).
7. One training step, card against CPU, through the Trainer's own path (fp32,
   TF32 off; cuDNN on), at full width, B=2, M=256, dropout off: every ReLU
   conv's output within 1e-5 of its max |z|, then, with the CPU taking the
   card's side of zero at ReLU inputs inside that rounding (counted), loss
   within 1e-5 relative, every gradient within 1e-4 of its max |g|, equal
   skip flags.
8. Feature extraction and the dataset build through the user's entry
   point: a speech-like corpus of 32 wavs written with numpy from a seed
   (1-10 s, a harmonic source with an F0 glide and accents through formant
   resonances, fricative bursts and silences; half with TextGrids, half
   with transcripts; one under 4000 samples, two at 16 kHz), then
   ``python -m spev_tpu_torch.cli.train --data_dir`` in-process at the
   default config for one epoch.  With the counts zeroed just before and
   read just after, K2 must have run once per utterance that reached
   ``full_features`` (31), K1 once per forward and K1b once per backward.
   The cache is checked (finite, durations summing to the mel frames,
   lengths, stats, 31 files in both passes); the pass times, a repeat of
   one 10 s utterance (bit-equal or not, printed) and a profile of its
   ``full_features`` by stage are printed.  (8b) K2 is checked and timed
   on the path's inputs, one per bucket size.
9. Extraction, card against CPU: four of the corpus's utterances (one of
   10 s) built with ``device="cpu"`` and on the card: phonemes, durations
   and lengths equal, mel within 2e-4, per-phoneme targets within 1e-3 on
   99 % of phonemes and within 0.1 on all.
10. The ``{"kernels": [...]}`` line, then as the last line the device line.

It imports only ``spev_tpu_torch``, ``torch``, ``numpy`` and the standard
library, and exits non-zero without a result when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
TEXTS = [
    "Hello there, this is a quick test of the speech system.",
    "The quick brown fox jumps over the lazy dog.",
    "Good morning.",
    "We need to find a new way to bring the music back home tonight.",
    "Why?",
    "She said that the children were playing in the water all day long.",
    "Speech sounds different when you listen very closely.",
    "One two three four five six seven eight nine ten.",
]


def log(*a):
    print(*a, flush=True)


def graph_ms(fn, n=20, reps=10):
    """Device time of one ``fn()``: a CUDA graph of n calls, replayed reps
    times between CUDA events.  Host overhead (Python, ctypes) is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del g
    return ms


def phase1_card_and_build():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    log(card)
    from spev_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"phase 1: built {list(build.SOURCES)} with nvcc {' '.join(build.ARCH_FLAGS)} "
        f"in {time.perf_counter() - t0:.2f} s")
    return card


def _durations(B, T, g):
    d = torch.randint(0, 12, (B, T), generator=g).float()
    d[1, 5] = float("nan")
    d[1, 9] = float("inf")
    d[2, :] = 0.0            # all-zero row: one zero frame
    d[3, ::3] = 0.0          # zero-duration phonemes
    d[4, 7] = -3.0
    d[5, :] = 40.0           # saturates any bucket
    return d


def _k1_case(x, fpad, ends, M):
    """K1 against its plain version (bit-equal) on one set of card inputs,
    then timed beside the plain version and ``torch.gather``."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS, lr_fused, lr_fused_plain

    B, T, H = x.shape
    xo, fo = lr_fused(x, fpad, ends, M)
    xr, fr = lr_fused_plain(x, fpad, ends, M)
    torch.cuda.synchronize()
    if not (torch.equal(xo, xr) and torch.equal(fo, fr)):
        raise AssertionError(f"K1 differs from its plain version at B={B} T={T} H={H} M={M}")
    err = max((xo - xr).abs().max().item(), (fo - fr).abs().max().item())
    j = torch.arange(M, dtype=torch.int32, device=x.device)
    idx = torch.searchsorted(ends, j.expand(B, -1).contiguous(), right=True).clamp_max(T - 1)
    xf = torch.cat([x, fpad], dim=-1)
    idx_full = idx[..., None].expand(B, M, H + N_TRACKS).contiguous()
    return {
        "B": B, "T": T, "H": H, "M": M, "max_abs_err": err,
        "ms": graph_ms(lambda: lr_fused(x, fpad, ends, M)),
        "plain_ms": graph_ms(lambda: lr_fused_plain(x, fpad, ends, M)),
        "library_ms": graph_ms(lambda: torch.gather(xf, 1, idx_full)),
        # ends, x and the tracks read once; both outputs written once
        "bound_ms": (B * T * 4 + B * T * (H + N_TRACKS) * 4 + B * M * (H + N_TRACKS) * 4)
        / HBM_BYTES_PER_S * 1e3,
    }


def _k3_case(frames, win, hop):
    """K3 against its plain version (within 1e-5) on one set of card inputs,
    then timed beside the plain version and ``F.fold``."""
    from spev_tpu_torch.ops.cuda.kernels import overlap_add, overlap_add_plain

    T, n_fft = frames.shape
    out = overlap_add(frames, win, hop)
    ref = overlap_add_plain(frames, win, hop)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"K3 differs from its plain version by {err} at T={T}")
    out_len = n_fft + hop * (T - 1)
    cols = frames.T.contiguous()[None]  # (1, n_fft, T) for F.fold
    return {
        "T": T, "n_fft": n_fft, "hop": hop, "max_abs_err": err,
        "ms": graph_ms(lambda: overlap_add(frames, win, hop)),
        "plain_ms": graph_ms(lambda: overlap_add_plain(frames, win, hop)),
        "library_ms": graph_ms(lambda: torch.nn.functional.fold(
            cols, (1, out_len), (1, n_fft), stride=(1, hop))),
        "bound_ms": (T * n_fft * 4 + n_fft * 4 + out_len * 4) / HBM_BYTES_PER_S * 1e3,
    }


def phase2_k1():
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS
    from spev_tpu_torch.ops.length_regulator import regulate_lengths

    g = torch.Generator().manual_seed(1)
    cases = []
    for B, T, H, M in [(16, 128, 256, 768), (16, 128, 256, 2048)]:
        x = torch.randn(B, T, H, generator=g).cuda()
        fpad = torch.randn(B, T, N_TRACKS, generator=g).cuda()
        fpad[..., 5:] = 0.0
        ends, _ = regulate_lengths(_durations(B, T, g).cuda())
        case = _k1_case(x, fpad, ends.contiguous(), M)
        cases.append(case)
        log("phase 2: K1 bit-equal to plain", json.dumps(case))
    return cases


def _k1b_case(gx, gf, ends, T):
    """K1b against its plain version (within 1e-5) and against itself (two
    launches, equal bits) on one set of card inputs, then timed beside the
    plain version and one ``index_add``.  The bar is absolute, so the
    cotangents must be of unit scale: the check fails when the plain
    result's max |.| is below 1/2."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import (N_TRACKS, lr_fused_bwd,
                                                                 lr_fused_bwd_plain)

    B, M, H = gx.shape
    xo, fo = lr_fused_bwd(gx, gf, ends, T)
    xo2, fo2 = lr_fused_bwd(gx, gf, ends, T)
    xr, fr = lr_fused_bwd_plain(gx, gf, ends, T)
    torch.cuda.synchronize()
    if not (torch.equal(xo, xo2) and torch.equal(fo, fo2)):
        raise AssertionError(f"K1b is not deterministic at B={B} T={T} H={H} M={M}")
    err = max((xo - xr).abs().max().item(), (fo - fr).abs().max().item())
    plain_max = max(xr.abs().max().item(), fr.abs().max().item())
    if not (err <= 1e-5 and plain_max >= 0.5):
        raise AssertionError(f"K1b differs from its plain version by {err} (plain max |.| "
                             f"{plain_max}) at B={B} T={T} M={M}")
    # the library yardstick: one index_add of every frame into its phoneme
    # row (frames past the total into a spare row)
    j = torch.arange(M, dtype=torch.int32, device=gx.device)
    idx = torch.searchsorted(ends, j.expand(B, -1).contiguous(), right=True).clamp_max(T - 1)
    rows = idx + T * torch.arange(B, device=gx.device)[:, None]
    dst = torch.where(j[None, :] < ends[:, -1:], rows, B * T).reshape(-1)
    src = torch.cat([gx, gf], dim=-1).reshape(B * M, H + N_TRACKS)
    zeros = torch.zeros((B * T + 1, H + N_TRACKS), device=gx.device)
    # the frames the data needs (inside each row's total and the bucket)
    # read once, ends read once, both outputs written once
    frames = int(ends[:, -1].clamp(max=M).sum())
    return {
        "B": B, "T": T, "H": H, "M": M, "valid_frames": frames, "max_abs_err": err,
        "plain_max_abs": plain_max, "ms": graph_ms(lambda: lr_fused_bwd(gx, gf, ends, T)),
        "plain_ms": graph_ms(lambda: lr_fused_bwd_plain(gx, gf, ends, T)),
        "library_ms": graph_ms(lambda: zeros.index_add(0, dst, src)),
        "bound_ms": (B * T * 4 + frames * (H + N_TRACKS) * 4 + B * T * (H + N_TRACKS) * 4)
        / HBM_BYTES_PER_S * 1e3,
    }


def phase2b_k1b():
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS
    from spev_tpu_torch.ops.length_regulator import regulate_lengths

    g = torch.Generator().manual_seed(4)
    cases = []
    # the bench shapes, then the training path's (P, M) buckets
    for B, T, H, M in [(16, 128, 256, 768), (16, 128, 256, 2048), (16, 64, 256, 256),
                       (16, 128, 256, 512), (16, 128, 256, 1024)]:
        ends, _ = regulate_lengths(_durations(B, T, g).cuda())
        gx = torch.randn(B, M, H, generator=g).cuda()
        gf = torch.randn(B, M, N_TRACKS, generator=g).cuda()
        case = _k1b_case(gx, gf, ends.contiguous(), T)
        cases.append(case)
        log("phase 2b: K1b within 1e-5 of plain, deterministic", json.dumps(case))
    return cases


def phase3_k3():
    from spev_tpu_torch.ops.stft import hann_window

    g = torch.Generator().manual_seed(2)
    n_fft, hop = 1024, 256
    win = torch.from_numpy(hann_window(n_fft)).cuda()
    cases = []
    for T in (2048, 256):
        frames = (torch.randn(T, n_fft, generator=g).cuda() * win).contiguous()
        case = _k3_case(frames, win, hop)
        cases.append(case)
        log("phase 3: K3 within 1e-5 of plain", json.dumps(case))
    return cases


@contextlib.contextmanager
def _keep_kernel_inputs():
    """While active, the path's calls of K1, K1b, K2 and K3 keep a copy of
    their inputs (positional arguments, keywords), one for each distinct
    shape; the wrappers count launches as before."""
    import spev_tpu_torch.data.dataset as ds_mod
    import spev_tpu_torch.ops.length_regulator as lr_mod
    import spev_tpu_torch.ops.stft as stft_mod

    kept = {"lr_fused": {}, "lr_fused_bwd": {}, "overlap_add": {}, "fused_log_mel": {}}
    sites = [(lr_mod, "lr_fused"), (lr_mod, "lr_fused_bwd"), (stft_mod, "overlap_add"),
             (ds_mod, "fused_log_mel")]
    originals = [getattr(mod, name) for mod, name in sites]

    def keeping(name, fn):
        def call(*args, **kwargs):
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            key += tuple(sorted(kwargs.items()))
            if key not in kept[name]:
                kept[name][key] = (tuple(a.detach().clone() if torch.is_tensor(a) else a
                                         for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return call

    for (mod, name), fn in zip(sites, originals):
        setattr(mod, name, keeping(name, fn))
    try:
        yield kept
    finally:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, fn)


@torch.inference_mode()
def phase4b_main_path_inputs(kept):
    """Each kernel against its plain version on the very inputs the serving
    path gave it in phase 4 (one set per distinct shape), timed as in
    phases 2 and 3.  These launches come after the counts were read."""
    k1, k3 = [], []
    for args, _ in kept["lr_fused"].values():
        case = {**_k1_case(*args), "main_path": True}
        k1.append(case)
        log("phase 4b: K1 bit-equal to plain on main-path inputs", json.dumps(case))
    for args, _ in kept["overlap_add"].values():
        case = {**_k3_case(*args), "main_path": True}
        k3.append(case)
        log("phase 4b: K3 within 1e-5 of plain on main-path inputs", json.dumps(case))
    if not (k1 and k3):
        raise AssertionError("the serving path called no kernel")
    return k1, k3


def _write_checkpoints(tmp):
    """A reference .pt (default ModelConfig, seeded) and an upstream-style
    HiFi-GAN V1 directory (seeded); returns (pt_path, hifigan_dir)."""
    from spev_tpu_torch.config import ModelConfig
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2
    from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import Vocab

    g2p = G2P("rules")
    vocab = Vocab.build({p for t in TEXTS for p in g2p.phonemes(t)})
    model = FastSpeech2.random_init(ModelConfig(vocab_size=len(vocab)), seed=0)
    with torch.no_grad():
        model.duration_predictor.output_norm.bias.fill_(math.log(7.0))
    pt = os.path.join(tmp, "model.pt")
    torch.save({"model": model.state_dict(), "vocab": vocab.symbols, "stats": {}}, pt)
    hdir = os.path.join(tmp, "hifigan")
    os.makedirs(hdir)
    cfg = HiFiGANConfig()
    with open(os.path.join(hdir, "config.json"), "w") as f:
        json.dump({"resblock": cfg.resblock, "upsample_rates": list(cfg.upsample_rates),
                   "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
                   "upsample_initial_channel": cfg.upsample_initial_channel,
                   "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
                   "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
                   "num_mels": cfg.num_mels}, f)
    gen = HiFiGANGenerator.random_init(cfg, seed=1)
    with torch.no_grad():  # rescale N(0, 0.01²) to std 1/√fan_in: a waveform well above zero
        for name, p in gen.named_parameters():
            if name.endswith("weight"):
                p.mul_(1.0 / (0.01 * math.sqrt(p[0].numel())))
    torch.save({"generator": gen.state_dict()}, os.path.join(hdir, "g_00000000"))
    return pt, hdir


def _check_row(wav, mel, hop=256):
    if not (np.isfinite(wav).all() and np.isfinite(mel).all()):
        raise AssertionError("non-finite output")
    if mel.ndim != 2 or mel.shape[1] != 80 or len(wav) != mel.shape[0] * hop:
        raise AssertionError(f"bad shapes: wav {wav.shape}, mel {mel.shape}")


def phase4_serving(pt, hdir, tmp):
    from spev_tpu_torch.cli.infer import main as cli_main
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.kernels import overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused

    synth = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules")
    synth_gl = Synthesizer(pt, hifigan_dir=None, g2p_backend="rules")
    if not (synth.vocoder.is_neural and not synth_gl.vocoder.is_neural):
        raise AssertionError("the HiFi-GAN directory was not picked up")
    if not next(synth.model.parameters()).is_cuda:
        raise AssertionError("the Synthesizer does not run on the card by default")
    # warm-up with the same requests (cuDNN algorithm choice per shape, the
    # allocator), outside the counted run, so the times below are steady state
    for i in (0, 1):
        synth.synthesize(TEXTS[i])
    synth.synthesize_many(TEXTS, batch_size=4)
    synth_gl.synthesize(TEXTS[1])
    torch.cuda.synchronize()

    acoustic_calls = [0]
    orig = Synthesizer._acoustic

    def counted(self, *a, **k):
        acoustic_calls[0] += 1
        return orig(self, *a, **k)

    Synthesizer._acoustic = counted
    timings = {}
    try:
        with _keep_kernel_inputs() as kept:
            lr_fused.launches = 0
            overlap_add.launches = 0
            t = time.perf_counter()
            for i in (0, 1):
                t0 = time.perf_counter()
                wav, mel = synth.synthesize(TEXTS[i])
                timings[f"synthesize_{i}"] = (time.perf_counter() - t0, mel.shape[0])
                _check_row(wav, mel)
            t0 = time.perf_counter()
            rows = synth.synthesize_many(TEXTS, batch_size=4)
            timings["synthesize_many_8_at_4"] = (time.perf_counter() - t0,
                                                 sum(m.shape[0] for _, m in rows))
            for wav, mel in rows:
                _check_row(wav, mel)
            t0 = time.perf_counter()
            out_wav = os.path.join(tmp, "cli.wav")
            if cli_main(["--checkpoint", pt, "--hifigan_dir", hdir, "--text", TEXTS[3],
                         "--output", out_wav]) != 0 or not os.path.getsize(out_wav) > 44:
                raise AssertionError("the CLI did not write a waveform")
            timings["cli_infer"] = (time.perf_counter() - t0, None)
            k3_before = overlap_add.launches
            t0 = time.perf_counter()
            wav, mel = synth_gl.synthesize(TEXTS[1])
            timings["griffin_lim"] = (time.perf_counter() - t0, mel.shape[0])
            _check_row(wav, mel)
            gl_k3 = overlap_add.launches - k3_before
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t
            launches = {"lr_fused": lr_fused.launches, "overlap_add": overlap_add.launches}
    finally:
        Synthesizer._acoustic = orig
    if launches["lr_fused"] != acoustic_calls[0] or acoustic_calls[0] < 6:
        raise AssertionError(f"K1 ran {launches['lr_fused']} times for {acoustic_calls[0]} "
                             "acoustic passes")
    if gl_k3 != 33 or launches["overlap_add"] != 33:
        raise AssertionError(f"K3 ran {launches['overlap_add']} times, {gl_k3} for the "
                             "Griffin-Lim request; expected 33")
    for name, (sec, frames) in timings.items():
        extra = "" if frames is None else (
            f", {frames} frames = {frames * 256 / 22050:.2f} s of audio, "
            f"real-time factor {sec / (frames * 256 / 22050):.4f}")
        log(f"phase 4: {name}: {sec * 1e3:.1f} ms wall{extra}")
    log(f"phase 4: serving path {total_s * 1e3:.1f} ms; acoustic passes {acoustic_calls[0]}; "
        f"launches {json.dumps(launches)}; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    _profile(synth, synth_gl)
    return launches, kept


def _profile(synth, synth_gl):
    """Device time by kernel for one request of each vocoder path (after the
    counted run)."""
    _profile_one("phase 4 profile: synthesize", lambda: synth.synthesize(TEXTS[1]))
    _profile_one("phase 4 profile: griffin_lim", lambda: synth_gl.synthesize(TEXTS[1]))


def _profile_one(name, fn):
    """Busy share = summed kernel time of one ``fn()`` under the profiler /
    the wall time of the same call run without it; the top kernels by device
    time.  Returns the names of the kernels that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f"{name}: no device time recorded (not measured)")
        return []
    busy = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    log(f"{name}: wall {wall_us / 1e3:.2f} ms unprofiled, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall), device ops "
        f"{sum(r[2] for r in rows)}; top: " + "; ".join(
            f"{k[:70]} {t / 1e3:.3f} ms x{c}" for k, t, c in top))
    return [r[0] for r in rows]


def phase5_card_vs_cpu(pt, hdir):
    """The same request on the CPU and on the card with TF32 off for
    matmuls and cuDNN; the process's TF32 settings are restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _card_vs_cpu_request(pt, hdir)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _card_vs_cpu_request(pt, hdir):
    from spev_tpu_torch.infer.synthesis import Synthesizer

    text = TEXTS[2]
    cpu = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules", device="cpu")
    card = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules")
    w_cpu, m_cpu = cpu.synthesize(text)
    w_gpu, m_gpu = card.synthesize(text)
    if m_cpu.shape != m_gpu.shape or w_cpu.shape != w_gpu.shape:
        raise AssertionError(f"mel_len differs: cpu {m_cpu.shape} card {m_gpu.shape}")
    mel_mae = float(np.abs(m_cpu - m_gpu).mean())
    wav_mae = float(np.abs(w_cpu - w_gpu).mean())
    wav_level = float(np.abs(w_cpu).mean())
    log(f"phase 5: card vs CPU (TF32 off): mel_len {m_gpu.shape[0]} equal, "
        f"mel MAE {mel_mae:.3e} (< 1e-4), wav MAE {wav_mae:.3e} (< 1e-4) "
        f"on a waveform of mean |x| {wav_level:.3e}")
    if not (mel_mae < 1e-4 and wav_mae < 1e-4):
        raise AssertionError("the card disagrees with the CPU")
    if not wav_level > 1e-3:
        raise AssertionError("the waveform is too close to zero to compare")


CACHE_BUCKETS = {(64, 256): 32, (128, 512): 32, (128, 1024): 32}


def _write_cache(cache_dir, seed=0):
    """A feature cache in the layout the dataset build writes (metadata.json
    + u_*.npz), from a seed: 96 utterances of 20-120 phonemes of the rules
    G2P's phoneme set, durations 1-12 frames, at most 1024 frames each,
    32 in each of the (64, 256), (128, 512) and (128, 1024) buckets; mel
    targets in [-10, 2]."""
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import SPECIALS, pick_bucket

    g2p = G2P("rules")
    phones = sorted({p for t in TEXTS for p in g2p.phonemes(t)})
    rng = np.random.default_rng(seed)
    left = dict(CACHE_BUCKETS)
    files, lengths = [], []
    os.makedirs(cache_dir)
    for _ in range(200_000):
        if not any(left.values()):
            break
        n = int(rng.integers(20, 121))
        durs = rng.integers(1, int(rng.integers(1, 13)) + 1, n).astype(np.int32)
        T = int(durs.sum())
        key = (pick_bucket(n, (64, 128, 256)), pick_bucket(T, (256, 512, 1024, 2048)))
        if T > 1024 or not left.get(key):
            continue
        left[key] -= 1
        env = rng.uniform(-8.0, -2.0, 80).astype(np.float32)
        mel = np.clip(env[None, :] + rng.standard_normal((T, 80)), -10.0, 2.0)
        name = f"u_{len(files):05d}.npz"
        np.savez(os.path.join(cache_dir, name),
                 phs=np.asarray([phones[k] for k in rng.integers(0, len(phones), n)], object),
                 durs=durs, mel=mel.astype(np.float32),
                 pitch=np.clip(rng.standard_normal(n), -2.5, 2.5).astype(np.float32),
                 energy=np.clip(rng.standard_normal(n), -2.5, 2.5).astype(np.float32),
                 breath=rng.uniform(0.0, 0.8, n).astype(np.float32),
                 rough=rng.uniform(0.0, 1.5, n).astype(np.float32),
                 bright=np.clip(rng.standard_normal(n), -2.5, 2.5).astype(np.float32),
                 nasal=rng.uniform(0.0, 1.0, n).astype(np.float32))
        files.append(name)
        lengths.append((n, T))
    if any(left.values()):
        raise AssertionError(f"the cache's buckets were not filled: {left}")
    meta = {"files": files, "lengths": lengths, "speakers": [],
            "vocab": sorted(set(phones) | set(SPECIALS)),
            "stats": {"p_mean": 5.0, "p_std": 0.3, "e_mean": -3.0, "e_std": 1.0,
                      "c_mean": 7.5, "c_std": 0.5, "frames_per_phoneme": 6.5}}
    with open(os.path.join(cache_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return files


def phase6_training(tmp):
    """The training CLI in-process from a written cache, counted; then ten
    steps on one fixed batch, timed and profiled; then the trained
    checkpoint served."""
    from spev_tpu_torch.cli import train as train_cli
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    cache = os.path.join(tmp, "cache")
    t0 = time.perf_counter()
    _write_cache(cache)
    log(f"phase 6: wrote a {len(os.listdir(cache)) - 1}-utterance cache in "
        f"{time.perf_counter() - t0:.2f} s")

    steps, evals = [], [0]
    orig_train, orig_eval = Trainer.train_step, Trainer.eval_step

    def train_step(self, batch, variance_weight=1.0):
        m = orig_train(self, batch, variance_weight)
        steps.append((tuple(batch["mel"].shape), variance_weight, m))
        return m

    def eval_step(self, batch):
        evals[0] += 1
        return orig_eval(self, batch)

    Trainer.train_step, Trainer.eval_step = train_step, eval_step
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _keep_kernel_inputs() as kept:
            lr_fused.launches = 0
            lr_fused_bwd.launches = 0
            t0 = time.perf_counter()
            rc = train_cli.main(["--cache_dir", cache, "--name", "smoke", "--epochs", "2",
                                 "--batch_size", "16", "--warmup_epochs", "1",
                                 "--warmup_steps", "20"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"lr_fused": lr_fused.launches, "lr_fused_bwd": lr_fused_bwd.launches}
    finally:
        os.chdir(cwd)
        Trainer.train_step, Trainer.eval_step = orig_train, orig_eval
    if rc != 0:
        raise AssertionError(f"the training CLI exited with {rc}")
    if launches["lr_fused"] != len(steps) + evals[0] or launches["lr_fused_bwd"] != len(steps):
        raise AssertionError(f"launches {launches} for {len(steps)} train steps and "
                             f"{evals[0]} eval forwards")
    if not steps or not all(math.isfinite(m["loss"]) and m["skipped"] == 0 for *_, m in steps):
        raise AssertionError("a training loss was not finite")
    shapes = sorted({s for s, *_ in steps})
    log(f"phase 6: training CLI: {len(steps)} train steps at {shapes} (variance weight "
        f"{sorted({vw for _, vw, _ in steps})}), {evals[0]} eval forwards in {run_s:.2f} s; "
        f"launches {json.dumps(launches)}; losses "
        + " ".join(f"{m['loss']:.4f}" for *_, m in steps))
    ckpt = os.path.join(tmp, "checkpoints", "smoke")
    rows = [json.loads(line) for line in open(os.path.join(tmp, "logs", "smoke", "metrics.jsonl"))]
    log("phase 6: metrics.jsonl: " + json.dumps(rows))
    for name in ("last.pt", "best.pt"):
        if not os.path.exists(os.path.join(ckpt, name)):
            raise AssertionError(f"the training run wrote no {name}")

    # ten steps on one fixed (128, 1024) batch, dropout off
    ds = SpevDataset(None, cache_dir=cache)
    vocab = Vocab(ds.vocab)
    batch = next(b for b in BucketBatcher(ds, vocab, batch_size=16).epoch(0)
                 if b["mel"].shape[1] == 1024 and b["ids"].shape[1] == 128)
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=0.0, vp_dropout=0.0),
                     train=TrainConfig(warmup_steps=20))
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "fixed"),
                      log_dir=os.path.join(tmp, "fixed"))
    tb = trainer.to_device(batch)
    losses, times = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        m = trainer.train_step(tb)  # reads the step's metrics: ends synchronised
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ten steps on one batch did not lower the loss: {losses}")
    step_s = float(np.mean(times[2:]))
    frames = int(batch["mel_lens"].sum())
    log(f"phase 6: fixed batch B=16 P=128 M=1024 ({frames} target frames), dropout off: "
        f"losses {' '.join(f'{v:.4f}' for v in losses)}; steady-state train step "
        f"{step_s * 1e3:.2f} ms (mean of steps 3-10; min {min(times[2:]) * 1e3:.2f}, "
        f"max {max(times[2:]) * 1e3:.2f}), {frames / step_s:.0f} target frames/s, "
        f"{16 * 1024 / step_s:.0f} bucket frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = _profile_one("phase 6 profile: train_step B=16 P=128 M=1024",
                           lambda: trainer.train_step(tb))
    tf32 = [k for k in kernels if "tf32" in k.lower()]
    log(f"phase 6: process settings cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; TF32 kernels in the "
        f"train step: {len(tf32)} of {len(kernels)}")
    if tf32:
        raise AssertionError(f"the train step ran TF32 kernels: {tf32[:3]}")

    synth = Synthesizer(os.path.join(ckpt, "best.pt"), hifigan_dir=None, g2p_backend="rules")
    if synth.model_cfg.vp_output_norm is not False:
        raise AssertionError("the Synthesizer did not read the model config from best.pt")
    wav, mel = synth.synthesize(TEXTS[0])
    _check_row(wav, mel)
    log(f"phase 6: Synthesizer(best.pt) on the card: {mel.shape[0]} frames, finite "
        f"waveform, model config from the checkpoint (vp_output_norm=False)")
    return launches, kept, {"step_ms": step_s * 1e3, "frames_per_s": frames / step_s}


def _unit_scale(gx, gf, ends, T):
    """gx and gf, each times the power of two that brings the max |.| of its
    plain segment sum nearest 1.  A power of two scales float32 exactly, so
    K1b sees the training run's cotangents bit for bit, only at a scale
    where its absolute 1e-5 bar is a real test.  Returns (gx, gf, the two
    factors)."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused_bwd_plain

    out, factors = [], []
    for t, r in zip((gx, gf), lr_fused_bwd_plain(gx, gf, ends, T)):
        m = r.abs().max().item()
        f = 2.0 ** -round(math.log2(m)) if m > 0 else 1.0
        out.append(t * f)
        factors.append(f)
    return out[0], out[1], factors


@torch.inference_mode()
def phase6b_training_inputs(kept):
    """K1 and K1b against their plain versions on the inputs the training
    run gave them (one set per distinct shape), after the counts were read.
    The loss's cotangents reaching K1b are ~1e-7, far below K1b's absolute
    1e-5 bar, so each is first scaled by a power of two (`_unit_scale`)."""
    k1 = [{**_k1_case(*args), "main_path": "training"} for args, _ in kept["lr_fused"].values()]
    k1b = []
    for (gx, gf, ends, T), _ in kept["lr_fused_bwd"].values():
        sgx, sgf, factors = _unit_scale(gx, gf, ends, T)
        k1b.append({**_k1b_case(sgx, sgf, ends, T), "main_path": "training",
                    "scaled_by": factors})
    for c in k1:
        log("phase 6b: K1 bit-equal to plain on training-path inputs", json.dumps(c))
    for c in k1b:
        log("phase 6b: K1b within 1e-5 of plain on training-path inputs at unit scale",
            json.dumps(c))
    if not (k1 and k1b):
        raise AssertionError("the training path called no kernel")
    return k1, k1b


def _relu_convs(model):
    """The convolutions whose output goes through a ReLU, by name: each FFT
    block's conv1 and each variance predictor's conv layers."""
    from spev_tpu_torch.models.modules import Conv1d

    return {n: mod for n, mod in model.named_modules()
            if isinstance(mod, Conv1d) and (n.endswith(".conv1") or "_predictor.layers." in n)}


@contextlib.contextmanager
def _relu_decisions(model, card=None):
    """Without ``card``: records each ReLU conv's output (on the CPU) into
    the dict yielded.  With ``card`` (such a record): compares each output
    with the recorded one (max |diff| / max |z|, into ``"fwd_err"``) and
    moves every element whose sign disagrees to the recorded side of zero,
    the least positive float32 or 0, with its derivative kept, so the ReLU
    passes the recorded device's derivative there (``"flips"`` counts
    them)."""
    convs = _relu_convs(model)
    rec = {"z": {}, "fwd_err": {}, "flips": {}}

    def hook(name):
        def fn(mod, inp, out):
            if card is None:
                rec["z"][name] = out.detach().cpu()
                return None
            z = card["z"][name].to(out.device)
            rec["fwd_err"][name] = ((out.detach() - z).abs().max()
                                    / z.abs().max().clamp_min(1e-30)).item()
            want = z > 0
            flip = want != (out.detach() > 0)
            rec["flips"][name] = int(flip.sum())
            tiny = torch.finfo(out.dtype).tiny
            target = torch.where(want, torch.full_like(out, tiny), torch.zeros_like(out))
            return torch.where(flip, out - out.detach() + target, out)
        return fn

    handles = [mod.register_forward_hook(hook(n)) for n, mod in convs.items()]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


def phase7_train_step_card_vs_cpu(tmp):
    """One full-width training step (B=2, M=256, dropout off) through the
    Trainer's own gradient and update path, on the card (K1, K1b, cuDNN,
    TF32 off as the Trainer sets it) and on the CPU (plain versions).  Every
    ReLU conv's output agrees within 1e-5 of its max |z|.  A ReLU input
    inside that rounding of zero may fall on the other side on the two
    devices and pass another derivative (a 1e-3 difference in a conv
    weight's gradient from one element); the CPU step takes the card's side
    at those elements (counted).  Then the loss agrees within 1e-5
    relative, every gradient within 1e-4 of its max |g|, and the skip flags
    are equal."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import collate
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    ds = SpevDataset(None, cache_dir=os.path.join(tmp, "cache"))
    vocab = Vocab(ds.vocab)
    short = [i for i, (n, t) in enumerate(ds.lengths) if n <= 64 and t <= 256][:2]
    batch = collate([ds.load_utterance(i) for i in short], vocab, 64, 256)
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=0.0, vp_dropout=0.0),
                     train=TrainConfig(batch_size=2, warmup_steps=20))

    def one_step(dev, card=None):
        tr = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "p7"),
                     log_dir=os.path.join(tmp, "p7"), device=dev)
        with _relu_decisions(tr.model, card) as rec:
            loss, _, grads = tr.gradients(tr.to_device(batch), 1.0)
        grads = [g.detach().cpu() for g in grads]
        m = tr.apply_gradients([g.to(tr.device) for g in grads], loss, {})
        names = [n for n, _ in tr.model.named_parameters()]
        return float(loss.detach()), grads, m["skipped"], names, rec

    lg, gg, sg, names, card = one_step("cuda")
    lc, gc, sc, _, rec = one_step("cpu", card)
    rel = abs(lg - lc) / abs(lc)
    errs = sorted(((a - b).abs().max().item() / max(a.abs().max().item(), 1e-30), n)
                  for a, b, n in zip(gc, gg, names))[::-1]
    over = [n for e, n in errs if e > 1e-4]
    fwd = max(rec["fwd_err"].values())
    flips = {n: c for n, c in rec["flips"].items() if c}
    log(f"phase 7: one train step card vs CPU (Trainer fp32: TF32 off; cuDNN on; B=2 P=64 "
        f"M=256): ReLU conv outputs within {fwd:.2e} of their max |z| (< 1e-5) over "
        f"{len(rec['fwd_err'])} convs; ReLU inputs on the other side of zero, the CPU taking "
        f"the card's side: {json.dumps(flips)}; loss {lg:.6f} vs {lc:.6f}, rel {rel:.2e}; "
        f"gradients over 1e-4 of their max |g|: {len(over)}; worst "
        + ", ".join(f"{n} {e:.2e}" for e, n in errs[:4]) + f"; skipped {sg} vs {sc}")
    if over or not (fwd < 1e-5 and rel < 1e-5 and sc == sg
                    and len(rec["fwd_err"]) == len(card["z"]) > 0):
        raise AssertionError(f"the training step disagrees between the card and the CPU: {over}")


def _k2_signal(n, seed):
    """The kernel tests' signal: a 220 Hz tone in noise."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * r.standard_normal(n)).astype(np.float32)


def _k2_case(y, **kw):
    """K2 against its plain version (float64, rounded once: within 2e-4) and
    against itself (two launches, equal bits) on one card signal, then timed
    beside the plain version and ``torch.stft`` → |.|² → mel product →
    log/clip (TF32 off, never called by the port).  The bar is absolute on values in [-10, 2],
    so the check also fails when fewer than a quarter of the plain values
    lie above the clip floor (a speech-like clip with silences and fmax
    sr/2 has about half)."""
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, fused_log_mel_plain
    from spev_tpu_torch.ops.stft import device_constant, mel_filterbank

    kw = {"sr": 22050, "n_fft": 1024, "hop_length": 256, "n_mels": 80, "fmin": 0.0,
          "fmax": 11025.0, "floor": 1e-5, "clip_min": -10.0, "clip_max": 2.0, **kw}
    n_fft, n_mels, hop = kw["n_fft"], kw["n_mels"], kw["hop_length"]
    n_freqs = n_fft // 2 + 1
    out, out2 = fused_log_mel(y, **kw), fused_log_mel(y, **kw)
    ref = fused_log_mel_plain(y, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, out2):
        raise AssertionError(f"K2 is not deterministic at n={y.shape[0]}")
    err = (out - ref).abs().max().item()
    above = (ref > kw["clip_min"]).float().mean().item()
    if not (out.shape == ref.shape == (n_mels, 1 + y.shape[0] // hop) and err <= 2e-4
            and above >= 0.25):
        raise AssertionError(f"K2 differs from its plain version by {err} ({above:.3f} of "
                             f"the values above the floor) at n={y.shape[0]}")
    window = torch.hann_window(n_fft, device=y.device)
    fb = device_constant(mel_filterbank, kw["sr"], n_fft, n_mels, kw["fmin"], kw["fmax"],
                         device=y.device)

    def library():
        spec = torch.stft(y, n_fft, hop, window=window, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.clamp(torch.log(torch.clamp_min(fb @ power, kw["floor"])),
                           kw["clip_min"], kw["clip_max"])

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_err = (library() - ref).abs().max().item()
        library_ms = graph_ms(library)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    T = out.shape[1]
    # The bound is the least work of the function, not of K2's design: per
    # frame the window, a real FFT (2.5·n·log2 n, half a complex FFT's
    # 5·n·log2 n), the power (3 a bin), an FMA per nonzero filterbank tap,
    # and floor, log and clip per mel; the signal read once and the output
    # written once (window and filterbank follow from the arguments).  The
    # dense DFT products that K2 and the Pallas kernel compute are reported
    # beside it as ``dense_gflop``.
    taps = int((fb != 0).sum().item())
    flops = T * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * taps + 3 * n_mels)
    dense_flops = T * (2 * 2 * n_fft * n_freqs + 2 * n_freqs * n_mels)
    nbytes = 4 * (y.shape[0] + n_mels * T)
    bound_s = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return {
        "n": int(y.shape[0]), "fmax": kw["fmax"], "frames": T, "max_abs_err": err,
        "plain_max_abs": ref.abs().max().item(), "above_floor": above,
        "library_max_abs_diff": lib_err, "gflop": flops / 1e9,
        "dense_gflop": dense_flops / 1e9, "mbytes": nbytes / 1e6,
        "ms": graph_ms(lambda: fused_log_mel(y, **kw)),
        "plain_ms": graph_ms(lambda: fused_log_mel_plain(y, **kw)),
        "library_ms": library_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "operations" if flops / FP32_FLOPS_PER_S >= nbytes / HBM_BYTES_PER_S
        else "bytes",
    }


def phase3b_k2():
    cases = []
    # the dataset's bucketed clips first (10 s at fmax sr/2 heads the kernels line)
    for n, seed in [(221184, 5), (90112, 6), (24576, 7), (22050, 0), (5000, 1)]:
        y = torch.from_numpy(_k2_signal(n, seed)).cuda()
        for fmax in (11025.0, 8000.0):
            case = _k2_case(y, fmax=fmax)
            cases.append(case)
            log("phase 3b: K2 within 2e-4 of plain, deterministic", json.dumps(case))
    return cases


PHONES = {"vowel": ["AA1", "AE1", "AH0", "EH1", "IY1", "OW1", "UW1", "ER0"],
          "consonant": ["B", "D", "G", "K", "L", "M", "N", "P", "R", "T", "W"],
          "fricative": ["S", "SH", "F", "TH", "Z", "HH"]}


def _speech_like(rng, n, sr):
    """A speech-like signal of n samples and its segments (start, end, kind):
    a harmonic source with an F0 glide, vibrato and pitch accents through
    four formant resonances, enveloped into syllables, fricative noise
    bursts, and silences."""
    segs, pos = [], int(rng.uniform(0.1, 0.3) * sr)
    segs.append((0, pos, "silence"))
    while pos < n - int(0.3 * sr):
        kind = rng.choice(["syllable", "syllable", "syllable", "fricative", "silence"])
        dur = {"syllable": rng.uniform(0.12, 0.3), "fricative": rng.uniform(0.06, 0.12),
               "silence": rng.uniform(0.05, 0.2)}[kind]
        end = min(n, pos + int(dur * sr))
        segs.append((pos, end, kind))
        pos = end
    segs.append((pos, n, "silence"))
    t = np.arange(n) / sr
    f0 = rng.uniform(95.0, 220.0) * 2 ** (rng.uniform(-0.5, 0.5) * t / t[-1])
    f0 *= 1 + 0.02 * np.sin(2 * np.pi * 5.0 * t)
    for c in rng.uniform(0, t[-1], max(1, int(t[-1] / 1.5))):  # pitch accents
        f0 *= 1 + 0.15 * np.exp(-((t - c) / 0.12) ** 2)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    source = sum(np.sin(h * phase) / h for h in range(1, int(0.45 * sr / f0.max()) + 1))
    freqs = np.fft.rfftfreq(n, 1 / sr)
    formants = [(rng.uniform(500, 800), 90), (rng.uniform(1000, 1800), 110),
                (rng.uniform(2300, 2900), 160), (3500, 250)]
    shape = 0.02 + sum(np.exp(-(((freqs - fc) / bw) ** 2)) / (1 + k)
                       for k, (fc, bw) in enumerate(formants))
    voiced = np.fft.irfft(np.fft.rfft(source) * shape, n)
    noise = rng.standard_normal(n)
    hiss = np.fft.irfft(np.fft.rfft(noise) * (freqs > 3000), n)
    y = 3e-4 * rng.standard_normal(n)
    for a, b, kind in segs:
        if kind == "silence" or b <= a:
            continue
        env = np.sin(np.linspace(0, np.pi, b - a)) ** 2
        if kind == "syllable":
            y[a:b] += rng.uniform(0.3, 1.0) * env * voiced[a:b] / np.abs(voiced).max()
        else:
            y[a:b] += 0.25 * env * hiss[a:b] / np.abs(hiss).max()
    return (0.6 * y / np.abs(y).max()).astype(np.float32), segs


def _textgrid(path, segs, sr, rng):
    """A long-form TextGrid with a phones tier for the segments: silence
    empty, a syllable a consonant and a vowel, a fricative one phone."""
    ivs = []
    for a, b, kind in segs:
        if kind == "syllable":
            cut = a + int(0.3 * (b - a))
            ivs += [(a, cut, rng.choice(PHONES["consonant"])), (cut, b, rng.choice(PHONES["vowel"]))]
        else:
            ivs.append((a, b, "" if kind == "silence" else rng.choice(PHONES["fricative"])))
    end = segs[-1][1] / sr
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {end}", "tiers? <exists>", "size = 1", "item []:", "    item [1]:",
             '        class = "IntervalTier"', '        name = "phones"', "        xmin = 0",
             f"        xmax = {end}", f"        intervals: size = {len(ivs)}"]
    for k, (a, b, mark) in enumerate(ivs, 1):
        lines += [f"        intervals [{k}]:", f"            xmin = {a / sr}",
                  f"            xmax = {b / sr}", f'            text = "{mark}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_corpus(root, tg_dir, seed=0):
    """32 wavs of 1-10 s (triangular around 8 s, as LJSpeech's clips),
    16-bit PCM: file 0 has 3000 samples (skipped by the build), files 1-2 are
    at 16 kHz, file 3 lasts 10 s; even files get a TextGrid, odd ones a
    transcript.  Returns {basename: (samples at 22050 Hz after the build's
    resampling, sample rate)}."""
    from spev_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(root)
    os.makedirs(tg_dir)
    words = " ".join(TEXTS).split()
    info = {}
    for i in range(32):
        sr = 16000 if i in (1, 2) else 22050
        sec = 10.0 if i == 3 else rng.triangular(1.0, 8.0, 10.0)
        n = 3000 if i == 0 else int(sec * sr)
        y, segs = _speech_like(rng, n, sr)
        name = f"clip{i:02d}"
        write_wav(os.path.join(root, f"{name}.wav"), y, sr)
        if i % 2 == 0:
            _textgrid(os.path.join(tg_dir, f"{name}.TextGrid"), segs, sr, rng)
        else:
            k = max(2, int(n / sr * 2))  # about 10 letters a second
            start = int(rng.integers(0, len(words)))
            with open(os.path.join(root, f"{name}.txt"), "w") as f:
                f.write(" ".join(words[(start + j) % len(words)] for j in range(k)))
        info[name] = (int(round(n * 22050 / sr)), sr)
    return info


def _profile_stages(name, fn, labels):
    """One ``fn()`` under the profiler: busy share (kernel time against the
    unprofiled wall time), device ops, top kernels, and for each ``spev.*``
    range the host time inside it and the time of the kernels its ops
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_us = float(np.median(walls)) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # device events, less the ranges' own device-side annotations
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("spev.")]
    busy = sum(k.time_range.elapsed_us() for k in kernels)
    by_name = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), c + 1)
    stages = {}
    for label in labels:
        ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name == label]
        stages[label] = {"host_ms": sum(e.cpu_time_total for e in ranges) / 1e3,
                         "kernel_ms": sum(e.device_time_total for e in ranges) / 1e3}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"{name}: wall {wall_us / 1e3:.2f} ms unprofiled (median of 3: "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}), device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of wall), device ops {len(kernels)}; by stage (host "
        "time / time of the kernels it launched): " + "; ".join(
            f"{k} {v['host_ms']:.2f} / {v['kernel_ms']:.3f} ms" for k, v in stages.items())
        + "; top: " + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{c}" for k, (t, c) in top))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "device_ops": len(kernels),
            "stages": stages}


# K2 is launched through ctypes, outside the profiler's view of the ops, so
# spev.log_mel shows its host time only; phase 8b times the kernel itself
STAGES = ["spev.log_mel", "spev.f0", "spev.pyin.cmndf", "spev.pyin.trough_probs",
          "spev.pyin.viterbi", "spev.rms", "spev.centroid"]


def phase8_extraction(tmp):
    """The dataset build through ``cli.train --data_dir`` in-process at the
    default config, counted and timed; then the cache checked, one 10 s
    utterance repeated and profiled."""
    from spev_tpu_torch.cli import train as train_cli
    from spev_tpu_torch.data.dataset import FeatureExtractor, SpevDataset
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.train.trainer import Trainer
    from spev_tpu_torch.utils.wavio import read_wav

    corpus, tg = os.path.join(tmp, "corpus"), os.path.join(tmp, "textgrids")
    t0 = time.perf_counter()
    info = _write_corpus(corpus, tg)
    log(f"phase 8: wrote a {len(info)}-file corpus ({sum(n for n, _ in info.values()) / 22050:.1f}"
        f" s at 22050 Hz) in {time.perf_counter() - t0:.2f} s")

    calls = {"stats_features": 0, "full_features": 0, "train_step": 0, "eval_step": 0}
    marks = {}
    originals = {}

    def counting(cls, name):
        orig = originals[name] = getattr(cls, name)

        def call(self, *a, **k):
            calls[name] += 1
            return orig(self, *a, **k)
        setattr(cls, name, call)

    for cls, name in ((FeatureExtractor, "stats_features"), (FeatureExtractor, "full_features"),
                      (Trainer, "train_step"), (Trainer, "eval_step")):
        counting(cls, name)
    orig_build, orig_extract = SpevDataset._build, SpevDataset._serial_extract

    def build(self, *a, **k):
        marks["build_start"] = time.perf_counter()
        orig_build(self, *a, **k)
        torch.cuda.synchronize()
        marks["build_end"] = time.perf_counter()

    def serial_extract(self, *a, **k):
        marks["pass2_start"] = time.perf_counter()
        yield from orig_extract(self, *a, **k)

    SpevDataset._build, SpevDataset._serial_extract = build, serial_extract
    cache = os.path.join(tmp, "cache_built")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _keep_kernel_inputs() as kept:
            fused_log_mel.launches = 0
            lr_fused.launches = 0
            lr_fused_bwd.launches = 0
            t0 = time.perf_counter()
            rc = train_cli.main(["--data_dir", corpus, "--textgrid_dir", tg, "--cache_dir", cache,
                                 "--name", "extract", "--epochs", "1", "--warmup_epochs", "0",
                                 "--batch_size", "16", "--warmup_steps", "20"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"fused_log_mel": fused_log_mel.launches, "lr_fused": lr_fused.launches,
                        "lr_fused_bwd": lr_fused_bwd.launches}
    finally:
        os.chdir(cwd)
        SpevDataset._build, SpevDataset._serial_extract = orig_build, orig_extract
        FeatureExtractor.stats_features = originals["stats_features"]
        FeatureExtractor.full_features = originals["full_features"]
        Trainer.train_step, Trainer.eval_step = originals["train_step"], originals["eval_step"]
    if rc != 0:
        raise AssertionError(f"the training CLI exited with {rc}")
    if not (launches["fused_log_mel"] == calls["full_features"] == 31
            and calls["stats_features"] == 31):
        raise AssertionError(f"K2 ran {launches['fused_log_mel']} times for "
                             f"{calls['full_features']} full_features calls and "
                             f"{calls['stats_features']} stats_features calls (expected 31)")
    if not (launches["lr_fused"] == calls["train_step"] + calls["eval_step"]
            and launches["lr_fused_bwd"] == calls["train_step"] > 0):
        raise AssertionError(f"launches {launches} for {calls}")

    # the cache
    with open(os.path.join(cache, "metadata.json")) as f:
        meta = json.load(f)
    st = meta["stats"]
    if not (all(math.isfinite(v) for v in st.values())
            and min(st["p_std"], st["e_std"], st["c_std"]) > 1e-5):
        raise AssertionError(f"bad stats {st}")
    audio_s = 0.0
    for name, (n_ph, n_fr) in zip(meta["files"], meta["lengths"]):
        with np.load(os.path.join(cache, name), allow_pickle=True) as u:
            arrays = {k: u[k] for k in u.files if k != "phs"}
            n_phs = len(u["phs"])
        if not (all(np.isfinite(a).all() for a in arrays.values())
                and int(arrays["durs"].sum()) == arrays["mel"].shape[0] == n_fr
                and n_phs == n_ph == len(arrays["pitch"]) and arrays["mel"].shape[1] == 80):
            raise AssertionError(f"bad cache entry {name}")
        audio_s += (n_fr - 1) * 256 / 22050
    stats_s = marks["pass2_start"] - marks["build_start"]
    pass2_s = marks["build_end"] - marks["pass2_start"]
    n_utt = len(meta["files"])
    log(f"phase 8: cli.train --data_dir: {n_utt} utterances cached ({audio_s:.1f} s of audio), "
        f"stats pass {stats_s:.2f} s over {calls['stats_features']} files, pass 2 {pass2_s:.2f} s "
        f"({1e3 * pass2_s / n_utt:.1f} ms per utterance, {1e3 * pass2_s / audio_s:.1f} ms per "
        f"second of audio), build {marks['build_end'] - marks['build_start']:.2f} s, whole "
        f"command {run_s:.2f} s; {calls['train_step']} train steps, {calls['eval_step']} eval "
        f"forwards; launches {json.dumps(launches)}; stats {json.dumps(st)}")

    # one 10 s utterance: repeat (bit-equal?) and profile
    y, _ = read_wav(os.path.join(corpus, "clip03.wav"))
    fx = FeatureExtractor()
    first = fx.full_features(y)
    again = fx.full_features(y)
    same = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(first, again))
    log(f"phase 8: full_features of a 10 s utterance ({len(y)} samples, {first[0].shape[1]} "
        f"frames) twice on the card: bit-equal {same}")
    prof = _profile_stages("phase 8 profile: full_features, 10 s utterance",
                           lambda: fx.full_features(y), STAGES)
    return launches, kept, {"utterances": n_utt, "audio_s": audio_s, "stats_s": stats_s,
                            "pass2_s": pass2_s, "repeat_bit_equal": same, "profile": prof}, \
        (corpus, tg)


@torch.inference_mode()
def phase8b_extraction_inputs(kept):
    """K2 against its plain version on the signals the build gave it, one per
    bucket size, after the counts were read."""
    cases = [{**_k2_case(*args, **kw), "main_path": "features"}
             for args, kw in kept["fused_log_mel"].values()]
    for c in cases:
        log("phase 8b: K2 within 2e-4 of plain on extraction-path inputs", json.dumps(c))
    if not cases:
        raise AssertionError("the extraction path called no K2")
    return cases


def phase9_extraction_card_vs_cpu(tmp, corpus, tg):
    """Four utterances (one of 10 s, one resampled from 16 kHz, TextGrids
    and transcripts) built on the CPU and on the card."""
    import shutil

    from spev_tpu_torch.data.dataset import SpevDataset

    sub = os.path.join(tmp, "p9_corpus")
    os.makedirs(sub)
    for name in ("clip01", "clip03", "clip04", "clip07"):
        for ext in (".wav", ".txt"):
            if os.path.exists(os.path.join(corpus, name + ext)):
                shutil.copy(os.path.join(corpus, name + ext), sub)
    t0 = time.perf_counter()
    cpu = SpevDataset(sub, textgrid_dir=tg, cache_dir=os.path.join(tmp, "p9_cpu"), device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = SpevDataset(sub, textgrid_dir=tg, cache_dir=os.path.join(tmp, "p9_card"))
    card_s = time.perf_counter() - t0
    if not (cpu.files == card.files and len(cpu.files) == 4
            and [tuple(x) for x in cpu.lengths] == [tuple(x) for x in card.lengths]):
        raise AssertionError(f"files or lengths differ: {cpu.lengths} vs {card.lengths}")
    mel_err, diffs = 0.0, {k: [] for k in ("pitch", "energy", "breath", "rough", "bright",
                                          "nasal")}
    for i in range(4):
        a, b = cpu.load_utterance(i), card.load_utterance(i)
        if not (list(a["phs"]) == list(b["phs"]) and np.array_equal(a["durs"], b["durs"])):
            raise AssertionError(f"phonemes or durations differ in utterance {i}")
        mel_err = max(mel_err, float(np.abs(a["mel"] - b["mel"]).max()))
        for k in diffs:
            diffs[k].append(np.abs(a[k] - b[k]))
    stats_rel = max(abs(cpu.stats[k] - card.stats[k]) / abs(cpu.stats[k]) for k in cpu.stats)
    report, ok = {}, mel_err <= 2e-4
    for k, v in diffs.items():
        v = np.concatenate(v)
        within = float((v <= 1e-3).mean())
        report[k] = {"phonemes": int(v.size), "within_1e-3": within, "max": float(v.max())}
        ok = ok and within >= 0.99 and v.max() <= 0.1
    log(f"phase 9: extraction card vs CPU, 4 utterances ({sum(t for _, t in cpu.lengths)} "
        f"frames): CPU build {cpu_s:.2f} s, card build {card_s:.2f} s; phonemes, durations, "
        f"lengths equal; mel max |diff| {mel_err:.3e} (<= 2e-4); stats max rel diff "
        f"{stats_rel:.3e}; targets (<= 1e-3 on 99 %, <= 0.1 on all): {json.dumps(report)}")
    if not ok:
        raise AssertionError("the card's extraction disagrees with the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    import spev_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase1_card_and_build()
    k1 = phase2_k1()
    k1b = phase2b_k1b()
    k3 = phase3_k3()
    k2 = phase3b_k2()
    with tempfile.TemporaryDirectory() as tmp:
        pt, hdir = _write_checkpoints(tmp)
        serving, kept = phase4_serving(pt, hdir, tmp)
        k1_main, k3_main = phase4b_main_path_inputs(kept)
        phase5_card_vs_cpu(pt, hdir)
        training, kept_train, _ = phase6_training(tmp)
        k1_train, k1b_train = phase6b_training_inputs(kept_train)
        phase7_train_step_card_vs_cpu(tmp)
        extraction, kept_fx, _, (corpus, tg) = phase8_extraction(tmp)
        k2_main = phase8b_extraction_inputs(kept_fx)
        phase9_extraction_card_vs_cpu(tmp, corpus, tg)

    def entry(name, source, replaces, cases, by_path):
        head = cases[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head.get("bound_by", "bytes"),
            "library_ms": head["library_ms"],
            "cases": cases,
        }

    kernels = [
        entry("lr_fused", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:36", k1 + k1_main + k1_train,
              {"serving": serving["lr_fused"], "training": training["lr_fused"]}),
        entry("lr_fused_bwd", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:54", k1b + k1b_train,
              {"training": training["lr_fused_bwd"]}),
        entry("log_mel", "spev_tpu_torch/csrc/log_mel.cu",
              "spev_tpu/ops/pallas/kernels.py:30", k2 + k2_main,
              {"features": extraction["fused_log_mel"]}),
        entry("overlap_add", "spev_tpu_torch/csrc/overlap_add.cu",
              "spev_tpu/ops/pallas/kernels.py:131", k3 + k3_main,
              {"serving": serving["overlap_add"]}),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
