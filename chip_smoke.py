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
8. The ``{"kernels": [...]}`` line, then as the last line the device line.

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
    """While active, the model's calls of K1, K1b and K3 keep a copy of their
    inputs, one for each distinct shape; the wrappers count launches as
    before."""
    import spev_tpu_torch.ops.length_regulator as lr_mod
    import spev_tpu_torch.ops.stft as stft_mod

    kept = {"lr_fused": {}, "lr_fused_bwd": {}, "overlap_add": {}}
    sites = [(lr_mod, "lr_fused"), (lr_mod, "lr_fused_bwd"), (stft_mod, "overlap_add")]
    originals = [getattr(mod, name) for mod, name in sites]

    def keeping(name, fn):
        def call(*args):
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            if key not in kept[name]:
                kept[name][key] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                                        for a in args)
            return fn(*args)
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
    for args in kept["lr_fused"].values():
        case = {**_k1_case(*args), "main_path": True}
        k1.append(case)
        log("phase 4b: K1 bit-equal to plain on main-path inputs", json.dumps(case))
    for args in kept["overlap_add"].values():
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
    ds = SpevDataset(cache_dir=cache)
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
    k1 = [{**_k1_case(*args), "main_path": "training"} for args in kept["lr_fused"].values()]
    k1b = []
    for gx, gf, ends, T in kept["lr_fused_bwd"].values():
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

    ds = SpevDataset(cache_dir=os.path.join(tmp, "cache"))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    import spev_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase1_card_and_build()
    k1 = phase2_k1()
    k1b = phase2b_k1b()
    k3 = phase3_k3()
    with tempfile.TemporaryDirectory() as tmp:
        pt, hdir = _write_checkpoints(tmp)
        serving, kept = phase4_serving(pt, hdir, tmp)
        k1_main, k3_main = phase4b_main_path_inputs(kept)
        phase5_card_vs_cpu(pt, hdir)
        training, kept_train, _ = phase6_training(tmp)
        k1_train, k1b_train = phase6b_training_inputs(kept_train)
        phase7_train_step_card_vs_cpu(tmp)

    def entry(name, source, replaces, cases, by_path):
        head = cases[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes", "library_ms": head["library_ms"],
            "cases": cases,
        }

    kernels = [
        entry("lr_fused", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:36", k1 + k1_main + k1_train,
              {"serving": serving["lr_fused"], "training": training["lr_fused"]}),
        entry("lr_fused_bwd", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:54", k1b + k1b_train,
              {"training": training["lr_fused_bwd"]}),
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
