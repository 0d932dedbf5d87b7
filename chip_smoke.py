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
3. K3 (overlap-add) against its plain version: within 1e-5 at T ∈ {256,
   2048} frames.  Kernel, plain version and a library yardstick
   (``torch.gather`` / ``F.fold``, never called by the port) are timed with
   CUDA graphs of 20 launches replayed between CUDA events.
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
   cuDNN: equal mel_len, mel MAE < 1e-4, HiFi-GAN waveform MAE < 1e-4.
6. The ``{"kernels": [...]}`` line, then as the last line the device line.

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
    """While active, the model's calls of K1 and K3 keep a copy of their
    inputs, one for each distinct shape; the wrappers count launches as
    before."""
    import spev_tpu_torch.ops.length_regulator as lr_mod
    import spev_tpu_torch.ops.stft as stft_mod

    kept = {"lr_fused": {}, "overlap_add": {}}
    sites = [(lr_mod, "lr_fused"), (stft_mod, "overlap_add")]
    originals = [getattr(mod, name) for mod, name in sites]

    def keeping(name, fn):
        def call(*args):
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            if key not in kept[name]:
                kept[name][key] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
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
    counted run).  Busy share = summed kernel time / the wall time of the
    same request run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, fn in (("synthesize", lambda: synth.synthesize(TEXTS[1])),
                     ("griffin_lim", lambda: synth_gl.synthesize(TEXTS[1]))):
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
            log(f"phase 4 profile: {name}: no device time recorded (not measured)")
            continue
        busy = sum(r[1] for r in rows)
        top = sorted(rows, key=lambda r: -r[1])[:8]
        log(f"phase 4 profile: {name}: wall {wall_us / 1e3:.2f} ms unprofiled, device busy "
            f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall), device ops "
            f"{sum(r[2] for r in rows)}; top: " + "; ".join(
                f"{k[:70]} {t / 1e3:.3f} ms x{c}" for k, t, c in top))


def phase5_card_vs_cpu(pt, hdir):
    from spev_tpu_torch.infer.synthesis import Synthesizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    import spev_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase1_card_and_build()
    k1 = phase2_k1()
    k3 = phase3_k3()
    with tempfile.TemporaryDirectory() as tmp:
        pt, hdir = _write_checkpoints(tmp)
        launches, kept = phase4_serving(pt, hdir, tmp)
        k1_main, k3_main = phase4b_main_path_inputs(kept)
        phase5_card_vs_cpu(pt, hdir)

    def entry(name, source, replaces, cases, launches_n):
        head = cases[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_n, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes", "library_ms": head["library_ms"],
            "cases": cases,
        }

    kernels = [
        entry("lr_fused", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:36", k1 + k1_main,
              launches["lr_fused"]),
        entry("overlap_add", "spev_tpu_torch/csrc/overlap_add.cu",
              "spev_tpu/ops/pallas/kernels.py:131", k3 + k3_main, launches["overlap_add"]),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
