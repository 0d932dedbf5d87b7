"""Closed-loop batch synthesis: ``Synthesizer.synthesize_many(texts,
batch_size)`` called back to back for the window, ``texts_per_call`` new
texts a call, as an offline job hands over its list of texts.

Parameters (the cell's file): ``texts_per_call``, ``batch_size``,
``phonemes_per_audio_s``, ``audio_s`` and ``beta`` (the length law of
`texts.TextGenerator`), ``warmup_calls``, ``calls_per_s_cap`` (how many
calls' texts are made ahead in set-up), ``kept_per_call`` and
``kept_calls`` (the rows kept for the check), and ``limits``.

End to end: ``audio_s_per_s``, the seconds of audio returned (sum of each
row's frames * hop / sample rate) over the window's seconds, the window
running from the first call to the end of the call that closes it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ttsbench.counts import bytes as nbytes
from ttsbench.counts import flops
from ttsbench.lib import program
from ttsbench.lib.trace import Window
from ttsbench.reference import g2p_rules
from ttsbench.reference.synthesis import gaps, synthesize
from ttsbench.traffic.texts import TextGenerator

LAYER_SPANS = ("G2P.phonemes", "Synthesizer._acoustic", "Vocoder.run", "bench.call")


def wrap_layers(spans, synth) -> None:
    spans.wrap(synth.g2p, "phonemes", "G2P.phonemes")
    spans.wrap(synth, "_acoustic", "Synthesizer._acoustic")
    spans.wrap(synth.vocoder, "run", "Vocoder.run")
    spans.record_kernels()


def row_ok(row, hop: int) -> bool:
    """A row as returned: a mel of frames x bins and hop samples a frame (its
    values are judged on the kept rows, after the window)."""
    if row is None or row[1] is None:
        return False
    wav, mel = row
    return mel.ndim == 2 and mel.shape[0] > 0 and len(wav) == mel.shape[0] * hop


def k1_bytes(calls: list) -> list:
    out = []
    for (B, T, H), F, M, _ends in calls:
        out.append(nbytes.k1(B, T, H, F, M))
    return out


def useful_flops(config: dict, rows: list) -> float:
    """The acoustic model and the generator over each returned row's valid
    phonemes and frames; rows are (text, frames)."""
    total = 0
    for text, L in rows:
        n = len(g2p_rules.phonemes(text))
        total += flops.fastspeech2(config["acoustic"], n, L) + flops.generator(config["vocoder"], L)
    return float(total)


def check_rows(run, kept: list, fs2, gen_sd, symbols, controls=None) -> dict:
    """The reference over the kept rows (text, wav, mel), TF32 off."""
    config = run.cell.config
    with run.fp32():
        refs = [synthesize(text, fs2, config["acoustic"], gen_sd, config["vocoder"], symbols,
                           run.device, controls=controls) for text, _, _ in kept]
    return gaps([(w, m) for _, w, m in kept], refs)


def kept_texts(seed: int, p: dict) -> list:
    """The texts of the rows a run keeps (the same draws as `run`: warm-up
    calls first, then the window's first ``kept_calls``)."""
    texts = TextGenerator(seed, p["phonemes_per_audio_s"], p["audio_s"], p["beta"])
    n = p["texts_per_call"]
    for _ in range(p["warmup_calls"]):
        texts.texts(n)
    keep_rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    out = []
    for c in range(p["kept_calls"]):
        batch = texts.texts(n)
        keep = set(keep_rng.choice(n, p["kept_per_call"], replace=False).tolist())
        if c == 0:
            keep.add(int(np.argmax([len(t) for t in batch])))
        out += [t for i, t in enumerate(batch) if i in keep]
    return out


def reference_gaps(cell, seed: int, device, texts: list, dtype, controls=None) -> dict:
    """The reference at ``dtype`` (autocast) in the program's place, judged by
    the fp32 reference with TF32 off, over ``texts``."""
    from ttsbench.lib.weights import fs2_weights, generator_weights

    config = cell.config
    symbols = g2p_rules.vocab()
    fs2 = fs2_weights(config["acoustic"], len(symbols), config["weights"], seed, device)
    gen = generator_weights(config["vocoder"], seed, device)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        args = (fs2, config["acoustic"], gen, config["vocoder"], symbols, device)
        ref = [synthesize(t, *args, controls=controls) for t in texts]
        low = [synthesize(t, *args, controls=controls, autocast_dtype=dtype) for t in texts]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return gaps(low, ref)


def control(cell, seed: int, device, variant: str, seconds: float) -> dict:
    """The control's readings: the reference in bfloat16 in the program's
    place, over the rows a run keeps (``seconds`` does not change them)."""
    if variant != "bf16":
        raise ValueError(f"no fault {variant!r} for this kind")
    p = cell.spec["params"]
    return reference_gaps(cell, seed, device, kept_texts(seed, p), torch.bfloat16)


def run(run) -> None:
    p = run.cell.spec["params"]
    config = run.cell.config
    synth, fs2, gen_sd, symbols = program.synthesizer(config, run.seed, run.device)
    hop = synth.vocoder.generator.cfg.hop_recovery
    sr = config["audio"]["sample_rate"]
    texts = TextGenerator(run.seed, p["phonemes_per_audio_s"], p["audio_s"], p["beta"])
    n, bs = p["texts_per_call"], p["batch_size"]
    run.log("program built")
    for _ in range(p["warmup_calls"]):
        synth.synthesize_many(texts.texts(n), batch_size=bs)
    calls = [texts.texts(n) for _ in range(int(np.ceil(run.seconds * p["calls_per_s_cap"])) + 1)]
    keep_rng = np.random.default_rng([int(run.seed) % (2 ** 63), 1])
    wrap_layers(run.spans, synth)
    run.sync()

    audio_s, attempted, failed, kept, done = 0.0, 0, 0, [], []
    run.setup_done()
    with Window(run.spans) as window:
        c, call_s = 0, []
        while True:
            t_call = time.perf_counter()
            if c == len(calls):
                calls.append(texts.texts(n))
            batch = calls[c]
            with run.spans.range("bench.call"):
                rows = synth.synthesize_many(batch, batch_size=bs)
            call_s.append(time.perf_counter() - t_call)
            attempted += len(batch)
            keep = set(keep_rng.choice(n, p["kept_per_call"], replace=False).tolist())
            if c == 0:
                keep.add(int(np.argmax([len(t) for t in batch])))
            for i, (text, row) in enumerate(zip(batch, rows)):
                if not row_ok(row, hop):
                    failed += 1
                    continue
                frames = row[1].shape[0]
                audio_s += frames * hop / sr
                done.append((text, frames))
                if c < p["kept_calls"] and i in keep:
                    kept.append((text, row[0], row[1]))
            c += 1
            if run.elapsed(window) >= run.seconds:
                break
        run.sync()
    run.window_closed(window)
    run.log("window's calls (s): " + " ".join(f"{t:.3f}" for t in call_s))
    run.e2e["audio_s_per_s"] = audio_s / window.seconds
    run.attempted, run.failed = attempted, failed
    run.layer_ctx.update(texts=attempted, audio_s=audio_s,
                         flops=useful_flops(config, done) if run.spans.on else None,
                         k1_bytes=k1_bytes(run.spans.k1_calls))
    if run.spans.on:
        run.reduce_trace(window, LAYER_SPANS)
    del synth
    run.free()
    run.judge(check_rows(run, kept, fs2, gen_sd, symbols), missing=failed)
