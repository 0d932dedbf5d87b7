"""Open-loop serving through ``CoalescingBatcher.submit``: requests arrive as a
Poisson process at ``rate_per_s`` for the window, each one sentence (the
LJSpeech law of `texts.TextGenerator`, unique texts) with the batcher's
default controls passed explicitly, from ``client_threads`` threads, so no
request waits for a free thread.

Every seed gets the same arrival gaps (the exponential law's quantiles) and
the same lengths, in its own order.  A request's latency runs from its due
time to the return of ``submit``; one that fails or is not back
``wait_after_s`` after the window's close counts with the time waited.

End to end: ``latency_p95_ms`` over every request due in the window.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ttsbench.lib import program
from ttsbench.lib.trace import Window
from ttsbench.traffic.batch_synthesis import check_rows, reference_gaps, row_ok, wrap_layers
from ttsbench.traffic.texts import TextGenerator, beta_quantiles

LAYER_SPANS = ("G2P.phonemes", "Synthesizer._acoustic", "Vocoder.run",
               "Synthesizer.synthesize_many")


def arrivals(rng, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds): round(rate * seconds) gaps, the mid-quantiles
    of Exp(rate) in the rng's order, scaled to span the window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def warm_up(synth, texts: TextGenerator, p: dict) -> None:
    """Every batch size the batcher forms (powers of two up to max_batch) at
    lengths across the law, called as the batcher calls the synthesizer."""
    sizes = [1 << k for k in range(int(np.log2(p["max_batch"])) + 1)]
    lengths = np.linspace(*p["audio_s"], p["warmup_lengths"])
    for B in sizes:
        for s in lengths:
            batch = texts.texts_of([s] * B)
            merged = {k: np.full(B, 1.0, np.float32)
                      for k in ("duration_scale", "pitch_scale", "energy_scale")}
            merged.update({k: np.full(B, v, np.float32) for k, v in p["controls"].items()})
            synth.synthesize_many(batch, batch_size=p["max_batch"], **merged)


def mean_rows(before: dict, after: dict):
    sizes = {int(k): v - before["sizes"].get(k, 0) for k, v in after["sizes"].items()}
    n = sum(sizes.values())
    return sum(k * v for k, v in sizes.items()) / n if n else None


def drive(batcher, requests: list, due: np.ndarray, p: dict, seconds: float, sample: set,
          t0: float, valid=lambda row: True) -> dict:
    """Send request k at ``t0 + due[k]`` from a pool of client threads and
    wait for every one.  Returns ``waited`` (seconds from due time to the
    return of ``submit``; a request that failed or did not return counts
    with the time waited for it), ``late`` (dispatch behind its due time),
    ``missing`` (failed, or a reply that ``valid`` refuses), ``errors`` and
    the checked requests' ``results``."""
    n = len(due)
    latency, late = np.full(n, np.nan), np.zeros(n)
    results, errors = {}, []
    lock = threading.Lock()
    timeout = seconds + p["wait_after_s"]

    def client(k: int, t_due: float) -> None:
        late[k] = time.perf_counter() - t_due
        try:
            row = batcher.submit(requests[k], timeout=timeout, **p["controls"])
        except Exception as e:  # noqa: BLE001 - a failed request counts as missing
            with lock:
                errors.append(repr(e))
            return
        if not valid(row):
            with lock:
                errors.append(f"request {k}: a reply that is no waveform and mel")
            return
        latency[k] = time.perf_counter() - t_due
        if k in sample:
            with lock:
                results[k] = row

    with ThreadPoolExecutor(max_workers=p["client_threads"]) as pool:
        futures = []
        for k, d in enumerate(due):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(client, k, t0 + d))
        for f in futures:
            f.result()
    missing = np.isnan(latency)
    waited = np.where(missing, timeout - due, latency)
    return {"waited": waited, "late": late, "missing": int(missing.sum()), "errors": errors,
            "results": results, "latency": latency}


def plan(texts: TextGenerator, seed: int, p: dict, seconds: float):
    """(due times, request texts, indices of the checked requests) of a
    window, drawn after the warm-up's texts."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 3])
    due = arrivals(rng, p["rate_per_s"], seconds)
    n = len(due)
    requests = texts.texts_of(rng.permutation(beta_quantiles(n, *p["beta"], *p["audio_s"])))
    sample = set(rng.choice(n, min(p["checked"], n), replace=False).tolist())
    sample.add(int(np.argmax([len(t) for t in requests])))
    return due, requests, sample


class _NoSynth:
    def synthesize_many(self, *a, **k):
        return None


def control(cell, seed: int, device, variant: str, seconds: float) -> dict:
    """The control's readings over the requests a run of ``seconds`` checks:
    the reference in bfloat16 in the program's place."""
    if variant != "bf16":
        raise ValueError(f"no fault {variant!r} for this kind")
    p = cell.spec["params"]
    texts = TextGenerator(seed, p["phonemes_per_audio_s"], p["audio_s"], p["beta"])
    warm_up(_NoSynth(), texts, p)
    _, requests, sample = plan(texts, seed, p, seconds)
    return reference_gaps(cell, seed, device, [requests[k] for k in sorted(sample)],
                          torch.bfloat16, controls=p["controls"])


def run(run) -> None:
    from spev_tpu_torch.infer.batching import CoalescingBatcher

    p, config = run.cell.spec["params"], run.cell.config
    synth, fs2, gen_sd, symbols = program.synthesizer(config, run.seed, run.device)
    hop = synth.vocoder.generator.cfg.hop_recovery
    texts = TextGenerator(run.seed, p["phonemes_per_audio_s"], p["audio_s"], p["beta"])
    run.log("program built")
    warm_up(synth, texts, p)
    due, requests, sample = plan(texts, run.seed, p, run.seconds)
    n = len(due)
    batcher = CoalescingBatcher(synth, max_batch=p["max_batch"], window_ms=p["window_ms"])
    wrap_layers(run.spans, synth)
    run.spans.wrap(synth, "synthesize_many", "Synthesizer.synthesize_many")
    stats0 = batcher.stats()
    run.sync()
    run.setup_done()
    with Window(run.spans) as window:
        out = drive(batcher, requests, due, p, run.seconds, sample, window.t0,
                    lambda row: row_ok(row, hop))
        run.sync()
    run.window_closed(window)
    stats1 = batcher.stats()
    waited, results = out["waited"], out["results"]
    run.e2e["latency_p95_ms"] = float(np.percentile(waited, 95) * 1e3)
    run.attempted, run.failed = n, out["missing"]
    run.layer_ctx.update(latency_p50_ms=float(np.percentile(waited, 50) * 1e3),
                         batch_rows_mean=mean_rows(stats0, stats1))
    run.log(f"dispatch behind the due time: p95 {np.percentile(out['late'], 95) * 1e3:.2f} ms, "
            f"max {out['late'].max() * 1e3:.2f} ms")
    if out["errors"]:
        run.log(f"failed requests, first: {out['errors'][0]}")
    if run.spans.on:
        run.reduce_trace(window, LAYER_SPANS)
    del synth, batcher
    run.free()
    kept = [(requests[k], *results[k]) for k in sorted(results)]
    run.judge(check_rows(run, kept, fs2, gen_sd, symbols, controls=p["controls"]),
              missing=run.failed)
