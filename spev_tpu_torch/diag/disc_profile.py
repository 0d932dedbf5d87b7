"""Per-sub-discriminator cost profile: the counterpart of the JAX package's
``tools/tpu_disc_profile.py``.

The GAN step is dominated by the discriminators, so speed work on it needs
to know which sub-discriminator (each MPD period, each MSD scale) takes the
time, forward and forward+backward, at the training precision and dtype.

- `sub_discriminators` yields each sub-discriminator with the input it sees
  in `Discriminators.forward` (the MSD's pooled by `msd_pool`).
- `profile_loss` is the JAX tool's scalar, ``mean(logits²) + Σ mean|f|``
  accumulated in fp32.
- `time_sub_discriminators` times both graphs per sub-discriminator at one
  (precision, dtype) and returns JAX's rows and totals row.  On the card
  each graph runs twice before its window, then ``n_iter`` calls between
  CUDA events (JAX's columns), beside the host's time to enqueue them (where
  the two meet, the time is the host's, not the device's) and the device
  time of one call captured in a CUDA graph; ``device="cpu"`` (tests only)
  times with the host clock and labels every row ``"device": "cpu"``.

``precision`` is the vocoder step's (`train.vocoder_trainer.step_precision`:
``'high'`` fp32 convolutions, ``'default'`` TF32); ``dtype="bf16"`` is the
trainer's ``--disc_dtype bf16`` (the wav cast before the MSD pooling, the
weights cast inside each forward, fp32 masters get the gradients).
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spev_tpu_torch.models.hifigan_disc import Discriminators, msd_pool
from spev_tpu_torch.train.vocoder_trainer import PRECISIONS, step_precision
from spev_tpu_torch.utils.platform import resolve_device

DTYPES = {"f32": None, "bf16": torch.bfloat16}
WARMUP = 2


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its first line), or None
    where ``nvidia-smi`` is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def device_label(dev: torch.device) -> str:
    """``"cpu"``, or the card's name: what every result row carries."""
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def sub_discriminators(disc: Discriminators,
                       wav: torch.Tensor) -> Iterator[Tuple[str, nn.Module, torch.Tensor]]:
    """``(name, module, input)`` for ``mpd_p{p}`` in period order, then
    ``msd_s{s}``, each input as `Discriminators.forward` hands it over."""
    for p, d in zip(disc.periods, disc.mpd):
        yield f"mpd_p{p}", d, wav
    x = wav
    for s, d in enumerate(disc.msd):
        if s > 0:
            x = msd_pool(x)
        yield f"msd_s{s}", d, x


def profile_loss(outs) -> torch.Tensor:
    """One sub-discriminator's ``(logits, feature maps)`` → ``mean(logits²)
    + Σ mean|f|``, each term in fp32 (the JAX tool's ``fwd``)."""
    logits, feats = outs
    loss = torch.mean(logits.float() ** 2)
    for f in feats:
        loss = loss + torch.mean(f.abs().float())
    return loss


def _ms(fn, n_iter: int, dev: torch.device) -> Tuple[float, float]:
    """Mean milliseconds of one ``fn()`` over ``n_iter`` calls after
    `WARMUP` calls, and the host's milliseconds a call to enqueue them: on
    the card the first is CUDA events' and the second the host clock up to
    the last call's return (near the first, the device waited on the host);
    on the CPU both are the host clock."""
    for _ in range(WARMUP):
        fn()
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / n_iter
        return ms, ms
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / n_iter
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n_iter, host_ms


def _graph_ms(fn, n_iter: int, dev: torch.device) -> float:
    """Device milliseconds of one ``fn()``: captured once in a CUDA graph
    (after `WARMUP` calls on a side stream) and replayed ``n_iter`` times
    between CUDA events, so that no per-op host dispatch is timed (the
    counterpart of the JAX tool's one jitted dispatch a call)."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n_iter


def time_sub_discriminators(batch_size: int = 16, segment: int = 8192, n_iter: int = 30,
                            precision: str = "default", dtype: str = "f32", seed: int = 0,
                            device="cuda") -> List[Dict]:
    """One row ``{"disc", "fwd_ms", "fwd_bwd_ms", "precision", "dtype",
    "device", "fwd_host_ms", "fwd_bwd_host_ms", "fwd_graph_ms",
    "fwd_bwd_graph_ms"}`` per sub-discriminator of
    `Discriminators.random_init(seed)` on a ``default_rng(seed).normal(0,
    0.1, (B, T))`` wav (the graph times None on the CPU), then the JAX
    tool's totals row with the card's name and power limit.  ``fwd`` runs
    under ``no_grad``; ``fwd_bwd`` takes the gradients of `profile_loss`
    with respect to that sub-discriminator's parameters only.  The
    process's TF32 flags are restored afterwards.  device: "cuda" (the
    default) raises without a GPU."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, not {dtype!r}")
    dev = resolve_device(device)
    dt = DTYPES[dtype]
    disc = Discriminators.random_init(seed=seed).to(dev)
    wav = torch.from_numpy(np.random.default_rng(seed).normal(0, 0.1, (batch_size, segment))
                           .astype(np.float32)).to(dev)
    if dt is not None:
        wav = wav.to(dt)
    label = device_label(dev)
    rows = []
    with step_precision(precision):
        for name, sub, x in sub_discriminators(disc, wav):
            params = list(sub.parameters())

            def fwd(sub=sub, x=x):
                with torch.no_grad():
                    return profile_loss(sub(x, dt))

            def fwd_bwd(sub=sub, x=x, params=params):
                return torch.autograd.grad(profile_loss(sub(x, dt)), params)

            (f_ms, f_host), (fb_ms, fb_host) = _ms(fwd, n_iter, dev), _ms(fwd_bwd, n_iter, dev)
            on_card = dev.type == "cuda"
            rows.append({"disc": name, "fwd_ms": f_ms, "fwd_bwd_ms": fb_ms,
                         "precision": precision, "dtype": dtype, "device": label,
                         "fwd_host_ms": f_host, "fwd_bwd_host_ms": fb_host,
                         "fwd_graph_ms": _graph_ms(fwd, n_iter, dev) if on_card else None,
                         "fwd_bwd_graph_ms": _graph_ms(fwd_bwd, n_iter, dev) if on_card
                         else None})
    rows.append({"total_fwd_ms": sum(r["fwd_ms"] for r in rows),
                 "total_fwd_bwd_ms": sum(r["fwd_bwd_ms"] for r in rows),
                 "batch": batch_size, "segment": segment, "precision": precision,
                 "dtype": dtype, "device": label,
                 "card": None if dev.type == "cpu" else card()})
    return rows
