"""K1, K1b, K2 and K3 of two checkouts of the PyTorch port, timed in turns
on one card.

    python3 -m spev_tpu_torch.diag.kernel_ab OLD_ROOT NEW_ROOT [--rounds 2]

Each root is a checkout of the repository (the directory holding
``spev_tpu_torch/``).  The runs go OLD, NEW, NEW, OLD (``--rounds`` times
that pair of pairs), each in a process of its own that builds that tree's
kernels and times them on the same seeded inputs with CUDA graphs of 20
launches replayed 10 times between CUDA events (as ``chip_smoke.py`` does),
beside a one-element ``fill_`` (the launch floor).  Shapes, H=256:
- K1 at the serving path's (B, T, M) = (1, 128, 512), (4, 128, 1024) and
  the bench's (16, 128, 768);
- K1b, unit-normal cotangents, at the bench's (16, 128, 768) and the
  training buckets (16, 64, 256), (16, 128, 512), (16, 128, 1024) with the
  ``mixed`` durations of `durations` (a row of 40-frame phonemes among
  them), and at (16, 128, 1024) with ``guard`` (one 1000-frame phoneme a
  row) and ``silence`` (200-frame silences at each row's start and end);
- K2 on 1, 4 and 10 s tone-plus-noise signals at n_fft 1024, hop 256, 80
  mels, fmax sr/2;
- K3 at T = 512 (the Griffin-Lim path's) and 2048 frames of 1024, hop 256.
Prints one JSON line per run, then the median of each time for each tree,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

K1_SHAPES = [(1, 128, 512), (4, 128, 1024), (16, 128, 768)]
K1B_CASES = [("mixed", 16, 128, 768), ("mixed", 16, 64, 256), ("mixed", 16, 128, 512),
             ("mixed", 16, 128, 1024), ("guard", 16, 128, 1024), ("silence", 16, 128, 1024)]
K2_SAMPLES = [24576, 90112, 221184]
K3_FRAMES = [512, 2048]


def durations(kind: str, B: int, T: int, g):
    """Float phoneme durations (B, T) from the torch.Generator ``g``, before
    `regulate_lengths` sanitises them.  ``mixed``: 0-11 frames, with NaN,
    inf and -3 in row 1, an all-zero row 2, zero-duration phonemes in row 3
    and row 5 all 40 frames (it saturates any bucket); needs B >= 6.
    ``guard``: 1-12 frames, phoneme 3 of every row at the 1000-frame guard.
    ``silence``: 1-12 frames, 200 at each row's first and last phoneme."""
    import torch

    if kind == "mixed":
        d = torch.randint(0, 12, (B, T), generator=g).float()
        d[1, 5] = float("nan")
        d[1, 9] = float("inf")
        d[2, :] = 0.0            # all-zero row: one zero frame
        d[3, ::3] = 0.0          # zero-duration phonemes
        d[4, 7] = -3.0
        d[5, :] = 40.0           # saturates any bucket
        return d
    d = torch.randint(1, 13, (B, T), generator=g).float()
    if kind == "guard":
        d[:, 3] = 1000.0
    elif kind == "silence":
        d[:, 0] = 200.0
        d[:, -1] = 200.0
    else:
        raise ValueError(f"durations: unknown kind {kind!r}")
    return d


def _graph_ms(torch, fn, n=20, reps=10):
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
    return start.elapsed_time(end) / (n * reps)


def worker(root: str) -> dict:
    """Time one tree's K1, K1b, K2 and K3 (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from spev_tpu_torch.ops.cuda import build
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.ops.length_regulator import regulate_lengths
    from spev_tpu_torch.ops.stft import hann_window

    build.build_all()
    g = torch.Generator().manual_seed(0)
    buf = torch.zeros(1, device="cuda")
    res = {"root": root, "launch_floor_ms": _graph_ms(torch, lambda: buf.fill_(1.0))}
    for B, T, M in K1_SHAPES:
        x = torch.randn(B, T, 256, generator=g).cuda()
        fpad = torch.randn(B, T, 8, generator=g).cuda()
        d = torch.randint(1, 12, (B, T), generator=g, dtype=torch.int32)
        ends = torch.cumsum(d, 1, dtype=torch.int32).cuda()
        res[f"k1_B{B}_T{T}_M{M}_ms"] = _graph_ms(torch, lambda: lr_fused(x, fpad, ends, M))
    for n in K2_SAMPLES:
        r = np.random.default_rng(n)
        t = np.arange(n) / 22050.0
        y = torch.from_numpy((0.5 * np.sin(2 * np.pi * 220 * t)
                              + 0.1 * r.standard_normal(n)).astype(np.float32)).cuda()
        res[f"k2_n{n}_ms"] = _graph_ms(torch, lambda: fused_log_mel(y, fmax=11025.0))
    for kind, B, T, M in K1B_CASES:
        ends = regulate_lengths(durations(kind, B, T, g))[0].contiguous().cuda()
        gx = torch.randn(B, M, 256, generator=g).cuda()
        gf = torch.randn(B, M, 8, generator=g).cuda()
        res[f"k1b_{kind}_B{B}_T{T}_M{M}_ms"] = _graph_ms(torch,
                                                         lambda: lr_fused_bwd(gx, gf, ends, T))
    win = torch.from_numpy(hann_window(1024)).cuda()
    for T in K3_FRAMES:
        frames = (torch.randn(T, 1024, generator=g).cuda() * win).contiguous()
        res[f"k3_T{T}_ms"] = _graph_ms(torch, lambda: overlap_add(frames, win, 256))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.old)), flush=True)
        return 0
    runs = {"old": [], "new": []}
    for _ in range(args.rounds):
        for which in ("old", "new", "new", "old"):
            root = getattr(args, which)
            out = subprocess.run([sys.executable, os.path.abspath(__file__), root, root,
                                  "--worker"], capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                sys.stderr.write(out.stdout + out.stderr)
                return out.returncode
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": which, **line}), flush=True)
            runs[which].append(line)
    keys = [k for k in runs["old"][0] if k.endswith("_ms")]
    print(json.dumps({which: {k: statistics.median(r[k] for r in rs) for k in keys}
                      for which, rs in runs.items()}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout.strip() else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
