"""K1 and K2 of two checkouts of the PyTorch port, timed in turns on one card.

    python3 -m spev_tpu_torch.diag.kernel_ab OLD_ROOT NEW_ROOT [--rounds 2]

Each root is a checkout of the repository (the directory holding
``spev_tpu_torch/``).  The runs go OLD, NEW, NEW, OLD (``--rounds`` times
that pair of pairs), each in a process of its own that builds that tree's
kernels and times them on the same seeded inputs with CUDA graphs of 20
launches replayed 10 times between CUDA events (as ``chip_smoke.py`` does),
beside a one-element ``fill_`` (the launch floor).  Shapes: K1 at the serving
path's (B, T, M) = (1, 128, 512), (4, 128, 1024) and the bench's (16, 128,
768), H=256; K2 on 1, 4 and 10 s tone-plus-noise signals at n_fft 1024, hop
256, 80 mels, fmax sr/2.  Prints one JSON line per run, then the median of
each time for each tree, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

K1_SHAPES = [(1, 128, 512), (4, 128, 1024), (16, 128, 768)]
K2_SAMPLES = [24576, 90112, 221184]


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
    """Time one tree's K1 and K2 (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from spev_tpu_torch.ops.cuda import build
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused

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
