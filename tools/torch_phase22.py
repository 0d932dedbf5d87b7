#!/usr/bin/env python3
"""Phase 1 (the kernel build and the launch floor) and phase 22 (the
discriminator probes: the per-sub-discriminator profile and roofline, then
the bf16-discriminator probe) of ``chip_smoke.py`` alone: the quick check of
that surface on one card, and the runs that decide whether the bf16 probe's
first-step bar gates (``chip_smoke.P22_GATING_BARS``).

    python3 tools/torch_phase22.py [--runs N]   # from the repository root; one card

Each run prints what phase 22 prints, then one JSON line with its launch
counts, seconds, totals per profile group, largest roofline share, the
probe's speed-up and first-step gaps; the last lines count the runs each bar
held in and give the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=1)
    a = ap.parse_args()
    t0 = time.perf_counter()
    card = chip_smoke.phase1_card_and_build()
    held = {"first_step": 0}
    for run in range(a.runs):
        res = chip_smoke.phase22_disc_probes()
        prof, probe = res["profile"], res["probe"]
        for k, ok in probe["bars"].items():
            held[k] += bool(ok)
        print(json.dumps({
            "run": run, "launches": res["launches"], "phase_s": res["phase_s"],
            "totals": [{k: r[k] for k in ("precision", "dtype", "total_fwd_ms",
                                          "total_fwd_bwd_ms")}
                       for r in prof["rows"] if "total_fwd_ms" in r],
            "max_share": prof["max_share"], "speedup": probe["probe"]["summary"]["speedup"],
            "first_step_gaps": probe["gaps"], "bars": probe["bars"]}), flush=True)
    print(json.dumps({"runs": a.runs, "bars_held": held}))
    print(f"torch_phase22: {time.perf_counter() - t0:.1f} s on {card}")
