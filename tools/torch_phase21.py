#!/usr/bin/env python3
"""Phase 1 (the kernel build and the launch floor), phase 20b (the formant
setup trained 45 epochs: phase 21's acoustic model and corpus) and phase 21
(the GAN-vocoder evidence: copy synthesis with a V3 generator trained
through ``cli.vocoder``, then the GTA demo's arms and evaluation) of
``chip_smoke.py`` alone: the quick check of that surface on one card, and
the runs that decide which of phase 21's quality orderings gate
(``chip_smoke.GATING_ORDERINGS``).

    python3 tools/torch_phase21.py [--runs N]   # from the repository root; one card

Each run prints what those phases print, then one JSON line with phase
21's launch counts, orderings, V3 step time, copy-synthesis MCDs and the
arms' mean MCDs; the last line counts, for each ordering, the runs it held
in.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=1)
    a = ap.parse_args()
    t0 = time.perf_counter()
    card = chip_smoke.phase1_card_and_build()
    held = {k: 0 for k in chip_smoke.ORDERINGS}
    for run in range(a.runs):
        with tempfile.TemporaryDirectory() as tmp:
            work = os.path.join(tmp, "p20")
            os.makedirs(work)
            setup, _ = chip_smoke.phase20b_gate(work)
            res, _, _, _ = chip_smoke.phase21_vocoder_evidence(tmp, setup)
        for k, ok in res["orderings"].items():
            held[k] += bool(ok)
        print(json.dumps({"run": run, "launches": res["launches"], "counts": res["counts"],
                          "orderings": res["orderings"], "step_ms": res["copy"]["step_ms"],
                          "copy_synthesis": res["copy"]["copy_synthesis"],
                          "gta": res["gta"]["summary"], "phase_s": res["phase_s"]}), flush=True)
    print(json.dumps({"runs": a.runs, "orderings_held": held}))
    print(f"torch_phase21: {time.perf_counter() - t0:.1f} s on {card}")
