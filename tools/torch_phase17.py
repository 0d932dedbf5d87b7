#!/usr/bin/env python3
"""Phase 1 (the kernel build and the launch floor) and phase 17 (native
I/O, the preppers, the parallel build and the 'model' axis) of
``chip_smoke.py`` alone, on phase 6's numpy-written cache and phase 4's
HiFi-GAN: the quick check of that surface on one card.

    python3 tools/torch_phase17.py   # from the repository root; one card

It prints what those phases print, then one JSON line with phase 17's
launch counts and the kernel cases held against their plain versions.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    card = chip_smoke.phase1_card_and_build()
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke._write_cache(os.path.join(tmp, "cache"))
        _, hdir = chip_smoke._write_checkpoints(tmp)
        res, k1, k1b, k2 = chip_smoke.phase17_extraction_and_model_axis(tmp, hdir)
    print(json.dumps({"launches": res["launches"], "k1": k1, "k1b": k1b, "k2": k2}))
    print(f"torch_phase17: {time.perf_counter() - t0:.1f} s on {card}")
