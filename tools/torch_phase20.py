#!/usr/bin/env python3
"""Phase 1 (the kernel build and the launch floor) and phase 20 (the
installed port, the convergence gate and the demo page) of
``chip_smoke.py`` alone: the quick check of that surface on one card.
Phase 20c's GAN vocoder is a seeded random V1 generator written as a
``gen_*.spev`` here (the smoke gives it phase 15's trained one).

    python3 tools/torch_phase20.py   # from the repository root; one card

It prints what those phases print, then one JSON line with phase 20's
launch counts, gate summary and demo metrics.
"""

import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from spev_tpu_torch.train.vocoder_trainer import save_generator

    t0 = time.perf_counter()
    card = chip_smoke.phase1_card_and_build()
    with tempfile.TemporaryDirectory() as tmp:
        gen = os.path.join(tmp, "gen_00000000.spev")
        torch.manual_seed(0)
        save_generator(gen, SimpleNamespace(generator=HiFiGANGenerator(HiFiGANConfig()), step=0),
                       HiFiGANConfig())
        res, k1, k1b, k2, k3 = chip_smoke.phase20_quality_gate(tmp, gen, "v1")
    gate, demo = res["gate"], res["demo"]
    print(json.dumps({"launches": res["launches"], "counts": res["counts"],
                      "summary": gate["summary"], "failures": gate["failures"],
                      "demo": demo["utterances"], "phase_s": res["phase_s"]}))
    print(f"torch_phase20: {time.perf_counter() - t0:.1f} s on {card}")
