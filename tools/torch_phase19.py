#!/usr/bin/env python3
"""Phase 1 (the kernel build and the launch floor) and phase 19 (the
learned-control evidence: the emotion registers and the control sweeps)
of ``chip_smoke.py`` alone, after phase 16b's
``cli.train`` run on the formant corpus that gives 19c its checkpoint: the
quick check of that surface on one card.

    python3 tools/torch_phase19.py   # from the repository root; one card

It prints what those phases print, then one JSON line with phase 19's
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
    from spev_tpu_torch.data.synthetic import generate_formant_corpus

    t0 = time.perf_counter()
    card = chip_smoke.phase1_card_and_build()
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "formant")
        corpus = os.path.join(work, "wavs")
        tg = generate_formant_corpus(corpus, n_utterances=chip_smoke.FORMANT_UTTS, seed=0)
        rc, out = chip_smoke._launch(
            "spev_tpu_torch.cli.train",
            chip_smoke._formant_train_args(corpus, tg, os.path.join(work, "cache")), work,
            os.path.join(work, "train.log"))
        if rc != 0:
            raise SystemExit(f"phase 16b's cli.train exited with {rc}:\n{out[-4000:]}")
        t16 = time.perf_counter() - t0
        res, k1, k1b, k2, k3 = chip_smoke.phase19_control_evidence(tmp)
    print(json.dumps({"launches": res["launches"], "counts": res["counts"], "k1": k1,
                      "k1b": k1b, "k2": k2, "k3": k3}))
    print(f"torch_phase19: {time.perf_counter() - t0:.1f} s on {card} (the build and phase "
          f"16b's training run {t16:.1f} s)")
