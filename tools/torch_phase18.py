#!/usr/bin/env python3
"""Phase 1 (the kernel build and the launch floor) and phase 18 (the
acoustic trainer's matmul precision modes, remat of the FFT blocks and
``cli.train`` at the default mode) of ``chip_smoke.py`` alone, on phase 6's
numpy-written cache and a formant-corpus cache built as phase 16 builds
it: the quick check of that surface on one card.

    python3 tools/torch_phase18.py   # from the repository root; one card

It prints what those phases print, then one JSON line with phase 18's
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
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.data.synthetic import generate_formant_corpus

    t0 = time.perf_counter()
    card = chip_smoke.phase1_card_and_build()
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke._write_cache(os.path.join(tmp, "cache"))
        corpus = os.path.join(tmp, "formant", "wavs")
        tg = generate_formant_corpus(corpus, n_utterances=chip_smoke.FORMANT_UTTS, seed=0)
        SpevDataset(corpus, textgrid_dir=tg, cache_dir=os.path.join(tmp, "formant", "cache"),
                    device="cuda")
        res, k1, k1b = chip_smoke.phase18_precision_and_remat(tmp)
    print(json.dumps({"launches": res["launches"], "k1": k1, "k1b": k1b}))
    print(f"torch_phase18: {time.perf_counter() - t0:.1f} s on {card}")
