"""Seed a ``tools/torch_gta_demo.py`` work dir from an existing acoustic
checkpoint, its corpus and its feature cache: the port's counterpart of
``tools/prep_gta_work.py``, with its arguments and layout
(`spev_tpu_torch.diag.vocoder_evidence.prepare_gta_work`): ``acoustic.spev``,
``corpus/``, ``corpus_train/`` (the train split only, so the held-out
utterances stay out of both fine-tune arms) and ``meta.json`` (``va_idx``
under the CLI's split).

    python tools/torch_prep_gta_work.py --work .scratch/gta_r4 \\
        --acoustic checkpoints/q256/best.spev \\
        --corpus .scratch/quality/corpus --cache .scratch/quality/cache \\
        [--val_fraction 0.05] [--seed 0] [--device cuda]

The cache is read without a device; ``--device`` builds a missing one.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(work: str, acoustic: str, corpus: str, cache: str, val_fraction: float = 0.05,
         seed: int = 0, device="cuda") -> dict:
    from spev_tpu_torch.diag.vocoder_evidence import prepare_gta_work

    return prepare_gta_work(work, acoustic, corpus, cache, val_fraction=val_fraction, seed=seed,
                            device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True)
    ap.add_argument("--acoustic", required=True)
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--cache", required=True)
    ap.add_argument("--val_fraction", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.work, a.acoustic, a.corpus, a.cache, a.val_fraction, a.seed, a.device)
