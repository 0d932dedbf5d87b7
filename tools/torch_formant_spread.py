#!/usr/bin/env python3
"""Run-to-run spread of ``chip_smoke.py``'s phase 16b on one card: the
same ``cli.train`` under ``torch.distributed.run`` on the same formant
corpus (seed 0), ``--runs`` times, ``--parallel`` at once, each with its
own feature cache and checkpoints.  Each run's quality readings
(`chip_smoke.formant_quality`: epoch 0's and the last epoch's val MCD and
their ratio against phase 16b's bar, and the first-third and last-third
medians of the val MCD, duration error and val mel loss) print as one JSON
line; a last line counts the runs that met each bar.

    python3 tools/torch_formant_spread.py --runs 9 --parallel 3   # one card
"""

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def one_run(i, corpus, tg, tmp):
    work = os.path.join(tmp, f"run{i}")
    os.makedirs(work)
    t0 = time.perf_counter()
    rc, out = chip_smoke._launch("spev_tpu_torch.cli.train",
                                 chip_smoke._formant_train_args(corpus, tg,
                                                                os.path.join(work, "cache")),
                                 work, os.path.join(work, "train.log"))
    if rc != 0:
        raise RuntimeError(f"run {i}: cli.train exited with {rc}:\n" + out[-4000:])
    rows = [json.loads(line) for line in open(os.path.join(work, "logs", "formant",
                                                              "metrics.jsonl"))]
    return {"run": i, "run_s": time.perf_counter() - t0, **chip_smoke.formant_quality(rows)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--parallel", type=int, default=3)
    args = ap.parse_args()
    from spev_tpu_torch.data.synthetic import generate_formant_corpus

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "wavs")
        tg = generate_formant_corpus(corpus, n_utterances=chip_smoke.FORMANT_UTTS, seed=0)
        with ThreadPoolExecutor(args.parallel) as pool:
            results = list(pool.map(lambda i: one_run(i, corpus, tg, tmp), range(args.runs)))
    for r in results:
        print(json.dumps(r), flush=True)
    met = {bar: sum(bar not in r["broken"] for r in results)
           for bar in chip_smoke.FORMANT_BARS}
    print(json.dumps({"runs": len(results), "met": met,
                      "mcd_last_db": sorted(round(r["mcd_last"], 2) for r in results)}))


if __name__ == "__main__":
    main()
