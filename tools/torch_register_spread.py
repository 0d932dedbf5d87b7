#!/usr/bin/env python3
"""Run-to-run spread of ``chip_smoke.py``'s phase 19a on one card:
``tools/torch_emotion_register_demo.py`` for `chip_smoke.REGISTER_EPOCHS`
epochs, ``--runs`` times, ``--parallel`` at once, each in its own process
and working directory.  Each run's readings (`chip_smoke.register_quality`:
the predicted F0 and frames per register, the held-out duration error in
aggregate and per emotion, and the JAX package's bars it broke) print as
one JSON line; a last line counts the runs that met each bar.

    python3 tools/torch_register_spread.py --runs 10 --parallel 5   # one card
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def one_run(i, tmp):
    work = os.path.join(tmp, f"run{i}")
    os.makedirs(work)
    out = os.path.join(work, "emotion_metrics.json")
    env = dict(os.environ, TMPDIR=work)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    with open(os.path.join(work, "run.log"), "w") as log:
        rc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                          "torch_emotion_register_demo.py"),
                             str(chip_smoke.REGISTER_EPOCHS), "--out", out],
                            cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT,
                            timeout=1800).returncode
    if rc != 0:
        with open(os.path.join(work, "run.log")) as f:
            raise RuntimeError(f"run {i} exited with {rc}:\n" + f.read()[-4000:])
    with open(out) as f:
        res = json.load(f)
    return {"run": i, "run_s": time.perf_counter() - t0, **chip_smoke.register_quality(res)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--parallel", type=int, default=5)
    args = ap.parse_args()
    from spev_tpu_torch.ops.cuda import build

    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(args.parallel) as pool:
            results = list(pool.map(lambda i: one_run(i, tmp), range(args.runs)))
    for r in results:
        print(json.dumps(r), flush=True)
    met = {bar: sum(bar not in r["broken"] for r in results) for bar in chip_smoke.REGISTER_BARS}
    print(json.dumps({"runs": len(results), "met": met,
                      "dur_err_pct_aggregate": sorted(round(r["dur_err_pct_aggregate"], 2)
                                                      for r in results),
                      "dur_err_pct_worst": sorted(max(r["dur_err_pct"].values())
                                                  for r in results)}))


if __name__ == "__main__":
    main()
