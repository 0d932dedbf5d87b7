"""The dashboard trajectory on the card: the port's counterpart of
``tools/quality_trajectory.py``, with its setup and output
(`spev_tpu_torch.diag.convergence`).

Trains the formant setup (120 utterances, hidden 96, ``vp_output_norm``
off) for ``epochs`` and prints one JSON line an epoch: epoch, train loss,
val loss, val MCD and duration error.

    python tools/torch_quality_trajectory.py [epochs] [--device cuda] > traj.jsonl
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(epochs: int = 150, device="cuda", **sizes) -> list:
    """Train and print; returns the rows.  ``sizes`` (``n_utterances``,
    ``work``) cut the run for a test."""
    from spev_tpu_torch.diag import convergence as cv

    def on_epoch(epoch, row):
        print(json.dumps({"epoch": epoch, "loss": round(row["loss"], 4),
                          "val": round(row["val"], 4), "mcd": round(row["mcd"], 2),
                          "durerr": round(row["durerr"], 2)}), flush=True)

    s = cv.build_quality_setup(epochs, device=device, **sizes)
    return cv.run_dashboard(s, epochs, on_epoch=on_epoch)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("epochs", nargs="?", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.epochs, a.device)
