"""Calibrate the convergence gate on the card: the port's counterpart of
``tools/gate_calibration.py``, with its setup, arguments and JSON line
(`spev_tpu_torch.diag.convergence`).

Builds the formant setup (120 utterances, hidden 96, ``vp_output_norm``
off, B=16, a 90/10 split) on the device, trains it for ``--epochs`` with
the dashboard read every epoch (a line to stderr every 5), runs every
held-out utterance free-running (predicted durations, Griffin-Lim) and
prints the gate metrics as one JSON line: epoch 0's MCD, the last 5
epochs' median and its ratio, the last 3 epochs' median duration error,
the free-running frame errors' median and max, and the first- and
last-third medians of MCD, duration error and val loss.  ``--lr_mult``
perturbs the learning rate: the gate is only trustworthy if a deliberate
10 % perturbation (``--lr_mult 1.1``) degrades a bounded metric past its
bar (`convergence.gate_failures`).

    python tools/torch_gate_calibration.py [--epochs 45] [--lr_mult 1.0] [--device cuda]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(epochs: int = 45, lr_mult: float = 1.0, device="cuda", **sizes) -> dict:
    """Train, run free, print and return the summary; ``sizes``
    (``n_utterances``, ``work``) cut the run for a test."""
    from spev_tpu_torch.diag import convergence as cv

    s = cv.build_quality_setup(epochs, lr_mult=lr_mult, device=device, **sizes)

    def on_epoch(epoch, row):
        if epoch % 5 == 0 or epoch == epochs - 1:
            print(f"# epoch {epoch}: val {row['val']:.3f} mcd {row['mcd']:.1f} "
                  f"durerr {row['durerr']:.1f}%", file=sys.stderr, flush=True)

    hist = cv.run_dashboard(s, epochs, on_epoch=on_epoch)
    errs = cv.freerun_frame_errors(s.trainer, s.ds, s.vocab, s.cfg, s.va_idx,
                                   device=s.trainer.device)
    summary = cv.gate_summary(hist, errs, epochs, lr_mult)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=45)
    ap.add_argument("--lr_mult", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.epochs, a.lr_mult, a.device)
