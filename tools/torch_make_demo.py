"""The audio demo on the card: the port's counterpart of
``tools/make_demo.py``, with its setup and outputs
(`spev_tpu_torch.diag.convergence`).

Trains the formant setup (120 utterances, hidden 96, ``vp_output_norm``
off) for ``epochs``, then synthesizes the first three held-out utterances
free-running from their phonemes (Griffin-Lim) and writes, per utterance,
``val{j}_gt.wav`` (the corpus wav), ``val{j}_synth.wav``, with
``--gan_checkpoint`` (a ``gen_*.spev`` from ``cli.vocoder``) also
``val{j}_synth_gan.wav``, and ``val{j}_mels.png`` (with matplotlib), then
``demo_metrics.json`` (per-utterance frames and MCD, the final dashboard).
Outputs go under ``.scratch/demo`` by default, never ``docs/demo``.

    python tools/torch_make_demo.py [epochs] [out_dir] \\
        [--gan_checkpoint gen_*.spev [--gan_config v3]] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(epochs: int = 150, out_dir: str = ".scratch/demo", gan_checkpoint: str = None,
         gan_config: str = "v3", device="cuda", **sizes) -> dict:
    """Train, synthesize and write; returns the metrics.  ``sizes``
    (``n_utterances``, ``work``) cut the run for a test."""
    from spev_tpu_torch.diag import convergence as cv

    s = cv.build_quality_setup(epochs, device=device, **sizes)
    cv.run_dashboard(s, epochs, on_epoch=cv.progress(epochs))
    return cv.write_demo(s, out_dir, gan_checkpoint=gan_checkpoint, gan_config=gan_config)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("epochs", nargs="?", type=int, default=150)
    ap.add_argument("out_dir", nargs="?", default=".scratch/demo")
    ap.add_argument("--gan_checkpoint", default=None,
                    help="gen_*.spev from cli.vocoder; also writes {utt}_synth_gan.wav "
                         "(full trained pipeline)")
    ap.add_argument("--gan_config", default="v3", choices=["v1", "v3"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.epochs, a.out_dir, gan_checkpoint=a.gan_checkpoint, gan_config=a.gan_config,
         device=a.device)
