"""Multi-speaker evidence on the card: the learned speaker embedding
reproduces the speakers' F0 registers.  The port's counterpart of
``tools/multispeaker_demo.py``, with its setup and arguments
(`spev_tpu_torch.diag.evidence.train_multispeaker`):

1. a 150-utterance formant corpus with 3 deterministic voices (F0 registers
   ~0.72x / 1.0x / 1.39x, formant scaling 0.90x / 1.0x / 1.10x), its cache
   built on the device with speaker labels;
2. the advanced model (hidden/embed 96, a speaker table) trained at the
   emotion run's recipe;
3. held-out evaluation per speaker, then the identity proof: the same text
   as each speaker, the voiced F0 of the audio, which must rise from
   speaker 0 to speaker 2.

    python tools/torch_multispeaker_demo.py [epochs] \\
        [--out .scratch/demo/multispeaker_metrics.json] [--wav_dir DIR] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(epochs: int = 150, out_path: str = ".scratch/demo/multispeaker_metrics.json",
         wav_dir: str = None, device="cuda", **sizes) -> dict:
    """Train and measure; ``sizes`` (``n_utterances``, ``hidden``, ``work``)
    cut the run for a test."""
    from spev_tpu_torch.diag.evidence import train_multispeaker

    return train_multispeaker(epochs, out_path, wav_dir=wav_dir, device=device, **sizes)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("epochs", nargs="?", type=int, default=150)
    ap.add_argument("--out", default=".scratch/demo/multispeaker_metrics.json")
    ap.add_argument("--wav_dir", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.epochs, a.out, wav_dir=a.wav_dir, device=a.device)
