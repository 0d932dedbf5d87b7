"""Trainable-VAD evidence on the card: the learned emotion embedding
reproduces the corpus's per-emotion prosody registers.  The port's
counterpart of ``tools/emotion_register_demo.py``, with its setup and
arguments (`spev_tpu_torch.diag.evidence.train_emotion_registers`):

1. a 160-utterance emotion-conditioned formant corpus (seed 0; neutral,
   happy, sad, angry, each with its log-linear VAD→prosody register), its
   cache built on the device with emotion-VAD labels (``stats_sample`` 60);
2. the advanced model (hidden/embed 96, ``use_vad``, per-phoneme
   predictors) trained at B=16, lr 2e-3, 50 warmup steps, 2 duration-only
   epochs, a 0.1 held-out split, validating every epoch;
3. the register proof: the same phonemes under each emotion's (V, A, D)
   through the learned embedding only, the predicted F0 and the frames,
   and the held-out rows per emotion.

    python tools/torch_emotion_register_demo.py [epochs] \\
        [--out .scratch/demo/emotion_metrics.json] [--wav_dir DIR] \\
        [--measure_only CKPT] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(epochs: int = 150, out_path: str = ".scratch/demo/emotion_metrics.json",
         wav_dir: str = None, device="cuda", **sizes) -> dict:
    """Train and measure; ``sizes`` (``n_utterances``, ``hidden``, ``work``)
    cut the run for a test."""
    from spev_tpu_torch.diag.evidence import train_emotion_registers

    return train_emotion_registers(epochs, out_path, wav_dir=wav_dir, device=device, **sizes)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("epochs", nargs="?", type=int, default=150)
    ap.add_argument("--out", default=".scratch/demo/emotion_metrics.json")
    ap.add_argument("--wav_dir", default=None)
    ap.add_argument("--measure_only", default=None, metavar="CKPT",
                    help="skip training; re-run the register measurement on an existing "
                         "advanced checkpoint")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.measure_only:
        from spev_tpu_torch.diag.evidence import measure_registers

        measure_registers(a.measure_only, a.out, wav_dir=a.wav_dir, device=a.device)
    else:
        main(a.epochs, a.out, wav_dir=a.wav_dir, device=a.device)
