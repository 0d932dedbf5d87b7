"""In-training synthesis probes (counterpart of ``spev_tpu.diag.probes``).

Three fixed sentences go through the live acoustic model every 10 epochs;
their mel statistics are printed, with a warning on a flatline (std < 0.1)
or a mean outside [-8, 1], and each mel is saved as a PNG when matplotlib
is installed.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

TEST_TEXTS = [
    "Hello world, this is a test.",
    "The quick brown fox jumps over the lazy dog.",
    "Testing speech synthesis quality.",
]


def mel_statistics(mel: np.ndarray) -> dict:
    stats = {
        "mean": float(np.mean(mel)),
        "std": float(np.std(mel)),
        "min": float(np.min(mel)),
        "max": float(np.max(mel)),
    }
    stats["flatline_warning"] = stats["std"] < 0.1
    stats["range_warning"] = stats["mean"] > 1.0 or stats["mean"] < -8.0
    return stats


def test_inference_probe(trainer, log_dir: str, epoch: int, texts: Optional[List[str]] = None):
    """Run the probe sentences through ``trainer.model`` as it stands: a
    mel-only pass (no vocoder, no dropout) at the largest phoneme bucket of
    `Synthesizer` and the model config's frame bucket, under inference mode
    in fp32, on the trainer's device.  Prints the stats, saves
    ``test_e{epoch+1}_t{idx+1}.png`` under ``log_dir`` when matplotlib is
    installed, and returns one stats dict per probe that ran; a failing
    probe prints its error and training goes on.  Only the trainer's rank
    0 prints and writes; on a model axis every rank of its model group
    calls this (the forward is collective there)."""
    from spev_tpu_torch.diag import plots
    from spev_tpu_torch.infer.synthesis import DEFAULT_PHONEME_BUCKETS
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import Vocab, pad_to_bucket
    from spev_tpu_torch.utils.platform import fp32_precision

    texts = texts or TEST_TEXTS
    vocab = Vocab(trainer.vocab)
    g2p = G2P("auto")
    P = DEFAULT_PHONEME_BUCKETS[-1]
    M = trainer.cfg.model.max_frames
    dev = trainer.device
    say = print if trainer.is_main else (lambda *a, **k: None)
    with_png = plots.available() and trainer.is_main
    trainer.model.eval()  # as JAX's deterministic pass; a train step sets train mode again
    results = []
    for idx, text in enumerate(texts):
        try:
            ids = vocab.encode(g2p.phonemes(text), fallback=1)
            with torch.inference_mode(), fp32_precision():
                out = trainer.model(
                    torch.as_tensor(pad_to_bucket(ids, P, vocab.pad_id)[None],
                                    dtype=torch.long, device=dev),
                    torch.tensor([len(ids)], dtype=torch.int32, device=dev), M)
                L = int(out["mel_len"][0])
                mel = out["mel_pred"][0, :L].cpu().numpy()
            stats = mel_statistics(mel)
            results.append(stats)
            say(
                f"   Probe {idx + 1}: mean={stats['mean']:.2f}, std={stats['std']:.2f}, "
                f"min={stats['min']:.2f}, max={stats['max']:.2f}"
            )
            if stats["flatline_warning"]:
                say("   WARNING: very low variance - possible silence/flatline")
            if stats["range_warning"]:
                say("   WARNING: unusual mean value")
            if with_png:
                os.makedirs(log_dir, exist_ok=True)
                plots.save_mel_plot(
                    mel.T,
                    os.path.join(log_dir, f"test_e{epoch + 1}_t{idx + 1}.png"),
                    title=f"Probe epoch {epoch + 1} text {idx + 1}",
                )
        except Exception as e:  # a probe must not end a training run
            say(f"   Probe {idx + 1} failed: {e}")
    return results
