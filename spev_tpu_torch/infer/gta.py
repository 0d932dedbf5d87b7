"""Ground-truth-aligned (GTA) mels for vocoder fine-tuning — counterpart of
``spev_tpu.infer.gta``.

The upstream LJ_FT workflow fine-tunes HiFi-GAN on the mels the acoustic
model actually produces.  Teacher-forced forwards (target durations and
every variance target from the feature cache) give each predicted mel the
frame count of its ground-truth waveform, so ``python -m
spev_tpu_torch.cli.vocoder --gta_checkpoint`` trains on (predicted mel,
ground-truth audio) pairs.  The length regulator of each forward is the
kernel K1 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.data.batching import collate
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.text.vocab import Vocab, pick_bucket
from spev_tpu_torch.utils.params import read_checkpoint, unpack_checkpoint
from spev_tpu_torch.utils.platform import fp32_precision, resolve_device

_TRACKS = ("pitch", "energy", "breath", "rough", "bright", "nasal")


@torch.inference_mode()
def compute_gta_mels(
    checkpoint: str,
    ds,
    model_cfg: Optional[ModelConfig] = None,
    batch_size: int = 8,
    phoneme_buckets: Sequence[int] = (64, 128, 256),
    frame_buckets: Sequence[int] = (256, 512, 1024, 2048),
    device="cuda",
) -> Dict[int, np.ndarray]:
    """Teacher-forced predicted mels for every utterance of ``ds`` (anything
    with ``__len__``, ``lengths`` and ``load_utterance``), from a ``.pt`` or
    ``.spev`` acoustic checkpoint.

    Returns {dataset index: (T, n_mels) float32}, T the utterance's
    ground-truth frame count.  Utterances are grouped by (phoneme, frame)
    bucket and run in batches of ``batch_size`` (the last one padded with
    its first utterance), deterministic, in fp32.  Utterances longer than
    the largest bucket are skipped and reported.  device: "cuda" (the
    default) raises without a GPU."""
    dev = resolve_device(device)
    ckpt = read_checkpoint(checkpoint)
    sd, vocab_list, _stats = unpack_checkpoint(ckpt)
    vocab = Vocab(vocab_list)
    if model_cfg is None:
        stored = ckpt.get("model_config")
        model_cfg = ModelConfig.from_dict(stored) if stored else ModelConfig()
    model_cfg = dataclasses.replace(model_cfg, vocab_size=len(vocab))
    model = FastSpeech2(model_cfg)
    model.load_state_dict(sd)
    model.to(dev).eval()

    lengths = getattr(ds, "lengths", None)
    groups: Dict[tuple, list] = {}
    skipped = []
    for i in range(len(ds)):
        if lengths is not None and i < len(lengths) and lengths[i] is not None:
            n, t = int(lengths[i][0]), int(lengths[i][1])
        else:
            u = ds.load_utterance(i)
            n, t = len(u["phs"]), int(u["mel"].shape[0])
        try:
            key = (pick_bucket(n, phoneme_buckets), pick_bucket(t, frame_buckets))
        except ValueError:
            skipped.append(i)
            continue
        groups.setdefault(key, []).append(i)
    if skipped:
        print(f"gta: {len(skipped)} utterances exceed the largest bucket — skipped")

    def tensor(v, dtype=torch.float32):
        return None if v is None else torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    mels: Dict[int, np.ndarray] = {}
    with fp32_precision():
        for (P, M), idxs in sorted(groups.items()):
            for start in range(0, len(idxs), batch_size):
                g = idxs[start : start + batch_size]
                pad = g + [g[0]] * (batch_size - len(g))  # the bucket's batch shape
                b = collate([ds.load_utterance(i) for i in pad], vocab, P, M, model_cfg.n_mels)
                out = model(tensor(b["ids"], torch.long), tensor(b["lens"], torch.int32), M,
                            target_durations=tensor(b["durs"]),
                            **{f"target_{k}": tensor(b.get(k)) for k in _TRACKS})
                mel = out["mel_pred"].float().cpu().numpy()
                mel_len = out["mel_len"].cpu().numpy()
                for row, i in enumerate(g):
                    mels[i] = mel[row, : int(mel_len[row])]
    return mels
