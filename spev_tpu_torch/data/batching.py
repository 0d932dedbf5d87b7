"""Bucketed batching: cached utterances → padded numpy batches of a few
static shapes (phoneme bucket × frame bucket).  Own copy of
``spev_tpu.data.batching``; numpy only, so the batches equal the JAX
package's.  Batches carry every loss input, including each sample's target
frame count (``mel_lens``) for the reference's batch-max mel denominator.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from spev_tpu_torch.errors import UserError
from spev_tpu_torch.text.vocab import Vocab, pick_bucket

_LOAD_THREADS = 4  # npz loads are I/O and memcpy that release the GIL


def collate(
    utterances: List[dict],
    vocab: Vocab,
    max_phonemes: int,
    max_frames: int,
    n_mels: int = 80,
) -> Dict[str, np.ndarray]:
    """Pad a list of cached utterances to static buckets: ids via the vocab
    with fallback 0, ``log_durs = log(max(durs, 1) + 1)``, zero padding
    everywhere (the reference's collate)."""
    B = len(utterances)
    out = {
        "ids": np.zeros((B, max_phonemes), np.int32),
        "lens": np.zeros((B,), np.int32),
        "durs": np.zeros((B, max_phonemes), np.float32),
        "log_durs": np.zeros((B, max_phonemes), np.float32),
        "mel": np.zeros((B, max_frames, n_mels), np.float32),
        "mel_lens": np.zeros((B,), np.int32),
        "pitch": np.zeros((B, max_phonemes), np.float32),
        "energy": np.zeros((B, max_phonemes), np.float32),
        "breath": np.zeros((B, max_phonemes), np.float32),
        "rough": np.zeros((B, max_phonemes), np.float32),
        "bright": np.zeros((B, max_phonemes), np.float32),
    }
    if all("nasal" in u for u in utterances):
        # caches built before the nasality channel omit the key
        out["nasal"] = np.zeros((B, max_phonemes), np.float32)
    if any("speaker_id" in u for u in utterances):
        out["speaker_ids"] = np.zeros((B,), np.int32)
    if all("vad" in u for u in utterances):
        out["vad"] = np.zeros((B, 3), np.float32)
    for b, u in enumerate(utterances):
        if "speaker_ids" in out and "speaker_id" in u:
            out["speaker_ids"][b] = int(u["speaker_id"])
        if "vad" in out:
            out["vad"][b] = u["vad"]
        phs = [str(p) for p in u["phs"]]
        n = len(phs)
        t = int(u["mel"].shape[0])
        if n > max_phonemes or t > max_frames:
            raise UserError(f"utterance exceeds bucket: {n} ph / {t} frames")
        out["ids"][b, :n] = vocab.encode(phs, fallback=0)
        out["lens"][b] = n
        durs = np.asarray(u["durs"], np.float32)
        out["durs"][b, :n] = durs
        out["log_durs"][b, :n] = np.log(np.maximum(durs, 1.0) + 1.0)
        out["mel"][b, :t] = u["mel"]
        out["mel_lens"][b] = t
        for k in ("pitch", "energy", "breath", "rough", "bright"):
            out[k][b, :n] = u[k]
        if "nasal" in out:
            out["nasal"][b, :n] = u["nasal"]
    return out


class BucketBatcher:
    """Deterministic shuffled batching grouped by length buckets."""

    def __init__(
        self,
        dataset,
        vocab: Vocab,
        batch_size: int = 16,
        phoneme_buckets: Sequence[int] = (64, 128, 256),
        frame_buckets: Sequence[int] = (256, 512, 1024, 2048),
        n_mels: int = 80,
        indices: Optional[Sequence[int]] = None,
        drop_remainder: bool = False,
        seed: int = 0,
    ):
        self.ds = dataset
        self.vocab = vocab
        self.batch_size = batch_size
        self.phoneme_buckets = tuple(sorted(phoneme_buckets))
        self.frame_buckets = tuple(sorted(frame_buckets))
        self.n_mels = n_mels
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))
        self.drop_remainder = drop_remainder
        self.seed = seed
        # bucket keys from the cache metadata's per-utterance lengths when
        # present, else by loading each utterance once
        lengths = getattr(dataset, "lengths", None)
        self._keys = {}
        for i in self.indices:
            if lengths is not None and i < len(lengths) and lengths[i] is not None:
                n, t = int(lengths[i][0]), int(lengths[i][1])
            else:
                u = self.ds.load_utterance(i)
                n, t = len(u["phs"]), int(u["mel"].shape[0])
            try:
                self._keys[i] = (pick_bucket(n, self.phoneme_buckets),
                                 pick_bucket(t, self.frame_buckets))
            except ValueError:
                self._keys[i] = None  # over-long: dropped

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch)
        order = [i for i in self.indices if self._keys[i] is not None]
        rng.shuffle(order)
        groups: Dict[tuple, list] = {}
        for i in order:
            groups.setdefault(self._keys[i], []).append(i)
            g = groups[self._keys[i]]
            if len(g) == self.batch_size:
                yield self._emit(g)
                groups[self._keys[i]] = []
        for g in groups.values():
            if g and not self.drop_remainder:
                # pad the final partial batch by repeating samples so the
                # shapes stay static
                while len(g) < self.batch_size:
                    g.append(g[len(g) % max(1, len(g))])
                yield self._emit(g)

    def _emit(self, idxs: list) -> Dict[str, np.ndarray]:
        P, M = self._keys[idxs[0]]
        with ThreadPoolExecutor(max_workers=_LOAD_THREADS) as pool:
            utts = list(pool.map(self.ds.load_utterance, idxs))
        return collate(utts, self.vocab, P, M, self.n_mels)


def train_val_split(n: int, val_fraction: float = 0.05, seed: int = 0):
    """The reference's 95/5 random split: (train indices, val indices)."""
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    val = max(1, int(n * val_fraction)) if n > 1 else 0
    return idx[val:], idx[:val]
