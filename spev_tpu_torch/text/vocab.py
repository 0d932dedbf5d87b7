"""Phoneme vocabulary with the reference's conventions.

The vocab is ``sorted(set(marks) | {'<PAD>', '<UNK>', '<SIL>'})`` — the
specials are not pinned to fixed indices; ``'<PAD>'`` sorts first (index 0,
the embedding's padding row) because ``'<'`` precedes alphanumerics.
Inference looks unknown marks up as index 1.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from spev_tpu_torch.errors import UserError

PAD = "<PAD>"
UNK = "<UNK>"
SIL = "<SIL>"
SPECIALS = (PAD, UNK, SIL)


class Vocab:
    def __init__(self, symbols: Sequence[str]):
        """symbols: the full sorted vocab list (as stored in checkpoints)."""
        self.symbols: List[str] = list(symbols)
        self._index = {s: i for i, s in enumerate(self.symbols)}

    @staticmethod
    def build(marks: Iterable[str]) -> "Vocab":
        """Reference construction: sorted union with the three specials."""
        return Vocab(sorted(set(marks) | set(SPECIALS)))

    def __len__(self) -> int:
        return len(self.symbols)

    @property
    def pad_id(self) -> int:
        return self._index.get(PAD, 0)

    @property
    def sil_id(self) -> int:
        return self._index.get(SIL, 0)

    def encode(self, phones: Sequence[str], fallback: int = 1) -> np.ndarray:
        """Phoneme marks → int32 IDs (fallback=1 is the inference path)."""
        return np.asarray([self._index.get(p, fallback) for p in phones], dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.symbols[int(i)] for i in ids]


def pad_to_bucket(ids: np.ndarray, bucket: int, pad_id: int = 0) -> np.ndarray:
    """Right-pad a 1-D id array to the static phoneme bucket."""
    if len(ids) > bucket:
        raise UserError(f"utterance has {len(ids)} phonemes > bucket {bucket}")
    out = np.full((bucket,), pad_id, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise UserError(f"length {n} exceeds largest bucket {max(buckets)}")
