"""The feature cache that training reads (the cache half of
``spev_tpu.data.dataset.SpevDataset``).

A cache directory holds ``metadata.json`` — ``files`` (the ``u_*.npz``
basenames), ``stats`` (pitch/energy/centroid normalisation and
``frames_per_phoneme``), ``vocab``, ``speakers``, optionally ``emotions``
and ``lengths`` (per-utterance (n_phonemes, n_frames)) — and one npz per
utterance with ``phs``, ``durs`` (int32), ``mel`` (n_frames, n_mels) and the
per-phoneme ``pitch``, ``energy``, ``breath``, ``rough``, ``bright`` and
``nasal`` targets.  The JAX package's dataset build and
``spev_tpu.data.cache_import`` write it.  Building a cache (feature
extraction, kernel K2) is not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np

from spev_tpu_torch.errors import UserError


class SpevDataset:
    """An existing per-utterance npz feature cache."""

    def __init__(self, cache_dir: str = "cache_spev"):
        """Raises `UserError` when ``cache_dir`` holds no usable cache."""
        self.cache_dir = cache_dir
        meta_path = os.path.join(cache_dir, "metadata.json")
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        # an empty file list is the footprint of a build that crashed
        if not meta or not meta.get("files"):
            raise UserError(
                f"no usable feature cache at {cache_dir} (metadata.json with a "
                "non-empty file list): building a cache (feature extraction, kernel "
                "K2) is not ported to PyTorch yet; build it with the JAX package "
                "(python -m spev_tpu.cli.spev_tts) or import one with "
                "spev_tpu.data.cache_import"
            )
        self.files = meta["files"]
        self.stats = meta["stats"]
        self.vocab = meta["vocab"]
        self.speakers = meta.get("speakers", [])
        self.emotions = meta.get("emotions", [])
        # None for caches built before the field existed: the batcher loads
        self.lengths = meta.get("lengths")

    def __len__(self):
        return len(self.files)

    def _resolve(self, entry: str) -> str:
        # metadata stores basenames; older caches stored full paths
        if os.path.exists(entry):
            return entry
        return os.path.join(self.cache_dir, os.path.basename(entry))

    def load_utterance(self, idx: int) -> dict:
        with np.load(self._resolve(self.files[idx]), allow_pickle=True) as u:
            return {k: u[k] for k in u.files if k != "allow_pickle"}
