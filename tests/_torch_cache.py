"""A small feature cache written with numpy from a seed, in the layout the
JAX package's dataset build writes (``metadata.json`` + ``u_*.npz``), for the
port's batching and training tests."""

import json
import os

import numpy as np

PHONES = ["AA", "AE", "B", "D", "EH", "IY", "K", "L", "M", "N", "S", "T"]


def write_cache(cache_dir, n_utts=12, seed=0, n_mels=8, max_ph=30, max_dur=5):
    rng = np.random.default_rng(seed)
    os.makedirs(cache_dir, exist_ok=True)
    files, lengths = [], []
    for i in range(n_utts):
        n = int(rng.integers(4, max_ph + 1))
        phs = [PHONES[k] for k in rng.integers(0, len(PHONES), n)]
        durs = rng.integers(1, max_dur + 1, n).astype(np.int32)
        T = int(durs.sum())
        name = f"u_{i:05d}.npz"
        np.savez(
            os.path.join(cache_dir, name),
            phs=np.asarray(phs, dtype=object),
            durs=durs,
            mel=np.clip(rng.standard_normal((T, n_mels)) - 4.0, -10, 2).astype(np.float32),
            pitch=rng.uniform(-1, 1, n).astype(np.float32),
            energy=rng.uniform(-1, 1, n).astype(np.float32),
            breath=rng.uniform(0, 0.8, n).astype(np.float32),
            rough=rng.uniform(0, 1.5, n).astype(np.float32),
            bright=rng.uniform(-1, 1, n).astype(np.float32),
            nasal=rng.uniform(0, 1, n).astype(np.float32),
        )
        files.append(name)
        lengths.append((n, T))
    meta = {"files": files, "lengths": lengths, "speakers": [],
            "vocab": sorted(set(PHONES) | {"<PAD>", "<UNK>", "<SIL>"}),
            "stats": {"p_mean": 5.0, "p_std": 0.3, "e_mean": -3.0, "e_std": 1.0,
                      "c_mean": 7.0, "c_std": 0.5, "frames_per_phoneme": 3.0}}
    with open(os.path.join(cache_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return cache_dir
