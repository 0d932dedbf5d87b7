"""Import the reference's preprocessed training cache — counterpart of
``spev_tpu.data.cache_import``.

The reference writes one torch pickle per utterance, ``u_{i:05d}.pt``
(keys ``phs/durs/mel/pitch/energy/breath/rough/bright``, mel ``(T,
n_mels)``), and a ``metadata.json`` with ``files/stats/vocab``.  Its
documented ``spev_tts`` surface also names a monolithic
``proper_cache_strict.pt`` of unknown layout; `import_monolithic_cache`
accepts the plausible ones (a list of utterance dicts, or a dict with an
``utterances``/``files``/``data`` list) and the long key forms
``phonemes``/``durations``.  Both write the npz cache of
``data.dataset`` (one ``u_*.npz`` per usable utterance and
``metadata.json``), so the port's trainer (or the JAX package's) reads it:

    python -m spev_tpu_torch.cli.convert cache cache_stable/ cache_spev/

The pickles are read with ``torch.load(weights_only=True)``.  They hold
numpy arrays beside tensors, so exactly the numpy globals an array or a
numpy scalar needs are allowed (`_numpy_globals`), and nothing else.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np
import torch

from spev_tpu_torch.errors import UserError

_FEATURE_KEYS = ("pitch", "energy", "breath", "rough", "bright")

_KEY_ALIASES = {
    # the monolithic cache belongs to a module absent from the reference,
    # so its field names are unknowable: accept the engine's and the long forms
    "phs": ("phs", "phonemes"),
    "durs": ("durs", "durations"),
}


def _numpy_globals() -> list:
    """The globals a pickled numpy array, dtype or scalar refers to, under
    numpy 2's (``numpy._core``) and numpy 1's (``numpy.core``) module names."""
    try:
        from numpy._core import multiarray
    except ImportError:  # numpy 1
        from numpy.core import multiarray
    out = [np.ndarray, np.dtype]
    for fn in (multiarray._reconstruct, multiarray.scalar):
        for mod in ("numpy._core.multiarray", "numpy.core.multiarray"):
            out.append((fn, f"{mod}.{fn.__name__}"))
    dtypes = getattr(np, "dtypes", None)  # numpy >= 1.25
    if dtypes is not None:
        for name in ("Float16DType", "Float32DType", "Float64DType", "Int8DType", "Int16DType",
                     "Int32DType", "Int64DType", "UInt8DType", "BoolDType", "StrDType"):
            if hasattr(dtypes, name):
                out.append(getattr(dtypes, name))
    return out


def load_pickle(path: str):
    """A reference ``.pt`` pickle, read with ``weights_only=True`` onto the
    CPU, numpy arrays allowed."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"reference cache not found: {path}")
    with torch.serialization.safe_globals(_numpy_globals()):
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:  # a truncated file or a disallowed global
            raise UserError(f"{path}: cannot read it as a reference cache pickle "
                            f"({type(e).__name__}: {str(e).splitlines()[0][:200]})") from None


def _get(u: dict, key: str):
    for k in _KEY_ALIASES.get(key, (key,)):
        if k in u:
            return u[k]
    raise KeyError(key)


def _array(v, dtype) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


def _write_utterance(out_dir: str, name: str, u: dict) -> Optional[str]:
    """One reference cache entry → one npz entry (the field layout of
    ``data.dataset``), or None when a field is missing or inconsistent."""
    try:
        phs = [str(p) for p in _get(u, "phs")]
        durs = _array(_get(u, "durs"), np.int32)
        mel = _array(u["mel"], np.float32)  # (T, n_mels) on both sides
        if mel.ndim != 2 or len(phs) != len(durs) or int(durs.sum()) != mel.shape[0]:
            return None
        data = {"phs": np.asarray(phs, dtype=object), "durs": durs, "mel": mel}
        for k in _FEATURE_KEYS:
            v = _array(u[k], np.float32)
            if v.shape != (len(phs),):
                return None
            data[k] = v
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez(path, **data)
        return path
    except (KeyError, ValueError, TypeError):
        return None


def _write_metadata(out_dir: str, files, stats, vocab) -> dict:
    meta = {"files": files, "stats": dict(stats), "vocab": list(vocab), "speakers": []}
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return meta


def import_reference_cache(ref_cache_dir: str, out_cache_dir: str) -> dict:
    """A reference ``cache_stable``-style directory → an npz cache
    directory.  Returns the written metadata (files, stats, vocab,
    speakers).  An npz cache (already this format) is refused."""
    meta_path = os.path.join(ref_cache_dir, "metadata.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no metadata.json in {ref_cache_dir}")
    with open(meta_path) as f:
        ref_meta = json.load(f)
    listed = ref_meta.get("files") or sorted(glob.glob(os.path.join(ref_cache_dir, "u_*.pt")))
    if any(str(e).endswith(".npz") for e in listed):
        raise UserError(f"{ref_cache_dir} is already a spev_tpu npz cache — nothing to convert; "
                        "point training at it directly (its metadata.json is the native format)")
    os.makedirs(out_cache_dir, exist_ok=True)
    files = []
    for entry in listed:
        src = entry if os.path.exists(entry) else os.path.join(ref_cache_dir,
                                                               os.path.basename(entry))
        if not os.path.exists(src):
            continue
        name = os.path.splitext(os.path.basename(src))[0]
        path = _write_utterance(out_cache_dir, name, load_pickle(src))
        if path:
            files.append(os.path.basename(path))
    return _write_metadata(out_cache_dir, files, ref_meta["stats"], ref_meta["vocab"])


def import_monolithic_cache(path: str, out_cache_dir: str) -> dict:
    """A monolithic ``proper_cache_strict.pt`` → an npz cache directory
    (best effort; accepted layouts in the module docstring).  Raises a
    `UserError` for an unknown layout or when every entry is rejected."""
    obj = load_pickle(path)
    utts = None
    stats, vocab = {}, None
    if isinstance(obj, list):
        utts = obj
    elif isinstance(obj, dict):
        for k in ("utterances", "files", "data"):
            if isinstance(obj.get(k), list) and obj[k] and isinstance(obj[k][0], dict):
                utts = obj[k]
                break
        stats = dict(obj.get("stats") or {})
        vocab = obj.get("vocab")
    if utts is None:
        raise UserError(
            f"{path}: unrecognized monolithic cache layout ({type(obj).__name__}; expected a "
            "list of utterance dicts or a dict with an 'utterances'/'files'/'data' list)")
    os.makedirs(out_cache_dir, exist_ok=True)
    files, vocab_set = [], set()
    for i, u in enumerate(utts):
        p = _write_utterance(out_cache_dir, f"u_{i:05d}", u)
        if p:
            files.append(os.path.basename(p))
            vocab_set.update(str(x) for x in _get(u, "phs"))
    if not files:
        raise UserError(
            f"{path}: recognized the cache layout but every one of the {len(utts)} utterance "
            "entries was rejected (missing/inconsistent fields: need phs|phonemes, "
            "durs|durations, mel with sum(durs) == mel frames, and per-phoneme "
            "pitch/energy/breath/rough/bright)")
    if vocab is None:
        vocab = sorted(vocab_set | {"<PAD>", "<UNK>", "<SIL>"})
    return _write_metadata(out_cache_dir, files, stats, vocab)
