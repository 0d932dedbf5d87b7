"""The reference-cache import in the port against the JAX package, on the
CPU, mirroring ``tests/test_cache_import.py``: a cache in the reference's
on-disk format (per-utterance torch pickles holding tensors and numpy
arrays, and ``metadata.json``) imported by both packages gives the same npz
files; the monolithic layouts, the long key aliases, garbage and an npz
cache are handled as JAX handles them; ``cli.convert cache`` writes the
cache; and one port ``Trainer`` step runs on an imported cache.
"""

import json
import os

import numpy as np
import pytest
import torch

from spev_tpu.data import cache_import as jax_import
from spev_tpu_torch.cli.convert import main as convert_main
from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.data.batching import BucketBatcher
from spev_tpu_torch.data.cache_import import import_monolithic_cache, import_reference_cache
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.text.vocab import Vocab
from spev_tpu_torch.train.trainer import Trainer

NMEL = 8


def _ref_utt(rng, n_ph=6):
    durs = rng.integers(1, 5, size=n_ph).tolist()
    T = int(sum(durs))
    return {
        "phs": ["<SIL>"] + [chr(97 + i) for i in range(n_ph - 2)] + ["<SIL>"],
        "durs": durs,
        "mel": torch.from_numpy(
            np.clip(rng.standard_normal((T, NMEL)) - 4, -10, 2).astype(np.float32)),
        "pitch": rng.standard_normal(n_ph).astype(np.float32),
        "energy": rng.standard_normal(n_ph).astype(np.float32),
        "breath": rng.uniform(0, 0.8, n_ph).astype(np.float32),
        "rough": rng.uniform(0, 1.5, n_ph).astype(np.float32),
        "bright": rng.standard_normal(n_ph).astype(np.float32),
    }


@pytest.fixture
def ref_cache(tmp_path):
    rng = np.random.default_rng(0)
    cache = tmp_path / "cache_stable"
    cache.mkdir()
    files, vocab, utts = [], {"<PAD>", "<UNK>", "<SIL>"}, []
    for i in range(5):
        u = _ref_utt(rng)
        utts.append(u)
        p = str(cache / f"u_{i:05d}.pt")
        torch.save(u, p)
        files.append(p)
        vocab.update(u["phs"])
    stats = {"p_mean": 4.7, "p_std": 0.3, "e_mean": -3.1, "e_std": 1.1,
             "c_mean": 7.5, "c_std": 0.4}
    with open(cache / "metadata.json", "w") as f:
        json.dump({"files": files, "stats": stats, "vocab": sorted(vocab)}, f)
    return str(cache), utts, stats


def _assert_same_cache(a, b, meta_a, meta_b):
    assert meta_a == meta_b
    for name in meta_a["files"]:
        with np.load(os.path.join(a, name), allow_pickle=True) as x, \
                np.load(os.path.join(b, name), allow_pickle=True) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_import_reference_cache_matches_jax(ref_cache, tmp_path):
    src, utts, stats = ref_cache
    meta = import_reference_cache(src, str(tmp_path / "ours"))
    ref = jax_import.import_reference_cache(src, str(tmp_path / "jax"))
    _assert_same_cache(str(tmp_path / "ours"), str(tmp_path / "jax"), meta, ref)
    assert len(meta["files"]) == 5 and meta["stats"] == stats and meta["speakers"] == []
    with open(tmp_path / "ours" / "metadata.json") as f:
        assert json.load(f) == meta
    u0 = np.load(tmp_path / "ours" / meta["files"][0], allow_pickle=True)
    np.testing.assert_array_equal(u0["mel"], utts[0]["mel"].numpy())
    np.testing.assert_array_equal(u0["pitch"], utts[0]["pitch"])
    assert [str(p) for p in u0["phs"]] == utts[0]["phs"]
    np.testing.assert_array_equal(u0["durs"], utts[0]["durs"])


@pytest.mark.parametrize("layout", ["dict", "list"])
def test_import_monolithic_cache_matches_jax(ref_cache, tmp_path, layout):
    _, utts, _ = ref_cache
    mono = str(tmp_path / "proper_cache_strict.pt")
    if layout == "dict":
        torch.save({"utterances": utts, "stats": {"p_mean": 0.0},
                    "vocab": sorted({p for u in utts for p in u["phs"]} | {"<PAD>", "<UNK>"})},
                   mono)
    else:
        torch.save(utts, mono)
    meta = import_monolithic_cache(mono, str(tmp_path / "ours"))
    ref = jax_import.import_monolithic_cache(mono, str(tmp_path / "jax"))
    _assert_same_cache(str(tmp_path / "ours"), str(tmp_path / "jax"), meta, ref)
    assert len(meta["files"]) == 5


def test_alias_keys_and_loud_empty(tmp_path):
    def utt(n_ph=6, T=18):
        return {"phonemes": [chr(ord("a") + j) for j in range(n_ph)],
                "durations": torch.full((n_ph,), T // n_ph, dtype=torch.float32),
                "mel": torch.randn(T, 8).clamp(-10, 2),
                "pitch": torch.randn(n_ph), "energy": torch.randn(n_ph),
                "breath": torch.rand(n_ph), "rough": torch.rand(n_ph),
                "bright": torch.randn(n_ph)}

    path = str(tmp_path / "mono.pt")
    torch.save({"utterances": [utt(), utt()], "stats": {}}, path)
    meta = import_monolithic_cache(path, str(tmp_path / "out"))
    ref = jax_import.import_monolithic_cache(path, str(tmp_path / "jax"))
    _assert_same_cache(str(tmp_path / "out"), str(tmp_path / "jax"), meta, ref)
    assert len(meta["files"]) == 2 and "a" in meta["vocab"] and "<SIL>" in meta["vocab"]

    bad = str(tmp_path / "bad.pt")
    torch.save({"utterances": [{"mel": torch.randn(4, 8)}]}, bad)
    with pytest.raises(UserError, match="every one of the 1"):
        import_monolithic_cache(bad, str(tmp_path / "out2"))


def test_garbage_and_npz_cache_are_refused(tmp_path):
    bad = str(tmp_path / "bad.pt")
    torch.save({"something": 1}, bad)
    with pytest.raises(UserError, match="unrecognized monolithic cache layout"):
        import_monolithic_cache(bad, str(tmp_path / "o"))
    junk = tmp_path / "junk.pt"
    junk.write_bytes(b"not a pickle")
    with pytest.raises(UserError, match="cannot read it"):
        import_monolithic_cache(str(junk), str(tmp_path / "o"))

    src = tmp_path / "native"
    src.mkdir()
    (src / "u_00000.npz").write_bytes(b"not really npz")
    with open(src / "metadata.json", "w") as f:
        json.dump({"files": ["u_00000.npz"], "stats": {}, "vocab": []}, f)
    with pytest.raises(UserError, match="already a spev_tpu npz cache"):
        import_reference_cache(str(src), str(tmp_path / "out"))


def test_pickles_with_other_globals_are_refused(tmp_path):
    """weights_only=True stays on: only numpy's array globals are allowed."""
    import collections

    path = tmp_path / "u_00000.pt"
    torch.save({"phs": collections.OrderedDict(a=1)}, str(path))  # allowed by torch itself
    from spev_tpu_torch.data.cache_import import load_pickle

    assert load_pickle(str(path))["phs"] == {"a": 1}
    torch.save({"x": np.random.default_rng(0)}, str(path))  # a numpy Generator: refused
    with pytest.raises(UserError, match="cannot read it"):
        load_pickle(str(path))


def test_convert_cache_cli(ref_cache, tmp_path, capsys):
    src, _, _ = ref_cache
    out = str(tmp_path / "converted")
    assert convert_main(["cache", src, out]) == 0
    assert "imported 5 utterances" in capsys.readouterr().out
    assert len(json.load(open(os.path.join(out, "metadata.json")))["files"]) == 5
    assert convert_main(["cache", str(tmp_path / "missing"), out]) == 2
    assert capsys.readouterr().err.startswith("error:")


def test_imported_cache_trains_one_step(ref_cache, tmp_path):
    src, _, _ = ref_cache
    out = str(tmp_path / "cache_spev")
    import_reference_cache(src, out)
    ds = SpevDataset(None, cache_dir=out)  # reads the metadata, no device
    vocab = Vocab(ds.vocab)
    batcher = BucketBatcher(ds, vocab, batch_size=5, phoneme_buckets=(16,), frame_buckets=(64,),
                            n_mels=NMEL)
    batch = next(iter(batcher.epoch(0)))
    assert batch["ids"].shape == (5, 16)
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), embed_dim=16, hidden_dim=16,
                                       n_mels=NMEL, max_frames=64),
                     train=TrainConfig(batch_size=5, warmup_steps=10))
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=str(tmp_path / "ck"),
                      log_dir=str(tmp_path / "logs"), device="cpu")
    m = trainer.train_step(trainer.to_device(batch))
    assert m["skipped"] == 0.0 and np.isfinite(m["loss"]) and trainer.step == 1
