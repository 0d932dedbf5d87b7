"""The port's feature-cache reader, batching and prefetching against the JAX
package's on a small cache written with numpy from a seed: equal arrays,
equal bucket order, equal splits."""

import numpy as np
import pytest

from spev_tpu.data.batching import BucketBatcher as JaxBatcher
from spev_tpu.data.batching import collate as jax_collate
from spev_tpu.data.batching import train_val_split as jax_split
from spev_tpu.data.dataset import SpevDataset as JaxDataset
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu_torch.data.batching import BucketBatcher, collate, train_val_split
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.data.prefetch import prefetch
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.text.vocab import Vocab

from _torch_cache import write_cache

NMEL = 8


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cache"))
    # lengths over the phoneme buckets (16, 32) and frame buckets (32, 64, 128)
    return write_cache(d, n_utts=40, seed=3, n_mels=NMEL, max_ph=30, max_dur=4)


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_reads_cache(cache):
    ds, jds = SpevDataset(cache_dir=cache), JaxDataset("unused", cache_dir=cache)
    assert len(ds) == len(jds) == 40
    assert ds.vocab == jds.vocab and ds.stats == jds.stats
    assert [tuple(x) for x in ds.lengths] == [tuple(x) for x in jds.lengths]
    for i in (0, 17, 39):
        u, ju = ds.load_utterance(i), jds.load_utterance(i)
        assert sorted(u) == sorted(ju)
        for k in u:
            np.testing.assert_array_equal(u[k], ju[k])


def test_dataset_without_cache_raises(tmp_path):
    with pytest.raises(UserError, match="not ported"):
        SpevDataset(cache_dir=str(tmp_path / "missing"))
    (tmp_path / "metadata.json").write_text('{"files": [], "stats": {}, "vocab": []}')
    with pytest.raises(UserError, match="no usable feature cache"):
        SpevDataset(cache_dir=str(tmp_path))


def test_collate_matches_jax(cache):
    ds = SpevDataset(cache_dir=cache)
    utts = [ds.load_utterance(i) for i in (3, 8, 21)]
    out = collate(utts, Vocab(ds.vocab), 32, 128, NMEL)
    ref = jax_collate(utts, JaxVocab(ds.vocab), 32, 128, NMEL)
    _assert_batches_equal(out, ref)
    with pytest.raises(UserError):
        collate(utts, Vocab(ds.vocab), 4, 128, NMEL)


@pytest.mark.parametrize("epoch", [0, 1])
def test_bucket_batcher_matches_jax(cache, epoch):
    ds, jds = SpevDataset(cache_dir=cache), JaxDataset("unused", cache_dir=cache)
    tr, _ = train_val_split(len(ds), 0.1, seed=0)
    kw = dict(batch_size=4, phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128),
              n_mels=NMEL, indices=tr, seed=5)
    ours = list(BucketBatcher(ds, Vocab(ds.vocab), **kw).epoch(epoch))
    ref = list(JaxBatcher(jds, JaxVocab(jds.vocab), **kw).epoch(epoch))
    assert len(ours) == len(ref) > 3
    assert len({(b["ids"].shape[1], b["mel"].shape[1]) for b in ours}) > 1
    for a, b in zip(ours, ref):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("n,frac", [(96, 0.05), (40, 0.1), (1, 0.05)])
def test_train_val_split_matches_jax(n, frac):
    assert train_val_split(n, frac, seed=0) == jax_split(n, frac, seed=0)


def test_prefetch_order_and_errors():
    assert list(prefetch(range(50), depth=3)) == list(range(50))
    assert list(prefetch(iter([1, 2]), depth=0)) == [1, 2]

    def bad():
        yield 1
        raise KeyError("boom")

    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
