"""The port's dataset build against the JAX package's, on the CPU.

The 4-utterance corpus of tests/test_data.py (0.8 s each, one 8192-sample
bucket) is built by both packages' `SpevDataset` (rules G2P, stats over all
4 files), from transcripts alone and with TextGrids for two of the files
(one long-form, one short-form).  The caches agree: ``files``, ``vocab``,
``lengths``, every ``phs`` and ``durs`` equal; ``stats`` within 1e-4
relative; ``mel`` within 2e-4 (the log-mel bar); the per-phoneme targets
within 1e-3.  Then the parts: duration rescaling, the wav reader and
resampler, the TextGrid parsers, cache reload, rebuilds and the errors.
"""

import os
import struct

import numpy as np
import pytest
import torch

from spev_tpu.data.dataset import SpevDataset as JaxDataset
from spev_tpu.data.dataset import _rescale_durations as jax_rescale
from spev_tpu.text import textgrid as jax_tg
from spev_tpu.utils import wavio as jax_wavio
from spev_tpu_torch.data.dataset import FeatureExtractor, SpevDataset, _rescale_durations
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.text import textgrid
from spev_tpu_torch.utils.wavio import read_wav, resample_linear, write_wav

from test_data import _make_corpus

TARGETS = ("pitch", "energy", "breath", "rough", "bright", "nasal")

LONG_TG = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 0.8
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 0.8
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 0.8
            text = "hello"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 0.8
        intervals: size = 5
        intervals [1]:
            xmin = 0
            xmax = 0.1
            text = ""
        intervals [2]:
            xmin = 0.1
            xmax = 0.25
            text = "HH"
        intervals [3]:
            xmin = 0.25
            xmax = 0.45
            text = "AH0"
        intervals [4]:
            xmin = 0.45
            xmax = 0.451
            text = "L"
        intervals [5]:
            xmin = 0.451
            xmax = 0.8
            text = "OW1"
'''

SHORT_TG = '''File type = "ooTextFile"
Object class = "TextGrid"

0
0.8
<exists>
1
"IntervalTier"
"Phonemes"
0
0.8
3
0
0.3
"S"
0.3
0.6
"P"
0.6
0.8
""
'''


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    _make_corpus(root)
    tg = str(tmp_path_factory.mktemp("textgrids"))
    os.makedirs(os.path.join(tg, "sub"))
    with open(os.path.join(tg, "utt0.TextGrid"), "w") as f:
        f.write(LONG_TG)
    with open(os.path.join(tg, "sub", "utt1.TextGrid"), "w") as f:
        f.write(SHORT_TG)
    return root, tg


@pytest.fixture(scope="module", params=["transcripts", "textgrids"])
def both_caches(request, corpus, tmp_path_factory):
    root, tg = corpus
    tg = tg if request.param == "textgrids" else None
    kw = dict(textgrid_dir=tg, g2p_backend="rules", stats_sample=4)
    ref = JaxDataset(root, cache_dir=str(tmp_path_factory.mktemp("jax")), **kw)
    ours = SpevDataset(root, cache_dir=str(tmp_path_factory.mktemp("port")), device="cpu", **kw)
    return ours, ref, request.param


def test_cache_matches_jax(both_caches):
    ours, ref, kind = both_caches
    assert ours.files == ref.files == [f"u_{i:05d}.npz" for i in range(4)]
    assert ours.vocab == ref.vocab
    assert [tuple(x) for x in ours.lengths] == [tuple(x) for x in ref.lengths]
    assert sorted(ours.stats) == sorted(ref.stats)
    for k, v in ref.stats.items():
        assert abs(ours.stats[k] - v) <= 1e-4 * abs(v), k
    for i in range(len(ref)):
        a, b = ours.load_utterance(i), ref.load_utterance(i)
        assert sorted(a) == sorted(b)
        assert list(a["phs"]) == list(b["phs"])
        np.testing.assert_array_equal(a["durs"], b["durs"])
        assert a["durs"].dtype == np.int32 and a["mel"].dtype == np.float32
        assert int(a["durs"].sum()) == a["mel"].shape[0] and a["mel"].shape[1] == 80
        np.testing.assert_allclose(a["mel"], b["mel"], atol=2e-4)
        for k in TARGETS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=k)
    if kind == "textgrids":
        u0, u1 = ours.load_utterance(0), ours.load_utterance(1)
        assert list(u0["phs"]) == ["<SIL>", "HH", "AH0", "OW1"]  # the 1 ms "L" has no frame
        assert list(u1["phs"]) == ["S", "P", "<SIL>"]


def test_cache_reload_needs_no_device(both_caches, monkeypatch):
    ours, _, _ = both_caches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    again = SpevDataset(None, cache_dir=ours.cache_dir)  # device "cuda", never resolved
    assert again.files == ours.files and again.vocab == ours.vocab
    assert again.stats == ours.stats and again.lengths == [list(x) for x in ours.lengths]


def test_building_defaults_to_the_card(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureExtractor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpevDataset(corpus[0], cache_dir=str(tmp_path / "c"), g2p_backend="rules")


def test_extractor_runs_in_fp32_and_restores_tf32(monkeypatch):
    """The extractor's products run with TF32 off whatever the process set,
    and the process's settings are left as they were."""
    import spev_tpu_torch.ops.stft as stft_mod

    seen = []
    orig = stft_mod.frame_signal

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return orig(*a, **k)

    monkeypatch.setattr(stft_mod, "frame_signal", spy)  # the centroid's STFT
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    fx = FeatureExtractor(device="cpu")
    y = np.random.default_rng(2).standard_normal(9000).astype(np.float32) * 0.1
    mel, f0, vprob, log_rms, cent = fx.full_features(y)
    fx.stats_features(y)
    assert mel.shape == (80, 1 + 9000 // 256) and f0.shape == vprob.shape == cent.shape
    np.testing.assert_array_equal(fx.mel(y), mel)
    assert len(seen) == 2 and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_empty_cache_is_rebuilt_and_force_rebuild_replaces(corpus, tmp_path):
    root, _ = corpus
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "metadata.json").write_text('{"files": [], "stats": {}, "vocab": ["<PAD>"], '
                                         '"speakers": [], "lengths": []}')
    ds = SpevDataset(root, cache_dir=str(cache), g2p_backend="rules", stats_sample=2,
                     device="cpu")
    assert len(ds) == 4
    (cache / "stale.txt").write_text("x")
    ds = SpevDataset(root, cache_dir=str(cache), g2p_backend="rules", stats_sample=2,
                     force_rebuild=True, device="cpu")
    assert len(ds) == 4 and not (cache / "stale.txt").exists()
    assert sorted(os.listdir(cache)) == ["metadata.json"] + ds.files


def test_missing_cache_without_data_dir_raises(tmp_path):
    with pytest.raises(UserError, match="no usable feature cache"):
        SpevDataset(None, cache_dir=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="no wavs"):
        SpevDataset(str(tmp_path / "empty"), cache_dir=str(tmp_path / "c"), device="cpu")


def test_all_files_skipped_raises_user_error(tmp_path):
    root = tmp_path / "corpus"
    root.mkdir()
    for i in range(2):  # 1000 samples < min_samples 4000
        write_wav(str(root / f"u{i}.wav"), np.zeros(1000, np.float32), 22050)
        (root / f"u{i}.txt").write_text("hi")
    cache = tmp_path / "cache"
    with pytest.raises(UserError, match="no usable utterances"):
        SpevDataset(str(root), cache_dir=str(cache), g2p_backend="rules", stats_sample=2,
                    device="cpu")
    assert not (cache / "metadata.json").exists()


def test_all_files_failing_raises(corpus, tmp_path, monkeypatch):
    def fail(self, path):
        raise ValueError(f"{path}: not a wav")

    monkeypatch.setattr(SpevDataset, "_load", fail)
    with pytest.raises(RuntimeError, match="failed feature extraction"):
        SpevDataset(corpus[0], cache_dir=str(tmp_path / "c"), g2p_backend="rules",
                    stats_sample=2, device="cpu")
    assert not (tmp_path / "c" / "metadata.json").exists()


@pytest.mark.parametrize("method", ["stats_features", "full_features"])
def test_extractor_errors_end_the_build(method, corpus, tmp_path, monkeypatch):
    """A kernel that does not build or launch is not a bad file: the build
    stops on it instead of skipping the utterance."""
    def fail(self, y):
        raise RuntimeError("log_mel_forward failed: CUDA error 209")

    monkeypatch.setattr(FeatureExtractor, method, fail)
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        SpevDataset(corpus[0], cache_dir=str(tmp_path / "c"), g2p_backend="rules",
                    stats_sample=2, device="cpu")
    assert not (tmp_path / "c" / "metadata.json").exists()


@pytest.mark.parametrize("kw", [{"build_workers": 2}, {"multi_speaker": True},
                                {"emotion_vad": True}], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kw, tmp_path):
    """On an existing cache the build options read it: ``build_workers`` and
    ``multi_speaker`` take it as it is, and ``emotion_vad`` refuses one
    built without emotion labels (the labelled build itself is in
    test_torch_advanced_train.py, the parallel build in
    test_torch_parallel_build.py)."""
    from _torch_cache import write_cache

    cache = write_cache(str(tmp_path / "cache"), n_utts=3)
    if "build_workers" in kw:
        ds = SpevDataset("unused", cache_dir=cache, device="cpu", **kw)
        assert len(ds) == 3 and ds.files == SpevDataset(None, cache_dir=cache).files
        return
    if "multi_speaker" in kw:
        ds = SpevDataset("unused", cache_dir=cache, device="cpu", **kw)
        assert len(ds) == 3 and ds.speakers == [] and ds.emotions == []
    else:
        with pytest.raises(UserError, match="without emotion-VAD labels"):
            SpevDataset("unused", cache_dir=cache, device="cpu", **kw)


@pytest.mark.parametrize("durs,phs,target", [
    ([2, 2], ["a", "b"], 4),            # exact fit
    ([1, 1], ["a", "b"], 5),            # remainder to the last phoneme
    ([5, 1, 1], ["a", "b", "c"], 5),    # trimmed from the tail
    ([1, 1, 1, 9], list("abcd"), 3),    # emptied phonemes dropped
    ([3, 0, 4], list("abc"), 20),
    ([0, 0], ["a", "b"], 4),            # zero total bails
    ([7], ["a"], 0),
])
def test_rescale_durations_matches_jax(durs, phs, target):
    assert _rescale_durations(durs, phs, target) == jax_rescale(durs, phs, target)


def _riff(path, fmt_code, n_ch, sr, bits, data, extensible=False):
    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code, n_ch, sr, sr * block,
                      block, bits)
    if extensible:  # cbSize, valid bits, channel mask, sub-format GUID
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + bytes(14)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # an odd chunk, padded
    body += b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _wav_cases():
    rng = np.random.default_rng(11)
    x = np.clip(0.6 * rng.standard_normal((1500, 2)), -1, 1)
    pcm16 = (x[:, 0] * 32767).astype("<i2")
    i24 = (x[:, 0] * (2**23 - 1)).astype(np.int32)
    pcm24 = np.stack([i24 & 0xFF, (i24 >> 8) & 0xFF, (i24 >> 16) & 0xFF], 1).astype(np.uint8)
    return {
        "pcm16": (1, 1, 16000, 16, pcm16.tobytes()),
        "pcm24": (1, 1, 22050, 24, pcm24.tobytes()),
        "pcm32": (1, 1, 22050, 32, (x[:, 0] * 2**31 * 0.99).astype("<i4").tobytes()),
        "pcm8": (1, 1, 8000, 8, ((x[:, 0] + 1) * 127.5).astype(np.uint8).tobytes()),
        "float32": (3, 1, 44100, 32, x[:, 0].astype("<f4").tobytes()),
        "stereo16": (1, 2, 22050, 16, (x * 32767).astype("<i2").tobytes()),
    }


@pytest.mark.parametrize("case", sorted(_wav_cases()))
def test_read_wav_and_resample_match_jax(case, tmp_path):
    path = str(tmp_path / f"{case}.wav")
    _riff(path, *_wav_cases()[case])
    y, sr = read_wav(path)
    jy, jsr = jax_wavio.read_wav(path)
    assert sr == jsr and y.dtype == jy.dtype == np.float32 and len(y) == 1500
    np.testing.assert_array_equal(y, jy)
    for out_sr in (22050, 16000):
        np.testing.assert_array_equal(resample_linear(y, sr, out_sr),
                                      jax_wavio.resample_linear(jy, jsr, out_sr))


def test_read_wav_extensible(tmp_path):
    """WAVE_FORMAT_EXTENSIBLE takes its sub-format from the fmt chunk."""
    for name, code, bits, data in (("pcm", 1, 16, np.arange(-50, 50, dtype="<i2") * 300),
                                   ("float", 3, 32, np.linspace(-1, 1, 100, dtype="<f4"))):
        plain, ext = str(tmp_path / f"{name}.wav"), str(tmp_path / f"{name}_ext.wav")
        _riff(plain, code, 1, 22050, bits, data.tobytes())
        _riff(ext, code, 1, 22050, bits, data.tobytes(), extensible=True)
        a, b = read_wav(plain), read_wav(ext)
        assert a[1] == b[1] == 22050
        np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(UserError, match="not a RIFF"):
        (tmp_path / "bad.wav").write_bytes(b"RIFX0000WAVE")
        read_wav(str(tmp_path / "bad.wav"))


@pytest.mark.parametrize("form", ["long", "short"])
def test_textgrid_parsers_match_jax(form, tmp_path):
    path = str(tmp_path / "a.TextGrid")
    with open(path, "w") as f:
        f.write(LONG_TG if form == "long" else SHORT_TG)
    ours = textgrid.parse_textgrid(path)
    ref = jax_tg.parse_textgrid(path)
    assert [(t.name, [(i.xmin, i.xmax, i.mark) for i in t.intervals]) for t in ours] == \
        [(t.name, [(i.xmin, i.xmax, i.mark) for i in t.intervals]) for t in ref]
    ivs, jivs = textgrid.phone_intervals(path), jax_tg.phone_intervals(path)
    assert [(i.xmin, i.xmax, i.mark) for i in ivs] == [(i.xmin, i.xmax, i.mark) for i in jivs]
    assert textgrid.intervals_to_durations(ivs) == jax_tg.intervals_to_durations(jivs)
    assert textgrid.intervals_to_durations(ivs, 16000, 200) == \
        jax_tg.intervals_to_durations(jivs, 16000, 200)
