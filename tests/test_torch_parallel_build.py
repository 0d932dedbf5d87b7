"""The port's parallel dataset build (``SpevDataset(build_workers=2)``, pass 2
in spawned worker processes) on the CPU.

A 12-file ESD-style corpus written with numpy from a seed
(``{speaker}_{utt}_{emotion}.wav``, 3 speakers × 3 emotions, plus one file
under ``min_samples``, one ``.wav`` that is no WAV, one wav without a
transcript), built with speaker and emotion-VAD labels:
- with two workers it equals the port's serial build exactly: every npz
  array, ``metadata.json`` (files, stats, vocab, lengths, speakers,
  emotions, emotion counts) and the error line printed for the file that
  does not decode (counted, as in the serial path);
- it equals the JAX package's serial build within the extraction
  tolerances of ``tests/test_torch_dataset_build.py`` (stats 1e-4
  relative, mel 2e-4, per-phoneme targets 1e-3; labels, phonemes and
  durations exact);
- an extractor error in a worker (a log-mel configuration K2 refuses) ends
  the build, and no cache is written.
"""

import json
import os

import numpy as np
import pytest

from spev_tpu.data.dataset import SpevDataset as JaxDataset
from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.utils.wavio import write_wav

SPEAKERS = ("spkA", "spkB", "spkC")
EMOTIONS = ("angry", "happy", "sad")
KW = dict(g2p_backend="rules", stats_sample=12, multi_speaker=True, emotion_vad=True)
TARGETS = ("pitch", "energy", "breath", "rough", "bright", "nasal")


def _write_corpus(root):
    rng = np.random.default_rng(21)
    os.makedirs(root)
    sr = 22050

    def tone(n, f0):
        t = np.arange(n) / sr
        y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(n)
        return y.astype(np.float32)

    for i, spk in enumerate(SPEAKERS):
        for j, emo in enumerate(EMOTIONS):
            base = os.path.join(root, f"{spk}_{i}{j}_{emo}")
            write_wav(base + ".wav", tone(int((0.5 + 0.1 * j) * sr), 110 + 20 * i + 7 * j), sr)
            with open(base + ".txt", "w") as f:
                f.write(["hello there", "a quick test", "say it again"][j])
    write_wav(os.path.join(root, "spkA_short_sad.wav"), tone(3000, 150), sr)
    with open(os.path.join(root, "spkA_short_sad.txt"), "w") as f:
        f.write("too short")
    with open(os.path.join(root, "spkB_broken_happy.wav"), "wb") as f:
        f.write(b"this is no wav file" * 10)
    with open(os.path.join(root, "spkB_broken_happy.txt"), "w") as f:
        f.write("broken")
    write_wav(os.path.join(root, "spkC_untranscribed_sad.wav"), tone(12000, 170), sr)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_build")
    corpus = str(root / "corpus")
    _write_corpus(corpus)
    out = {}
    for name, kw in (("serial", {}), ("parallel", {"build_workers": 2})):
        import contextlib
        import io

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            ds = SpevDataset(corpus, cache_dir=str(root / name), device="cpu", **KW, **kw)
        out[name] = (ds, printed.getvalue())
    return root, corpus, out


def _meta(ds):
    with open(os.path.join(ds.cache_dir, "metadata.json")) as f:
        return json.load(f)


def test_parallel_build_equals_serial(builds):
    _, _, out = builds
    (serial, said_s), (par, said_p) = out["serial"], out["parallel"]
    assert _meta(par) == _meta(serial)
    assert len(par) == 9 and par.speakers == list(SPEAKERS)
    assert par.emotions == list(EMOTIONS)
    assert _meta(par)["emotion_counts"] == {e: 3 for e in EMOTIONS}
    for i in range(len(par)):
        a, b = serial.load_utterance(i), par.load_utterance(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert int(par.load_utterance(4)["speaker_id"]) == 1


def test_decode_error_counted_as_in_the_serial_path(builds):
    _, _, out = builds
    said = [[ln for ln in out[k][1].splitlines() if ln.startswith("Warning: skipped")]
            for k in ("serial", "parallel")]
    assert len(said[0]) == 1 and said[0][0].startswith("Warning: skipped 1/12 files on errors; "
                                                       "first (spkB_broken_happy.wav)")
    # the worker's row carries the exception's repr, the serial path's the exception
    assert said[1][0].split("):")[0] == said[0][0].split("):")[0]
    assert "not a RIFF/WAVE file" in said[1][0]


def test_parallel_build_matches_jax(builds):
    root, corpus, out = builds
    par = out["parallel"][0]
    ref = JaxDataset(corpus, cache_dir=str(root / "jax"), **KW)
    assert par.files == ref.files and par.vocab == ref.vocab
    assert (par.speakers, par.emotions) == (ref.speakers, ref.emotions)
    assert [tuple(x) for x in par.lengths] == [tuple(x) for x in ref.lengths]
    for k, v in ref.stats.items():
        assert abs(par.stats[k] - v) <= 1e-4 * abs(v), k
    assert _meta(par)["emotion_counts"] == _meta(ref)["emotion_counts"]
    for i in range(len(ref)):
        a, b = par.load_utterance(i), ref.load_utterance(i)
        assert sorted(a) == sorted(b)
        assert list(a["phs"]) == list(b["phs"])
        for k in ("durs", "speaker_id", "vad"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["mel"], b["mel"], atol=2e-4)
        for k in TARGETS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=k)


def test_extractor_error_in_a_worker_ends_the_build(builds, tmp_path):
    """n_fft 2048 passes the stats pass in the parent and is refused by K2's
    wrapper in the workers: a kernel that does not launch is not a bad
    file."""
    import dataclasses

    _, corpus, _ = builds
    audio = dataclasses.replace(AudioConfig(), n_fft=2048)
    with pytest.raises(ValueError, match="fused_log_mel: need"):
        SpevDataset(corpus, cache_dir=str(tmp_path / "c"), audio=audio, build_workers=2,
                    device="cpu", **KW)
    assert not (tmp_path / "c" / "metadata.json").exists()
