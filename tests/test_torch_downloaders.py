"""The port's dataset preppers and ``cli.download`` against the JAX
package's, offline, on trees the test writes with numpy from a seed.

- LJSpeech (``metadata.csv`` of id|text|normalised text, ``wavs/`` at
  44.1 kHz, one row without its wav, one short row), LibriTTS-R
  (speaker/chapter folders; ``.normalized.txt``, a plain ``.txt``, one wav
  without either), ESD (speakers × emotion folders, tab transcripts, one wav
  without a line, one speaker without a transcript file) and Jenny
  (``metadata.csv`` of id|text, wavs in a subfolder, one flac, skipped
  without ``soundfile``, one id without audio): both packages write the
  same file names and texts, and wavs within 1e-6 (with ``limit`` too).
- ``_trim_silence`` and ``_normalize`` equal JAX's exactly.
- ``cli.download prep`` for ESD and Jenny, and ``download`` with the
  LJSpeech root already in ``--work_dir`` and the LibriTTS-R archive placed
  there (extracted, not fetched): the same pairs and printed counts as JAX's
  CLI.  ``urllib.request.urlretrieve`` is replaced by a function that
  raises, so a network call fails the test.
"""

import io
import os
import tarfile
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from spev_tpu.cli import download as jax_cli
from spev_tpu.data import downloaders as jax_dl
from spev_tpu_torch.cli import download as port_cli
from spev_tpu_torch.data import downloaders as dl
from spev_tpu_torch.utils.wavio import read_wav, write_wav


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError(f"a network call was made: urlretrieve{a}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _speech(rng, n, sr):
    """Silence, a tone with noise, silence: something to trim."""
    t = np.arange(n) / sr
    y = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.standard_normal(n)
    y[: n // 5] *= 1e-3
    y[-n // 6:] *= 1e-3
    return y.astype(np.float32)


def write_ljspeech(root, rng, n=5, sr=44100):
    os.makedirs(os.path.join(root, "wavs"))
    rows = []
    for i in range(n):
        wid = f"LJ001-{i:04d}"
        write_wav(os.path.join(root, "wavs", wid + ".wav"), _speech(rng, int(0.5 * sr), sr), sr)
        rows.append(f"{wid}|Text {i}, raw.|text {i} normalised")
    rows += ["LJ001-9999|no wav here|no wav here", "short-row"]
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")


def write_libritts(root, rng, sr=24000):
    for spk, chap in (("19", "198"), ("26", "495")):
        d = os.path.join(root, "dev-clean", spk, chap)
        os.makedirs(d)
        for k in range(2):
            base = os.path.join(d, f"{spk}_{chap}_{k:06d}")
            write_wav(base + ".wav", _speech(rng, int(0.4 * sr), sr), sr)
            suffix = ".normalized.txt" if k == 0 else ".txt"
            with open(base + suffix, "w") as f:
                f.write(f"speaker {spk} line {k}")
    write_wav(os.path.join(root, "dev-clean", "19", "198", "orphan.wav"),
              _speech(rng, 4000, sr), sr)


def write_esd(root, rng, sr=16000):
    for spk in ("0011", "0012", "0013"):
        lines = []
        for emo in ("Angry", "Happy", "Neutral"):
            os.makedirs(os.path.join(root, spk, emo))
            for k in range(2):
                utt = f"{spk}_{emo[:2]}{k:04d}"
                write_wav(os.path.join(root, spk, emo, utt + ".wav"),
                          _speech(rng, int(0.3 * sr), sr), sr)
                if not (emo == "Happy" and k == 1):  # one wav without a transcript line
                    lines.append(f"{utt}\tSaid {emo.lower()} number {k}.\t{emo}")
        if spk != "0013":  # one speaker without a transcript file
            with open(os.path.join(root, spk, f"{spk}.txt"), "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "README.txt"), "w") as f:
        f.write("not a speaker folder")


def write_jenny(root, rng, sr=48000):
    os.makedirs(os.path.join(root, "audio", "part1"))
    rows = []
    for i in range(4):
        uid = f"jenny_{i:03d}"
        write_wav(os.path.join(root, "audio", "part1", uid + ".wav"),
                  _speech(rng, int(0.3 * sr), sr), sr)
        rows.append(f"{uid}| Jenny says {i}. ")
    with open(os.path.join(root, "audio", "jenny_flac.flac"), "wb") as f:
        f.write(b"fLaC")
    rows += ["jenny_flac|a flac file", "jenny_missing|no audio", "no-pipe-row"]
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")


def _pairs(out):
    """{name: text or waveform} of a prepped folder."""
    got = {}
    for name in sorted(os.listdir(out)):
        path = os.path.join(out, name)
        if name.endswith(".txt"):
            with open(path, encoding="utf-8") as f:
                got[name] = f.read()
        else:
            got[name] = read_wav(path)
    return got


def _same_pairs(ours, theirs):
    a, b = _pairs(ours), _pairs(theirs)
    assert sorted(a) == sorted(b) and a
    for name, v in a.items():
        if name.endswith(".txt"):
            assert v == b[name], name
        else:
            assert v[1] == b[name][1] and v[0].shape == b[name][0].shape, name
            np.testing.assert_allclose(v[0], b[name][0], atol=1e-6, rtol=0, err_msg=name)
    return a


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    paths = {k: str(root / k) for k in ("lj", "libri", "esd", "jenny")}
    write_ljspeech(paths["lj"], rng)
    write_libritts(paths["libri"], rng)
    write_esd(paths["esd"], rng)
    write_jenny(paths["jenny"], rng)
    return paths


@pytest.mark.parametrize("name,limit", [("process_single_speaker", None),
                                        ("process_single_speaker", 2),
                                        ("process_multi_speaker", None),
                                        ("prep_esd", None), ("prep_esd", 3),
                                        ("prep_jenny", None)])
def test_preppers_match_jax(trees, tmp_path, name, limit):
    src = trees[{"process_single_speaker": "lj", "process_multi_speaker": "libri",
                 "prep_esd": "esd", "prep_jenny": "jenny"}[name]]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    n = getattr(dl, name)(src, ours, limit=limit)
    assert n == getattr(jax_dl, name)(src, theirs, limit=limit)
    pairs = _same_pairs(ours, theirs)
    assert len(pairs) == 2 * n
    expected = {"process_single_speaker": 5, "process_multi_speaker": 4, "prep_esd": 10,
                "prep_jenny": 4}[name]
    assert n == (limit or expected)
    if name == "prep_esd":
        assert "0011_An0000_angry.wav" in pairs and "0011_Ha0001_happy.txt" not in pairs
    if name == "process_single_speaker":
        y, sr = pairs["LJ001-0000.wav"]
        assert sr == 22050 and abs(np.abs(y).max() - 32767 / 32768) < 1e-4
        assert len(y) < 0.5 * 22050  # trimmed
        assert pairs["LJ001-0000.txt"] == "text 0 normalised"


def test_trim_and_normalize_match_jax():
    rng = np.random.default_rng(1)
    for n in (100, 2048, 5000, 30001):
        y = (rng.standard_normal(n) * np.linspace(0, 1, n) ** 3).astype(np.float32)
        for top_db in (25.0, 60.0):
            np.testing.assert_array_equal(dl._trim_silence(y, top_db=top_db),
                                          jax_dl._trim_silence(y, top_db=top_db))
        np.testing.assert_array_equal(dl._normalize(y), jax_dl._normalize(y))
    z = np.zeros(4096, np.float32)
    assert dl._trim_silence(z) is z and dl._normalize(z) is z


def _run(main, argv):
    """(exit status, stdout) of a CLI's ``main``; success is 0 for the port
    and None for the JAX package."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc or 0, out.getvalue()


@pytest.mark.parametrize("dataset", ["esd", "jenny"])
def test_cli_prep_matches_jax(trees, tmp_path, dataset):
    runs = {}
    for who, main in (("ours", port_cli.main), ("theirs", jax_cli.main)):
        out = str(tmp_path / who)
        rc, text = _run(main, ["prep", "--dataset", dataset, "--in_dir", trees[dataset],
                               "--out_dir", out])
        runs[who] = (rc, text.replace(out, "<out>"))
    assert runs["ours"] == runs["theirs"]
    assert runs["ours"][0] == 0 and "prepared" in runs["ours"][1]
    _same_pairs(str(tmp_path / "ours"), str(tmp_path / "theirs"))


def test_cli_download_offline_matches_jax(trees, tmp_path):
    """LJSpeech's root is already in the work dir; LibriTTS-R's archive is
    there too and gets extracted, not fetched."""
    runs = {}
    for who, main in (("ours", port_cli.main), ("theirs", jax_cli.main)):
        work = tmp_path / who / "raw"
        os.makedirs(work)
        os.symlink(trees["lj"], work / "LJSpeech-1.1")
        with tarfile.open(work / "dev_clean.tar.gz", "w:gz") as tf:
            tf.add(trees["libri"], arcname="LibriTTS_R")
        out = str(tmp_path / who / "pairs")
        rc, text = _run(main, ["download", "--dataset", "both", "--work_dir", str(work),
                               "--out_dir", out])
        runs[who] = (rc, text.replace(str(work), "<work>"))
        assert os.path.isdir(work / "LibriTTS_R" / "dev-clean")
    assert runs["ours"] == runs["theirs"]
    assert "LJSpeech: 5 utterances" in runs["ours"][1]
    assert "LibriTTS-R: 4 utterances" in runs["ours"][1]
    assert "downloading" not in runs["ours"][1]
    _same_pairs(str(tmp_path / "ours" / "pairs"), str(tmp_path / "theirs" / "pairs"))
