"""The port's C++ I/O runtime (``spev_tpu_torch.utils.native`` building
``spev_tpu_torch/csrc/spevio.cpp``) against the JAX package's
``spev_tpu.utils.native``, which loads the tracked ``native/libspevio.so``
as it stands (never rebuilt: the test checks its bytes before and after).

- WAVs written with numpy from a seed (PCM 8, 16 and 24 bit, 32-bit int,
  32-bit float, stereo, WAVE_FORMAT_EXTENSIBLE, an odd-sized chunk before
  the data): the port's decoder, JAX's and the port's Python reader give
  the same bits and rate.
- ``write_wav``: the same bytes as JAX's, read back to 16-bit PCM.
- ``trim_normalize``: the same bits as JAX's, and the Python prep
  (``data.downloaders._trim_silence`` then ``_normalize``) within 1e-6.
- ``PrefetchingReader``: every file in order (a missing one as None), the
  same bits as ``read_wav``, also when the last file decodes slower than
  the consumer works; JAX's reader yields a prefix of the same (it ends
  early in that case: ``ROADMAP.md`` §4, F2).
- A file the C++ decoder refuses (64-bit float) goes to the port's Python
  reader; a file that is no WAV raises its `UserError`; a build that fails
  raises with the compiler's output.
"""

import hashlib
import os
import struct

import numpy as np
import pytest

from spev_tpu.utils import native as jax_native
from spev_tpu_torch.data.downloaders import _normalize, _trim_silence
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.utils import native, wavio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = os.path.join(REPO, "native", "libspevio.so")


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module", autouse=True)
def tracked_library_untouched():
    before = _digest(TRACKED)
    yield
    assert _digest(TRACKED) == before


def _riff(path, fmt_code, n_ch, sr, bits, data, extensible=False, junk=b""):
    """A RIFF/WAVE file; ``junk`` goes into an odd-sized LIST chunk (padded
    to even) before the data."""
    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code, n_ch, sr, sr * block,
                      block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if junk:
        chunks += b"LIST" + struct.pack("<I", len(junk)) + junk + b"\x00" * (len(junk) & 1)
    chunks += b"data" + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


def _cases(rng, n=3001):
    x = rng.uniform(-1, 1, n)
    i24 = np.round(x * 8388607).astype(np.int32)
    b24 = np.stack([i24 & 255, (i24 >> 8) & 255, (i24 >> 16) & 255], 1).astype(np.uint8)
    st = np.round(rng.uniform(-1, 1, (n, 2)) * 32767).astype("<i2")
    return {
        "pcm8": (1, 1, 16000, 8, np.round(x * 127 + 128).astype(np.uint8).tobytes(), {}),
        "pcm16": (1, 1, 22050, 16, np.round(x * 32767).astype("<i2").tobytes(), {}),
        "pcm24": (1, 1, 44100, 24, b24.tobytes(), {}),
        "int32": (1, 1, 22050, 32, np.round(x * 2147483000).astype("<i4").tobytes(), {}),
        "float32": (3, 1, 24000, 32, x.astype("<f4").tobytes(), {}),
        "stereo": (1, 2, 22050, 16, st.tobytes(), {}),
        "extensible": (1, 1, 22050, 16, np.round(x * 32767).astype("<i2").tobytes(),
                       {"extensible": True}),
        "odd_chunk": (1, 1, 22050, 16, np.round(x * 32767).astype("<i2").tobytes(),
                      {"junk": b"INFOabc"}),
    }


@pytest.mark.parametrize("case", list(_cases(np.random.default_rng(0))))
def test_read_wav_matches_jax_and_python(case, tmp_path):
    code, n_ch, sr, bits, data, kw = _cases(np.random.default_rng(0))[case]
    path = str(tmp_path / f"{case}.wav")
    _riff(path, code, n_ch, sr, bits, data, **kw)
    y, rate = native.read_wav(path)
    yj, rate_j = jax_native.read_wav(path)
    yp, rate_p = wavio.read_wav(path)
    assert rate == rate_j == rate_p == sr
    assert y.dtype == np.float32 and y.shape == (len(data) // (n_ch * bits // 8),)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(y, yp)


def test_write_wav_matches_jax(tmp_path):
    y = np.random.default_rng(1).uniform(-1.2, 1.2, 5000).astype(np.float32)
    ours, theirs = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    native.write_wav(ours, y, 16000)
    jax_native.write_wav(theirs, y, 16000)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back, sr = native.read_wav(ours)
    assert sr == 16000
    pcm = (np.clip(y, -1, 1) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(back, pcm.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("normalize", [True, False])
def test_trim_normalize_matches_jax_and_python(normalize):
    rng = np.random.default_rng(2)
    sil = (1e-4 * rng.standard_normal(7000)).astype(np.float32)
    speech = (0.4 * rng.standard_normal(30000)).astype(np.float32)
    y = np.concatenate([sil, speech, sil])
    ours = native.trim_normalize(y, top_db=25.0, normalize=normalize)
    np.testing.assert_array_equal(ours, jax_native.trim_normalize(y, 25.0, normalize))
    ref = _trim_silence(y, top_db=25.0)
    ref = _normalize(ref) if normalize else ref
    assert ours.shape == ref.shape and len(ours) < len(y)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(native.trim_normalize(y[:1000], 25.0, False), y[:1000])


def test_prefetching_reader_in_order(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(7):
        p = str(tmp_path / f"f{i}.wav")
        wavio.write_wav(p, rng.uniform(-0.5, 0.5, 3000 + 97 * i).astype(np.float32), 22050)
        paths.append(p)
    paths.insert(3, str(tmp_path / "missing.wav"))
    for capacity in (1, 2, 8):
        reader = native.PrefetchingReader(paths, capacity=capacity)
        got = list(reader)
        reader.close()
        assert [i for i, _, _ in got] == list(range(len(paths)))
        assert got[3][1:] == (None, 0)
        for i, y, sr in got[:3] + got[4:]:
            ref, sr_ref = native.read_wav(paths[i])
            assert sr == sr_ref == 22050
            np.testing.assert_array_equal(y, ref)
        theirs = jax_native.PrefetchingReader(paths, capacity=capacity)
        jax_got = list(theirs)
        theirs.close()
        assert [i for i, _, _ in jax_got] == list(range(len(jax_got)))
        for (i, y, sr), (_, yj, srj) in zip(got, jax_got):
            assert sr == srj
            if y is not None:
                np.testing.assert_array_equal(y, yj)
    reader = native.PrefetchingReader(paths[:2], capacity=1)
    reader.close()  # before any file is taken: the C++ thread stops, the queue is freed
    assert list(reader) == []


def test_prefetching_reader_waits_for_a_slow_last_file(tmp_path):
    """The C++ reader reports its end as soon as its thread has claimed the
    last file, which it may still be decoding; the port's wrapper waits for
    every file (JAX's ends early when the consumer is the faster: printed)."""
    import time

    paths = []
    for i, n in enumerate([1000, 1000, 4_000_000]):
        paths.append(str(tmp_path / f"f{i}.wav"))
        wavio.write_wav(paths[-1], np.zeros(n, np.float32), 22050)
    counts = {}
    for name, mod in (("port", native), ("jax", jax_native)):
        reader = mod.PrefetchingReader(paths, capacity=4)
        got = []
        for i, y, _ in reader:
            got.append((i, len(y)))
            time.sleep(0.002)
        reader.close()
        counts[name] = len(got)
        assert got == [(0, 1000), (1, 1000), (2, 4_000_000)][:len(got)]
    print("files yielded:", counts)
    assert counts["port"] == 3


def test_refused_formats_go_to_the_python_reader(tmp_path):
    x = np.random.default_rng(4).uniform(-1, 1, 1000)
    f64 = str(tmp_path / "f64.wav")
    _riff(f64, 3, 1, 22050, 64, x.astype("<f8").tobytes())
    y, sr = native.read_wav(f64)
    yp, _ = wavio.read_wav(f64)
    assert sr == 22050
    np.testing.assert_array_equal(y, yp)
    np.testing.assert_array_equal(y, x.astype(np.float32))
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav file at all" * 4)
    with pytest.raises(UserError, match="not a RIFF/WAVE file"):
        native.read_wav(bad)


def test_library_builds_into_the_package_and_failures_raise(tmp_path, monkeypatch):
    so = native.library_path()
    assert native.available() and os.path.exists(so)
    assert os.path.dirname(so).endswith(os.path.join("spev_tpu_torch", "_build"))
    broken = tmp_path / "spevio.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for csrc/spevio.cpp"):
        native.read_wav(str(broken))
    assert not native.available()
