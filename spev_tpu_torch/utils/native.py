"""The C++ I/O runtime through ``ctypes`` (counterpart of
``spev_tpu.utils.native``).

``spev_tpu_torch/csrc/spevio.cpp`` (a copy of the JAX package's
``native/spevio.cpp``) holds a WAV decoder (PCM 8/16/24/32 bit and 32-bit
IEEE float, any channel count averaged to mono float32) and a 16-bit PCM
encoder, the dataset-prep loop (silence trim and peak normalisation in
place) and a prefetching decoder (one C++ thread decoding ahead into a
bounded queue).  It runs on the host CPU.

The library is built at first use with the host compiler,

    g++ -O3 -fPIC -std=c++17 -shared -pthread spevio.cpp

into ``<build dir>/libspevio-<hash>.so``, where the hash covers the source
and the flags, beside the kernels' ``.so`` files (the package's ``_build/``,
or the user's cache when the package is read-only:
`spev_tpu_torch.utils.platform.build_dir`).  A build
that fails raises with the compiler's output.  `read_wav` and `write_wav`
hand a file the C++ code refuses (another format, such as 64-bit float) to
the Python reader and writer of `spev_tpu_torch.utils.wavio`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from spev_tpu_torch.utils import wavio
from spev_tpu_torch.utils.platform import build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "spevio.cpp")
BUILD_DIR = build_dir()
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _WavData(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_float)),
        ("length", ctypes.c_int64),
        ("sample_rate", ctypes.c_int32),
    ]


def library_path() -> str:
    """Where the built library for this source and these flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libspevio-{digest}.so")


def _build(so: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native I/O library cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/spevio.cpp (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)  # atomic: other processes building at once see a whole file


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.spev_read_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavData)]
        lib.spev_read_wav.restype = ctypes.c_int
        lib.spev_write_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64, ctypes.c_int32]
        lib.spev_write_wav.restype = ctypes.c_int
        lib.spev_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.spev_free.restype = None
        lib.spev_trim_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.spev_trim_normalize.restype = ctypes.c_int
        lib.spev_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                               ctypes.c_int]
        lib.spev_prefetcher_create.restype = ctypes.c_void_p
        lib.spev_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_WavData)]
        lib.spev_prefetcher_next.restype = ctypes.c_int
        lib.spev_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.spev_prefetcher_destroy.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library loads (building it if needed)."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _take_ownership(lib: ctypes.CDLL, wd: _WavData) -> np.ndarray:
    """A numpy copy of the decoder's buffer, which is then freed."""
    arr = np.ctypeslib.as_array(wd.samples, shape=(wd.length,)).copy()
    lib.spev_free(wd.samples)
    return arr


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(mono float32 waveform in [-1, 1], sample rate) through the C++
    decoder; a file it refuses goes to `wavio.read_wav`."""
    lib = _load()
    wd = _WavData()
    if lib.spev_read_wav(os.fsencode(path), ctypes.byref(wd)) == 0:
        return _take_ownership(lib, wd), int(wd.sample_rate)
    return wavio.read_wav(path)


def write_wav(path: str, data: np.ndarray, sr: int = 22050) -> None:
    """A mono waveform in [-1, 1] as 16-bit PCM through the C++ encoder;
    `wavio.write_wav` when it fails."""
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    lib = _load()
    rc = lib.spev_write_wav(os.fsencode(path), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            len(data), sr)
    if rc != 0:
        wavio.write_wav(path, data, sr)


def trim_normalize(y: np.ndarray, top_db: float = 25.0, normalize: bool = True) -> np.ndarray:
    """Cut leading and trailing frames (2048 samples, hop 512) whose RMS lies
    more than ``top_db`` below the peak frame's, then (``normalize``) divide
    by the peak |sample|; on a copy of ``y``."""
    y = np.ascontiguousarray(np.asarray(y, np.float32)).copy()
    lib = _load()
    start, end = ctypes.c_int64(), ctypes.c_int64()
    lib.spev_trim_normalize(y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(y), top_db,
                            1 if normalize else 0, ctypes.byref(start), ctypes.byref(end))
    return y[start.value:end.value]


class PrefetchingReader:
    """Decode ``paths`` ahead on a C++ thread (at most ``capacity`` files
    waiting).  Iterating yields ``(index, waveform, sample_rate)`` in the
    order of ``paths``, with ``(index, None, 0)`` for a file that does not
    decode.  `close` (or garbage collection) stops the thread and frees what
    was not taken."""

    def __init__(self, paths: Sequence[str], capacity: int = 8):
        self._lib = _load()
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.spev_prefetcher_create(arr, len(self._paths), capacity)
        self._n = len(self._paths)

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray], int]]:
        taken = 0
        while taken < self._n and self._handle:
            wd = _WavData()
            idx = self._lib.spev_prefetcher_next(self._handle, ctypes.byref(wd))
            if idx < 0:
                # the C++ reader reports its end once the last file is claimed
                # by its thread, which may still be decoding it; every file is
                # queued eventually, decoded or not, so wait for the rest
                time.sleep(1e-4)
                continue
            taken += 1
            if wd.length == 0 or not wd.samples:
                if wd.samples:
                    self._lib.spev_free(wd.samples)
                yield idx, None, 0
            else:
                yield idx, _take_ownership(self._lib, wd), int(wd.sample_rate)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.spev_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
