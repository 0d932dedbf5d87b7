"""Build and load the package's CUDA kernels (plain C interface + ctypes).

Each ``spev_tpu_torch/csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``spev_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the
source and the flags, and loaded with ``ctypes``.  The sources include no
PyTorch header, so a build takes seconds.  `build_all` starts one ``nvcc``
per source at once (the smoke script builds everything before it runs).
A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("length_regulator", "overlap_add")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def build_all() -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    with _lock:
        started = [(n, _start(n)) for n in SOURCES]
        for n, s in started:
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(_so_path(name))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
