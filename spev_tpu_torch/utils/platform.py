"""Device selection for the entry points, the TF32 flags their products
run at, and where the package's compiled libraries are built."""

from __future__ import annotations

import contextlib
import os

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    """The directory the CUDA kernels' and the native I/O library's ``.so``
    files are built into: the package's ``_build/`` when it is writable (a
    checkout), else ``$XDG_CACHE_HOME/spev_tpu_torch/build``
    (``~/.cache/spev_tpu_torch/build`` without that variable), as an
    installed package may be read-only.  A directory whose mode grants no
    write to anyone counts as read-only even to root, whom `os.access`
    always lets write."""
    local = os.path.join(_PKG, "_build")
    probe = local if os.path.isdir(local) else _PKG
    if os.access(probe, os.W_OK) and os.stat(probe).st_mode & 0o222:
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "spev_tpu_torch", "build")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when CUDA is asked for and no GPU is present — an
    entry point never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """cuBLAS's and cuDNN's TF32 flags set inside (process-wide); the
    caller's settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp32_precision():
    """Matmuls and cuDNN convolutions in full fp32 (TF32 off) inside; the
    caller's settings are restored on exit."""
    return tf32(False, False)
