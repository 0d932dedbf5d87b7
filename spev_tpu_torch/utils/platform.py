"""Device selection for the entry points, and the TF32 flags their products
run at."""

from __future__ import annotations

import contextlib

import torch


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
