"""Mel-spectrogram PNGs (counterpart of ``spev_tpu.diag.plots``).

matplotlib is the optional ``plots`` extra and is imported inside each
function.  Where it is absent the functions raise `UserError`; callers that
must go on without it (a training run, an inference CLI) check `available`
once and skip their PNGs.
"""

from __future__ import annotations

import numpy as np

from spev_tpu_torch.errors import UserError


def available() -> bool:
    """Whether matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise UserError("mel PNGs need matplotlib, the `plots` extra "
                        "(pip install 'spev-tpu[plots]')") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_mel_plot(mel: np.ndarray, path: str, title: str = "Mel Spectrogram") -> None:
    """mel (n_mels, T) → PNG."""
    plt = _pyplot()
    plt.figure(figsize=(10, 4))
    plt.imshow(np.asarray(mel), aspect="auto", origin="lower", interpolation="none")
    plt.colorbar()
    plt.title(title)
    plt.xlabel("Time")
    plt.ylabel("Mel Frequency")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def save_comparison_plot(mel_gt: np.ndarray, mel_pred: np.ndarray, path: str) -> None:
    """Target above prediction, each (n_mels, T): the per-epoch validation
    PNG."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    axes[0].imshow(np.asarray(mel_gt), aspect="auto", origin="lower", interpolation="none")
    axes[0].set_title("Target")
    axes[1].imshow(np.asarray(mel_pred), aspect="auto", origin="lower", interpolation="none")
    axes[1].set_title("Predicted")
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
