"""The PyTorch port stands alone: no module of it, nor chip_smoke.py, nor the
port's runners in tools/ (``tools/torch_*.py``), imports jax, flax, optax,
msgpack or the JAX package, and importing all of the package leaves them
unloaded."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "spev_tpu"}


def _port_files():
    return (sorted((ROOT / "spev_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("torch_*.py")))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in sorted((ROOT / "spev_tpu_torch").rglob("*.py"))]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device given, the entry points run on CUDA, and without a GPU
    they raise instead of running on the CPU."""
    import torch

    from spev_tpu_torch.config import ModelConfig
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.infer.vocoder import Vocoder
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2

    cfg = ModelConfig(vocab_size=5, embed_dim=8, hidden_dim=8, n_mels=8,
                      n_encoder_layers=1, n_decoder_layers=1)
    ckpt = (FastSpeech2.random_init(cfg).state_dict(), ["<PAD>", "<SIL>", "<UNK>", "a", "b"], {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(ckpt, model_cfg=cfg, g2p_backend="rules")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Vocoder()
    assert Synthesizer(ckpt, model_cfg=cfg, g2p_backend="rules", device="cpu").device.type == "cpu"
