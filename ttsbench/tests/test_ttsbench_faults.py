"""``correct`` comes out false where it has to: the control (the reference
in bfloat16 in the program's place) fails a limit of each cell, and a run
driven with the timed path broken underneath (the look for a card skipped,
everything else as in a run, at a size the CPU holds) is not correct, once
for each fault the cell can have."""

import pytest
import torch

from ttsbench.lib.runner import execute
from ttsbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242


def _limits_failed(cell, numbers):
    limits = cell.spec["limits"]
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("name", ["v1-batch", "v3-batch", "fs2-train", "v1-open"])
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    numbers = cell.kind.control(cell, SEED, "cpu", "bf16", 2.0)
    assert _limits_failed(cell, numbers), numbers


def test_the_half_batch_fault_is_not_correct_in_the_readings():
    cell = tiny_cell("fs2-train")
    numbers = cell.kind.control(cell, SEED, "cpu", "half_batch", 2.0)
    assert _limits_failed(cell, numbers), numbers


def _altered_mel(monkeypatch):
    from spev_tpu_torch.infer.synthesis import Synthesizer

    orig = Synthesizer._acoustic

    def altered(self, *a, **k):
        mel, mel_len = orig(self, *a, **k)
        return mel + 0.01, mel_len

    monkeypatch.setattr(Synthesizer, "_acoustic", altered)


def _altered_wav(monkeypatch):
    from spev_tpu_torch.infer.vocoder import Vocoder

    orig = Vocoder.run

    def altered(self, mel, mel_len):
        wav = orig(self, mel, mel_len)
        return wav * 1.05

    monkeypatch.setattr(Vocoder, "run", altered)


def _half_rows_served(monkeypatch):
    from spev_tpu_torch.infer.synthesis import Synthesizer

    orig = Synthesizer.synthesize_many

    def half(self, texts, *a, **k):
        keep = len(texts) // 2  # a batch of one leaves out its one row
        rows = orig(self, list(texts)[:keep], *a, **{n: (v[:keep] if hasattr(v, "__len__") else v)
                                                      for n, v in k.items()}) if keep else []
        return rows + [None] * (len(texts) - keep)

    monkeypatch.setattr(Synthesizer, "synthesize_many", half)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch_loss(monkeypatch):
    from spev_tpu_torch.train import trainer

    orig = trainer.forward_losses

    def half(model, cfg, batch, *a, **k):
        B = batch["ids"].shape[0] // 2
        return orig(model, cfg, {n: v[:B] for n, v in batch.items()}, *a, **k)

    monkeypatch.setattr(trainer, "forward_losses", half)


FAULTS = {
    "v1-batch": [_altered_mel, _altered_wav, _half_rows_served],
    "v3-batch": [_altered_wav],
    "v1-open": [_altered_mel, _half_rows_served],
    "fs2-train": [_state_unchanged, _half_batch_loss],
}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = execute(name, SEED, 1.0, False, "cpu", cell=tiny_cell(name))
    assert r["correct"] is False, r["checks"]


def test_the_control_at_the_cells_own_size_on_the_card():
    """The control at full size (the card only; `control.py` runs it with
    the program's readings beside it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size on the card")
    from ttsbench.lib.cells import Cell

    cell = Cell("v1-batch")
    numbers = cell.kind.control(cell, SEED, "cuda", "bf16", 10.0)
    assert _limits_failed(cell, numbers), numbers
