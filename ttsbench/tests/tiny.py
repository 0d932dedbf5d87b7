"""A cell cut to a size the CPU runs in seconds, for the tests: the same
files, traffic kinds and checks, at small widths and short texts."""

from __future__ import annotations

import copy

from ttsbench.lib.cells import Cell

ACOUSTIC = {"embed_dim": 32, "hidden_dim": 32, "n_heads": 2, "n_encoder_layers": 1,
            "n_decoder_layers": 1, "ffn_expansion": 2}
VOCODER = {"upsample_initial_channel": 16}
PARAMS = {
    "batch_synthesis": {"texts_per_call": 6, "batch_size": 4, "warmup_calls": 1,
                        "calls_per_s_cap": 1, "kept_per_call": 2, "kept_calls": 2,
                        "audio_s": [0.3, 1.2]},
    "open_loop": {"rate_per_s": 4.0, "client_threads": 8, "wait_after_s": 30.0,
                  "warmup_lengths": 1, "checked": 3, "max_batch": 4, "audio_s": [0.3, 1.2]},
    "train_loop": {"utterances": 24, "audio_s": [0.3, 1.2], "compared_steps": 3},
}


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["acoustic"].update(ACOUSTIC)
    cell.config["vocoder"].update(VOCODER)
    cell.config["train"]["batch_size"] = 4
    cell.config["train"]["warmup_steps"] = 10
    cell.spec = copy.deepcopy(cell.spec)
    cell.spec["params"].update(PARAMS[cell.spec["kind"]])
    return cell
