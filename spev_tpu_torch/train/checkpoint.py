"""Training checkpoints in the reference ``.pt`` schema (counterpart of
``spev_tpu.train.checkpoint``'s ``.pt`` interop):

    {'model': state dict, 'optimizer': AdamW state dict or None,
     'vocab': [...], 'stats': {...}, 'step_num': int, 'epoch': int,
     'model_config': {...}}

``model_config`` holds the `ModelConfig` fields that shape the graph (the
clamp contract, which is constant, and the serving-time frame bucket are
left out), so the `Synthesizer` rebuilds the trained architecture.  A
checkpoint without the optimizer (``best``) serves inference; ``last``
keeps it for exact resumption.  `utils.params.read_checkpoint` reads them
back.  The ``.spev`` (msgpack) format is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from spev_tpu_torch.config import ModelConfig


def model_config_dict(cfg: ModelConfig) -> dict:
    d = dataclasses.asdict(cfg)
    for k in ("clamps", "max_frames"):
        d.pop(k, None)
    return d


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], step: int, epoch: int,
                    vocab, stats: dict, model_cfg: ModelConfig) -> None:
    """Write atomically (a temporary file, then a rename), tensors on the CPU."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "vocab": list(vocab),
        "stats": {k: float(v) for k, v in (stats or {}).items()},
        "step_num": int(step),
        "epoch": int(epoch),
        "model_config": model_config_dict(model_cfg),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)

