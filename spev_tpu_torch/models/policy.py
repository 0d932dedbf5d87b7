"""Learned acoustic policy (counterpart of ``spev_tpu.models.policy``): the
future replacement for the rule-based prosody tables, defined but not
trained — Embedding(128) → 2-layer bidirectional LSTM → three heads,
sigmoid breath, sigmoid rough and 2·tanh bright.

``torch.nn.LSTM`` keeps the gate order i, f, g, o and the (4H, in) /
(4H, H) weight layout of the JAX package's parameters, so
`spev_tpu_torch.utils.params.policy_state_dict_from_tree` carries them
over by renaming.  The JAX package runs the LSTM as a ``lax.scan`` outside
any Pallas kernel; here cuDNN's LSTM carries it on the card, its products
at `modules.get_matmul_precision()` (the TF32 flags
`modules.matmul_precision` sets), and the heads through `modules.Linear`.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from spev_tpu_torch.models import modules as m


class PolicyModel(nn.Module):
    """ids (B, T) → (breath, rough, bright), each (B, T)."""

    def __init__(self, vocab_size: int, hidden: int = 128):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, hidden)
        self.lstm = nn.LSTM(hidden, hidden, num_layers=2, bidirectional=True, batch_first=True)
        self.head_breath = m.Linear(2 * hidden, 1)
        self.head_rough = m.Linear(2 * hidden, 1)
        self.head_bright = m.Linear(2 * hidden, 1)

    def forward(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x, _ = self.lstm(self.embedding(ids))
        breath = torch.sigmoid(self.head_breath(x))[..., 0]
        rough = torch.sigmoid(self.head_rough(x))[..., 0]
        bright = torch.tanh(self.head_bright(x))[..., 0] * 2.0
        return breath, rough, bright
