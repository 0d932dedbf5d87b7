"""Megatron tensor parallelism of the FFT blocks over a 'model' process
group (the counterpart of what XLA derives from the JAX package's
``model``-axis shardings, ``spev_tpu/parallel/mesh.py``).

Each block's attention keeps ``n_heads / S`` whole heads of q, k and v on
each of the S ranks of its model group, and its FFN keeps ``inner / S``
channels: ``conv1`` is cut by output channels (column parallel), ``conv2``
and ``out_proj`` by input channels (row parallel).  Two autograd pairs
carry the block:

- `copy_to_model`: the identity forward and an all-reduce (sum) of the
  gradient backward.  It stands in front of ``in_proj`` and ``conv1``,
  whose replicated input feeds S partial products.
- `reduce_from_model`: an all-reduce (sum) forward and the identity
  backward.  It stands after ``out_proj`` and ``conv2``, whose partial
  products sum to the full one; their biases are added once, after it.

Both are ``torch.autograd.Function``s: the trainers take their gradients
with ``torch.autograd.grad``, which no module hook would see.  Everything
outside the blocks' sharded products (the LayerNorms, dropout, the
predictors, K1/K1b, the mel head) runs replicated on every rank of the
group, on equal inputs; dropout's masks are equal across the group because
the trainer seeds its generator from the data index.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.errors import UserError


def model_size(group) -> int:
    """The ranks of a model group (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def check_model_axis(cfg: ModelConfig, size: int) -> None:
    """Raise `UserError` unless a model axis of ``size`` cuts the heads and
    the FFN's inner channels evenly."""
    inner = cfg.hidden_dim * cfg.ffn_expansion
    if size < 1 or cfg.n_heads % size or inner % size:
        raise UserError(f"a 'model' axis of {size} must divide n_heads {cfg.n_heads} and the FFN's "
                        f"inner channels {inner} (hidden_dim × ffn_expansion)")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` forward; the gradient summed over ``group`` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; the gradient as it is backward."""
    return _ReduceFromModel.apply(x, group)
