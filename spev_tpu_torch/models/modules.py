"""Neural-net primitives with the reference model's exact semantics.

Counterpart of ``spev_tpu.models.modules``.  Activations are (B, T, C), as in
the JAX package, so the two are compared like with like; weights keep
PyTorch's own layouts, and the parameter names are the reference
state-dict names (``attention.in_proj_weight`` packed as (3H, H), ...).

- ``layer_norm``: eps 1e-5, biased variance.  Over a single feature it
  returns exactly its bias (the reference's variance predictors end in one).
- ``embedding``: the padding row is pinned to zero at apply time.
- ``multi_head_attention``: written out as matmul + softmax.  Fully masked
  query rows give zeros; ``nn.MultiheadAttention`` and
  ``scaled_dot_product_attention`` give NaN there, so neither is used.
  With a model group, `MultiheadAttention` holds its share of the heads
  (`spev_tpu_torch.parallel.tensor_parallel`).
- ``conv1d``: 'same' zero padding, (out, in, k) weights.
- ``dropout``: an inverted Bernoulli mask drawn from an explicit generator
  (it cannot reproduce JAX's bits, only their distribution).

**Matmul precision** (the session mode, JAX's ``set_matmul_precision``):
the TPU's single-pass mode maps to TF32 on the card, its bf16×3 ``'high'``
and fp32 ``'highest'`` to fp32 with TF32 off.  Operands, accumulators and
outputs stay fp32 in every mode.

| mode | forward products | backward products |
| --- | --- | --- |
| ``'highest'``, ``'high'`` | fp32 | fp32 |
| ``'mixed'`` | fp32 | TF32 for `linear`, `conv1d` and both attention products; fp32 elsewhere |
| ``'default'`` | TF32 | TF32 |

`matmul_precision` enters a mode: it sets the session mode and cuBLAS's and
cuDNN's TF32 flags to the forward's, and restores both on exit.  Under
``'mixed'`` `linear`, `conv1d` and `multi_head_attention`'s products run
through autograd Functions (the counterparts of JAX's ``_dot_mixed`` and
``_conv_mixed``) whose forward runs at the surrounding flags and whose
backward turns TF32 on for its own two products only.  A recompute under
``torch.utils.checkpoint`` therefore runs at the forward's flags, as
``jax.checkpoint`` recomputes at ``'high'``.  Products outside these routes
(the VAD projection, the policy LSTM) run at `get_matmul_precision`, the
flags `matmul_precision` leaves.  The TF32 flags do nothing on the CPU, so
there every mode computes in fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spev_tpu_torch.config import MATMUL_PRECISIONS
from spev_tpu_torch.parallel import tensor_parallel as tp
from spev_tpu_torch.utils.platform import tf32

# the session mode (JAX's default, 'high'); the Trainer enters
# TrainConfig.matmul_precision around its steps
_PRECISION = "high"


def set_matmul_precision(p: str) -> None:
    """Set the session mode (no TF32 flag changes: `matmul_precision` sets
    both)."""
    global _PRECISION
    if p not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {p!r} is not one of {MATMUL_PRECISIONS}")
    _PRECISION = p


def get_matmul_precision() -> str:
    """The session mode as the forward runs it: ``'mixed'`` gives
    ``'high'``."""
    return "high" if _PRECISION == "mixed" else _PRECISION


def forward_tf32(p: str) -> bool:
    """Whether mode ``p`` runs the forward's products in TF32."""
    return p == "default"


@contextlib.contextmanager
def matmul_precision(p: str):
    """Run inside at mode ``p``: the session mode, and TF32 for cuBLAS and
    cuDNN on under ``'default'`` and off otherwise.  The caller's mode and
    flags are restored on exit."""
    global _PRECISION
    saved = _PRECISION
    set_matmul_precision(p)
    try:
        on = forward_tf32(p)
        with tf32(on, on):
            yield
    finally:
        _PRECISION = saved


class _LinearMixed(torch.autograd.Function):
    """``F.linear`` at the surrounding flags; its backward's two products
    (d input, d weight) in TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors  # unpacked (and recomputed) at the forward's flags
        dx = dw = db = None
        with tf32(True, True):
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(g, weight)
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, dw, db


class _MatmulMixed(torch.autograd.Function):
    """``a @ b`` over equal batch dimensions at the surrounding flags; its
    backward's two products in TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with tf32(True, True):
            if ctx.needs_input_grad[0]:
                da = torch.matmul(g, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                db = torch.matmul(a.transpose(-1, -2), g)
        return da, db


class _Conv1dMixed(torch.autograd.Function):
    """``F.conv1d`` on (B, C, T) at the surrounding flags; its backward's
    two products (d input, d weight) in TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conv = (pad, dilation, None if bias is None else bias.shape)
        return F.conv1d(x, weight, bias, padding=pad, dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        pad, dilation, bias_shape = ctx.conv
        need = ctx.needs_input_grad
        with tf32(True, True):
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, weight, bias_shape, [1], [pad], [dilation], False, [0], 1,
                [need[0], need[1], bias_shape is not None and need[2]])
        return dx, dw, db, None, None


def _mixed() -> bool:
    return _PRECISION == "mixed" and torch.is_grad_enabled()


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if _mixed():
        return _LinearMixed.apply(x, weight, bias)
    return F.linear(x, weight, bias)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with equal batch dimensions (the attention's products)."""
    if _mixed():
        return _MatmulMixed.apply(a, b)
    return torch.matmul(a, b)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dilation: int = 1) -> torch.Tensor:
    """'Same'-padded 1-D convolution on (B, T, C) with (O, I, K) weights
    (padding (k-1)·d//2, which is k//2 for odd k at d=1)."""
    pad = (weight.shape[-1] - 1) * dilation // 2
    if _mixed():
        out = _Conv1dMixed.apply(x.transpose(1, 2), weight, bias, pad, dilation)
    else:
        out = F.conv1d(x.transpose(1, 2), weight, bias, padding=pad, dilation=dilation)
    return out.transpose(1, 2)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps inside the sqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def embedding(ids: torch.Tensor, weight: torch.Tensor, padding_idx: Optional[int] = 0) -> torch.Tensor:
    """Lookup with the padding row pinned to zero at apply time."""
    out = F.embedding(ids, weight)
    if padding_idx is None:
        return out
    return torch.where((ids == padding_idx)[..., None], torch.zeros((), dtype=out.dtype,
                       device=out.device), out)


def multi_head_attention(x: torch.Tensor, in_proj_weight: torch.Tensor,
                         in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                         out_bias: torch.Tensor, n_heads: int,
                         key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention in ``nn.MultiheadAttention(batch_first=True)`` layout,
    inference mode.  x: (B, T, H); key_padding_mask: (B, T) bool, True = pad.
    The in-projection (3·n_heads·d, H) may hold a share of the heads; the
    output projection then takes their n_heads·d channels."""
    B, T, _ = x.shape
    q, k, v = (linear(x, w, b) for w, b in
               zip(in_proj_weight.chunk(3, 0), in_proj_bias.chunk(3, 0)))
    d = q.shape[-1] // n_heads

    def heads(t):  # (B, T, H) -> (B, nh, T, d)
        return t.reshape(B, T, n_heads, d).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores, dim=-1)
    if key_padding_mask is not None:
        # fully masked query rows (padded positions) give zeros, not NaN
        attn = attn.masked_fill(key_padding_mask[:, None, :, None], 0.0)
    out = matmul(attn, v).transpose(1, 2).reshape(B, T, n_heads * d)
    return linear(out, out_weight, out_bias)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate).  A no-op when not training, when rate <= 0 or
    when there is no generator.  The generator lies on x's device."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# modules: parameter containers named as in the reference state dict
# ---------------------------------------------------------------------------


class Linear(nn.Linear):
    """``nn.Linear`` through `linear` (the session mode's route)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv1d(nn.Conv1d):
    """'Same'-padded conv on (B, T, C) activations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, self.dilation[0])


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Embedding(nn.Embedding):
    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight, self.padding_idx)


class MultiheadAttention(nn.Module):
    """Packed (3H, H) in-projection plus ``out_proj``, as in
    ``nn.MultiheadAttention``'s state dict.  With ``model_group`` (S ranks)
    this rank holds n_heads/S whole heads of q, k and v: ``in_proj_weight``
    (3H/S, H), ``out_proj.weight`` (H, H/S); the partial outputs are summed
    over the group and ``out_proj.bias`` is added once, after the sum."""

    def __init__(self, dim: int, n_heads: int, model_group=None):
        super().__init__()
        size = tp.model_size(model_group)
        self.n_heads = n_heads // size
        self.model_group = model_group
        local = dim // size
        self.in_proj_weight = nn.Parameter(torch.empty(3 * local, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * local))
        self.out_proj = nn.Linear(local, dim)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        if self.model_group is None:
            return multi_head_attention(x, self.in_proj_weight, self.in_proj_bias,
                                        self.out_proj.weight, self.out_proj.bias,
                                        self.n_heads, key_padding_mask)
        out = multi_head_attention(tp.copy_to_model(x, self.model_group), self.in_proj_weight,
                                   self.in_proj_bias, self.out_proj.weight, None, self.n_heads,
                                   key_padding_mask)
        return tp.reduce_from_model(out, self.model_group) + self.out_proj.bias


# ---------------------------------------------------------------------------
# seeded initialisation (torch-default distributions, explicit generator)
# ---------------------------------------------------------------------------


def uniform_init_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=g))


def normal_init_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=g))


@torch.no_grad()
def init_module_(module: nn.Module, g: torch.Generator) -> None:
    """Initialise one primitive in place as PyTorch's defaults do, drawing
    every number from ``g`` on the CPU (so a seed gives the same weights on
    every device): linear/conv U(±1/√fan_in), attention in-projection
    xavier-uniform with a zero bias, embedding N(0, 1) with a zero padding
    row, LayerNorm ones/zeros.  Apply it to each of ``model.modules()``."""
    if isinstance(module, (nn.Linear, nn.Conv1d)):
        fan_in = module.weight[0].numel()
        uniform_init_(module.weight, 1.0 / math.sqrt(fan_in), g)
        uniform_init_(module.bias, 1.0 / math.sqrt(fan_in), g)
    elif isinstance(module, MultiheadAttention):
        dim = module.in_proj_weight.shape[1]
        uniform_init_(module.in_proj_weight, math.sqrt(6.0 / (2 * dim)), g)
        module.in_proj_bias.zero_()
    elif isinstance(module, nn.Embedding):
        normal_init_(module.weight, 1.0, g)
        if module.padding_idx is not None:
            module.weight[module.padding_idx].zero_()
    elif isinstance(module, nn.LayerNorm):
        module.weight.fill_(1.0)
        module.bias.zero_()
