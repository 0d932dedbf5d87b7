"""Gradients through the PyTorch port's fused length regulation (K1 forward,
K1b backward, both through one autograd Function) against the JAX package's
custom VJP, whose backward is ``_lr_bwd_kernel`` run in interpret mode.
Within 1e-5, with exact zeros where JAX has them (zero-duration phonemes,
padded tails, all-zero rows, frames past the bucket)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spev_tpu.ops.pallas.length_regulator_kernel import length_regulate_fused as jax_fused
from spev_tpu_torch.ops import length_regulator as lr
from spev_tpu_torch.ops.cuda.length_regulator_kernel import (
    N_TRACKS, lr_fused, lr_fused_bwd, lr_fused_bwd_plain)
from spev_tpu_torch.ops.length_regulator import LRFused

B, T, H, F, M = 4, 16, 32, 5, 64


def _case(name):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    d = np.zeros((B, T), np.float32)
    d[0, :8] = 4
    d[1, :5] = [3, 0, 7, 2, 1]   # a zero-duration phoneme inside a row
    d[3, :12] = 2                # row 2 stays all-zero: one zero frame
    if name == "saturating":
        d[3, :] = 9              # total 144 > M: frames past the bucket dropped
    elif name == "guards":
        d[0, 2] = np.nan
        d[0, 5] = -3.0
        d[3, 4] = np.inf
        d[3, 7] = 1001.0
    w = rng.standard_normal((M, H)).astype(np.float32)
    wf = rng.standard_normal((M, F)).astype(np.float32)
    return x, feats, d, w, wf


CASES = ["edges", "saturating", "guards"]


def _jax_grads(x, feats, d, w, wf):
    def loss(x, feats):
        xo, fo, _ = jax_fused(x, feats, jnp.asarray(d), M, interpret=True)
        return jnp.sum(xo * w) + jnp.sum(fo * wf)

    gx, gf = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(feats))
    return np.asarray(gx), np.asarray(gf)


def _torch_grads(x, feats, d, w, wf):
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(feats).requires_grad_(True)
    xo, fo, _ = lr.length_regulate_fused(xt, ft, torch.from_numpy(d), M)
    assert type(xo.grad_fn).__name__ == "LRFusedBackward"
    (torch.sum(xo * torch.from_numpy(w)) + torch.sum(fo * torch.from_numpy(wf))).backward()
    return xt.grad.numpy(), ft.grad.numpy()


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax_bwd_kernel(name):
    args = _case(name)
    jgx, jgf = _jax_grads(*args)
    before = (lr_fused.launches, lr_fused_bwd.launches)
    tgx, tgf = _torch_grads(*args)
    assert (lr_fused.launches, lr_fused_bwd.launches) == before  # CPU: plain versions
    np.testing.assert_allclose(tgx, jgx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgf, jgf, atol=1e-5, rtol=0)
    # exact zeros where JAX has them
    np.testing.assert_array_equal(tgx[jgx == 0], 0.0)
    np.testing.assert_array_equal(tgf[jgf == 0], 0.0)
    assert np.all(tgx[1, 1] == 0) and np.all(tgx[2] == 0) and np.all(tgx[0, 8:] == 0)


def test_saturated_frames_get_no_gradient():
    """A row whose frames run past the bucket: phonemes wholly past M get
    exactly 0, the one straddling M gets only its frames inside."""
    x, feats, d, w, wf = _case("saturating")
    tgx, _ = _torch_grads(x, feats, d, w, wf)
    ends = np.cumsum(d[3].astype(np.int32))
    first_out = int(np.searchsorted(ends, M, side="left"))  # phoneme holding frame M-1
    assert np.all(tgx[3, first_out + 1:] == 0)
    start = int(ends[first_out - 1])
    np.testing.assert_allclose(tgx[3, first_out], w[start:M].sum(0), atol=1e-5)


def test_bwd_plain_is_a_segment_sum():
    """lr_fused_bwd_plain against a loop over phonemes that sums each
    phoneme's frames in float64 and rounds once: bit for bit."""
    rng = np.random.default_rng(5)
    Bq, Tq, Hq, Mq = 3, 7, 5, 20
    d = rng.integers(0, 5, size=(Bq, Tq)).astype(np.int32)
    d[1] = 0
    ends = torch.from_numpy(np.cumsum(d, axis=1).astype(np.int32))
    gx = torch.from_numpy(rng.standard_normal((Bq, Mq, Hq)).astype(np.float32))
    gf = torch.from_numpy(rng.standard_normal((Bq, Mq, N_TRACKS)).astype(np.float32))
    ox, of = lr_fused_bwd_plain(gx, gf, ends, Tq)
    for b in range(Bq):
        for t in range(Tq):
            s = int(ends[b, t - 1]) if t else 0
            e = min(int(ends[b, t]), Mq)
            ref_x = torch.zeros(Hq, dtype=torch.float64)
            ref_f = torch.zeros(N_TRACKS, dtype=torch.float64)
            for j in range(s, e):
                ref_x = ref_x + gx[b, j].double()
                ref_f = ref_f + gf[b, j].double()
            assert torch.equal(ox[b, t], ref_x.float()) and torch.equal(of[b, t], ref_f.float())


def test_grad_only_where_asked():
    """Tracks that are targets (no grad) get None; x still gets its
    gradient, and ends never do."""
    x, feats, d, _, _ = _case("edges")
    xt = torch.from_numpy(x).requires_grad_(True)
    ends = torch.cumsum(torch.from_numpy(d).to(torch.int32), 1, dtype=torch.int32)
    fpad = torch.zeros(B, T, N_TRACKS)
    xo, fo = LRFused.apply(xt, fpad, ends, M)
    assert fo.requires_grad  # the Function marks every output differentiable
    xo.sum().backward()
    assert fpad.grad is None and xt.grad is not None
    # each phoneme's gradient counts its frames inside the bucket
    e = np.minimum(ends.numpy(), M)
    counts = np.diff(e, axis=1, prepend=0)
    np.testing.assert_array_equal(xt.grad[..., 0].numpy(), counts)


def test_lr_fused_bwd_wrapper_checks():
    gx, gf = torch.zeros(2, 5, 4), torch.zeros(2, 5, N_TRACKS)
    ends = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        lr_fused_bwd(gx, gf, ends.float(), 3)
    with pytest.raises(ValueError):
        lr_fused_bwd(gx, gf[:, :4], ends, 3)
    with pytest.raises(ValueError):
        lr_fused_bwd(gx, gf, ends, 4)
    with pytest.raises(ValueError):
        lr_fused_bwd(gx.to("meta"), gf.to("meta"), ends.to("meta"), 3)
    ox, of = lr_fused_bwd(gx, gf, ends, 3)
    assert ox.shape == (2, 3, 4) and of.shape == (2, 3, N_TRACKS)
