"""The PyTorch port's length regulation against the JAX package's: the plain
gather path and the fused kernel's plain version, exact values and mel_len.

The JAX kernel runs in interpret mode, as tests/test_pallas_kernels.py runs
it on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from spev_tpu.ops.length_regulator import length_regulate, length_regulate_feature
from spev_tpu.ops.pallas.length_regulator_kernel import length_regulate_fused as jax_fused
from spev_tpu_torch.ops import length_regulator as lr
from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_plain

B, T, H, F, M = 4, 16, 32, 5, 64


def _case(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    d = rng.integers(0, 5, size=(B, T)).astype(np.float32)
    if name == "guards":
        d[0, 2] = np.nan
        d[0, 5] = np.inf
        d[1, 3] = -2.0
        d[2, 4] = 1001.0
        d[2, 6] = 1000.0  # at the guard: kept, then saturates the bucket
    elif name == "fractional":
        d = d + 0.7  # 2.7 -> 2 (truncation, not rounding)
    elif name == "zero_rows":
        d[1] = 0.0  # all-zero row -> one zero frame
        d[3, ::2] = 0.0  # zero-duration phonemes inside a row
    elif name == "saturated":
        d[:] = 9.0  # total 144 > M
    return x, feats, d


CASES = ["plain", "guards", "fractional", "zero_rows", "saturated"]


@pytest.mark.parametrize("name", CASES)
def test_length_regulate_matches_jax(name):
    x, feats, d = _case(name)
    ref, ref_len = length_regulate(jnp.asarray(x), jnp.asarray(d), M)
    out, out_len = lr.length_regulate(torch.from_numpy(x), torch.from_numpy(d), M)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    assert out_len.dtype == torch.int32
    ref_f = length_regulate_feature(jnp.asarray(feats[..., 0]), jnp.asarray(d), M)
    out_f = lr.length_regulate_feature(torch.from_numpy(feats[..., 0]), torch.from_numpy(d), M)
    np.testing.assert_array_equal(out_f.numpy(), np.asarray(ref_f))


@pytest.mark.parametrize("name", CASES)
def test_length_regulate_fused_matches_jax_kernel(name):
    x, feats, d = _case(name)
    rx, rf, rlen = jax_fused(jnp.asarray(x), jnp.asarray(feats), jnp.asarray(d), M,
                             interpret=True)
    before = lr_fused.launches
    ox, of, olen = lr.length_regulate_fused(torch.from_numpy(x), torch.from_numpy(feats),
                                            torch.from_numpy(d), M)
    assert lr_fused.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(ox.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(of.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(olen.numpy(), np.asarray(rlen))


def test_sanitize_and_edge_rows():
    d = torch.tensor([[2.7, np.nan, -1.0, 1000.0, 1000.5, np.inf]])
    assert lr.sanitize_durations(d).tolist() == [[2, 0, 0, 1000, 0, 0]]
    x = torch.ones(2, 3, 4)
    out, mel_len = lr.length_regulate(x, torch.zeros(2, 3), 8)
    assert mel_len.tolist() == [1, 1] and torch.count_nonzero(out) == 0
    # the frame count caps at the bucket
    _, mel_len = lr.length_regulate(x, torch.full((2, 3), 5.0), 8)
    assert mel_len.tolist() == [8, 8]


def test_lr_fused_wrapper_checks():
    x = torch.zeros(2, 3, 4)
    fpad = torch.zeros(2, 3, 8)
    ends = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        lr_fused(x, fpad, ends.float(), 5)
    with pytest.raises(ValueError):
        lr_fused(x, fpad[:, :2], ends, 5)
    with pytest.raises(ValueError):
        lr_fused(x.to("meta"), fpad.to("meta"), ends.to("meta"), 5)
    xo, fo = lr_fused(x, fpad, ends, 5)
    ref = lr_fused_plain(x, fpad, ends, 5)
    assert torch.equal(xo, ref[0]) and torch.equal(fo, ref[1])
