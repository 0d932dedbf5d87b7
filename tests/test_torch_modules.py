"""The PyTorch port's neural-net primitives against spev_tpu.models.modules,
each within 1e-6 on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import torch

from spev_tpu.models import modules as jm
from spev_tpu_torch.models import modules as tm

TOL = 1e-6


def _rng():
    return np.random.default_rng(3)


def test_linear():
    r = _rng()
    x = r.standard_normal((2, 5, 8)).astype(np.float32)
    w = r.standard_normal((6, 8)).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    ref = np.asarray(jm.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x)))
    out = tm.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_conv1d_same():
    r = _rng()
    x = r.standard_normal((2, 11, 6)).astype(np.float32)
    for k in (3, 9):
        w = (0.3 * r.standard_normal((5, 6, k))).astype(np.float32)
        b = r.standard_normal(5).astype(np.float32)
        ref = np.asarray(jm.conv1d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                   jnp.asarray(x)))
        out = tm.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
        assert out.shape == ref.shape == (2, 11, 5)
        np.testing.assert_allclose(out, ref, atol=TOL)


def test_layer_norm_including_single_feature():
    r = _rng()
    for dim in (16, 1):
        x = (3.0 * r.standard_normal((2, 7, dim)) + 1.0).astype(np.float32)
        w = r.standard_normal(dim).astype(np.float32)
        b = r.standard_normal(dim).astype(np.float32)
        ref = np.asarray(jm.layer_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                       jnp.asarray(x)))
        out = tm.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(out, ref, atol=TOL)
    # LayerNorm(1) outputs exactly its bias
    assert np.array_equal(out, np.broadcast_to(b, out.shape))


def test_embedding_padding_row_pinned():
    r = _rng()
    table = r.standard_normal((10, 4)).astype(np.float32)  # row 0 deliberately non-zero
    ids = np.array([[0, 3, 9, 0], [1, 0, 2, 5]], np.int32)
    ref = np.asarray(jm.embedding({"weight": jnp.asarray(table)}, jnp.asarray(ids)))
    out = tm.embedding(torch.from_numpy(ids).long(), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not out[0, 0].any()


def test_mha_masked_rows_give_zeros():
    r = _rng()
    Bn, T, H, nh = 2, 7, 16, 2
    x = r.standard_normal((Bn, T, H)).astype(np.float32)
    w = (0.3 * r.standard_normal((3 * H, H))).astype(np.float32)
    b = (0.1 * r.standard_normal(3 * H)).astype(np.float32)
    ow = (0.3 * r.standard_normal((H, H))).astype(np.float32)
    ob = (0.1 * r.standard_normal(H)).astype(np.float32)
    mask = np.zeros((Bn, T), bool)
    mask[0, 4:] = True
    mask[1, :] = True  # every key and query masked
    params = {"in_proj_weight": jnp.asarray(w.reshape(3, H, H)),
              "in_proj_bias": jnp.asarray(b.reshape(3, H)),
              "out_proj": {"weight": jnp.asarray(ow), "bias": jnp.asarray(ob)}}
    ref = np.asarray(jm.multi_head_attention(params, jnp.asarray(x), nh,
                                             key_padding_mask=jnp.asarray(mask)))
    out = tm.multi_head_attention(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                  torch.from_numpy(ow), torch.from_numpy(ob), nh,
                                  torch.from_numpy(mask)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TOL)
    # fully masked query rows: zero attention, so only the output bias is left
    np.testing.assert_array_equal(out[1], np.broadcast_to(ob, (T, H)))
    # the module form agrees with the function
    mod = tm.MultiheadAttention(H, nh)
    mod.load_state_dict({"in_proj_weight": torch.from_numpy(w), "in_proj_bias": torch.from_numpy(b),
                         "out_proj.weight": torch.from_numpy(ow), "out_proj.bias": torch.from_numpy(ob)})
    with torch.no_grad():
        np.testing.assert_array_equal(mod(torch.from_numpy(x), torch.from_numpy(mask)).numpy(), out)
