"""The PyTorch port's HiFi-GAN generator against spev_tpu.models.hifigan on
the same weights: both ResBlock types within 1e-5 MAE, bucket padding made
invisible by mel_len, and from_pretrained on an upstream-style directory
(config.json + a weight-normed g_* checkpoint)."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spev_tpu.models.hifigan import HiFiGANConfig as JaxCfg
from spev_tpu.models.hifigan import HiFiGANGenerator as JaxGen
from spev_tpu.models.hifigan import apply_hifigan, init_hifigan
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator, fold_weight_norm
from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree

NMEL = 16


def _cfg_kw(resblock):
    return dict(
        resblock=resblock,
        upsample_rates=(4, 4),
        upsample_kernel_sizes=(8, 8),
        upsample_initial_channel=32,
        resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 3), (1, 3)) if resblock == "1" else ((1, 2), (2, 6)),
        num_mels=NMEL,
    )


def _pair(resblock, scale=20.0):
    """JAX params and the port's generator with the same weights (scaled up
    from the 0.01 init so the waveform is not trivially near zero)."""
    jcfg = JaxCfg(**_cfg_kw(resblock))
    params = jax.tree.map(lambda a: np.asarray(a) * scale,
                          init_hifigan(jax.random.PRNGKey(1), jcfg))
    cfg = HiFiGANConfig(**_cfg_kw(resblock))
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(hifigan_state_dict_from_tree(params, cfg))
    return jcfg, params, gen.eval()


def _mel(T=23, B=2, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, NMEL)).astype(np.float32)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_jax(resblock):
    jcfg, params, gen = _pair(resblock)
    mel = _mel()
    ref = np.asarray(apply_hifigan(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(mel)))
    with torch.no_grad():
        out = gen(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 23 * 16)
    assert np.abs(ref).mean() > 1e-3
    assert np.abs(out - ref).mean() < 1e-5


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_bucket_padding_is_invisible(resblock):
    jcfg, params, gen = _pair(resblock)
    L, BUCKET = 19, 32
    mel = _mel(L, B=1, seed=1)
    padded = np.full((1, BUCKET, NMEL), 3.3, np.float32)  # garbage past mel_len
    padded[:, :L] = mel
    with torch.no_grad():
        exact = gen(torch.from_numpy(mel)).numpy()
        bucket = gen(torch.from_numpy(padded), torch.tensor([L])).numpy()
    hop = gen.cfg.hop_recovery
    np.testing.assert_allclose(bucket[:, : L * hop], exact, atol=1e-5)
    ref = np.asarray(apply_hifigan(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(padded),
                                   mel_len=jnp.asarray([L])))
    assert np.abs(bucket - ref).mean() < 1e-5


def test_from_pretrained_weight_normed(tmp_path):
    jcfg, params, gen = _pair("2")
    cfg_json = {
        "resblock": "2",
        "upsample_rates": list(jcfg.upsample_rates),
        "upsample_kernel_sizes": list(jcfg.upsample_kernel_sizes),
        "upsample_initial_channel": jcfg.upsample_initial_channel,
        "resblock_kernel_sizes": list(jcfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in jcfg.resblock_dilation_sizes],
        "num_mels": NMEL,
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    # weight-norm form: v = 2.5·w and g = ‖w‖ over all axes but 0 fold back to w
    sd = {}
    for k, v in gen.state_dict().items():
        if k.endswith("weight"):
            g = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            sd[k + "_g"], sd[k + "_v"] = g, 2.5 * v
        else:
            sd[k] = v
    torch.save({"generator": sd}, str(tmp_path / "g_00000001"))
    torch.save({"generator": {}}, str(tmp_path / "g_00000000"))  # older: ignored

    folded = fold_weight_norm(sd)
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(folded[k], v, atol=1e-6, rtol=1e-5)

    loaded = HiFiGANGenerator.from_pretrained(str(tmp_path))
    ref_gen = JaxGen.from_pretrained(str(tmp_path))
    mel = _mel(17, B=1, seed=2)
    with torch.no_grad():
        out = loaded(torch.from_numpy(mel)).numpy()
    ref = np.asarray(ref_gen(jnp.asarray(mel)))
    assert np.abs(out - ref).mean() < 1e-5


def test_v3_and_json_config_roundtrip(tmp_path):
    v3 = HiFiGANConfig.v3()
    assert v3.hop_recovery == 256 and v3.resblock == "2"
    assert HiFiGANConfig().hop_recovery == 256
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
        "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]}))
    assert HiFiGANConfig.from_json(str(path)) == HiFiGANConfig()
    gen = HiFiGANGenerator.random_init(HiFiGANConfig(**_cfg_kw("1")), seed=3)
    again = HiFiGANGenerator.random_init(HiFiGANConfig(**_cfg_kw("1")), seed=3)
    assert all(torch.equal(a, b) for a, b in zip(gen.state_dict().values(),
                                                  again.state_dict().values()))
