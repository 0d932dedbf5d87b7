"""The PyTorch port's FastSpeech2 against spev_tpu.models.fastspeech2 on the
same weights (carried over by utils.params): a padded batch of unequal
lengths through the inference, control-override, teacher-forced, nasality and
encoder-bias paths.  mel_pred within 1e-4 MAE; mel_len and durations equal.

The duration predictor's constant is set so that durations land far from the
round-half-to-even ties, where one ulp of exp could flip a frame."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.models.fastspeech2 import apply_fastspeech2, init_fastspeech2
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree, load_reference_checkpoint

V, HID, P, M = 19, 32, 16, 64
SMALL = dict(vocab_size=V, embed_dim=HID, hidden_dim=HID, n_mels=80, n_heads=2,
             n_encoder_layers=2, n_decoder_layers=2, max_frames=M)
BIASES = {"duration": 1.3, "pitch": 0.4, "energy": -0.3, "bright": 0.2, "breath": 0.3,
          "rough": 0.5, "nasal": 0.4}


def _params(nasal=False, vp_output_norm=True, seed=0):
    jcfg = JaxModelConfig(**SMALL, max_phonemes=P, use_nasality=nasal,
                          vp_output_norm=vp_output_norm)
    params = init_fastspeech2(jax.random.PRNGKey(seed), jcfg)
    for name, b in BIASES.items():
        if f"{name}_predictor" in params:
            params[f"{name}_predictor"]["output_norm"]["bias"] = jnp.asarray([b])
    # larger variance embeddings and mel head, so every path moves the mel
    for name in ("pitch", "energy", "breath", "rough", "bright", "nasal", "mel_linear"):
        if name in params or f"{name}_embedding" in params:
            key = name if name == "mel_linear" else f"{name}_embedding"
            params[key]["weight"] = params[key]["weight"] * 30.0
    params = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**SMALL, use_nasality=nasal, vp_output_norm=vp_output_norm)
    model = FastSpeech2(cfg)
    model.load_state_dict(fastspeech2_state_dict_from_tree(params))
    return jcfg, params, model.eval()


def _inputs():
    r = np.random.default_rng(11)
    ids = r.integers(1, V, size=(3, P)).astype(np.int32)
    lens = np.array([16, 9, 12], np.int32)
    ids[np.arange(P)[None, :] >= lens[:, None]] = 0
    return ids, lens


def _compare(jcfg, params, model, **kw):
    ids, lens = _inputs()
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = apply_fastspeech2(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids),
                            jnp.asarray(lens), **jkw)
    before = lr_fused.launches
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(lens), **tkw)
    assert lr_fused.launches == before  # CPU: the plain version, no launch
    np.testing.assert_array_equal(out["mel_len"].numpy(), np.asarray(ref["mel_len"]))
    np.testing.assert_array_equal(out["durations"].numpy(), np.asarray(ref["durations"]))
    mae = np.abs(out["mel_pred"].numpy() - np.asarray(ref["mel_pred"])).mean()
    assert mae < 1e-4, mae
    for k in ("pitch_pred", "energy_pred", "breath_pred", "rough_pred", "bright_pred",
              "log_duration_pred"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5)
    assert np.abs(np.asarray(ref["mel_pred"])).mean() > 1e-2  # the mel is not trivial
    return out


def _per_phoneme(lo, hi, seed=5):
    return np.random.default_rng(seed).uniform(lo, hi, size=(3, P)).astype(np.float32)


CASES = {
    "scalar_controls": dict(d_control=1.2, p_control=0.8, e_control=1.3),
    "per_row_controls": dict(d_control=np.array([[0.8], [1.5], [1.0]], np.float32),
                             p_control=np.array([[1.2], [0.5], [1.0]], np.float32),
                             e_control=np.array([[1.0], [2.0], [0.7]], np.float32)),
    "per_phoneme_controls": dict(d_control=_per_phoneme(0.6, 1.4),
                                 p_control=_per_phoneme(0.5, 1.5, 6),
                                 e_control=_per_phoneme(0.5, 1.5, 7)),
    "quality_overrides": dict(target_breath=_per_phoneme(0.0, 0.9, 8),
                              target_rough=_per_phoneme(0.0, 1.8, 9),
                              target_bright=_per_phoneme(-2.0, 2.0, 10)),
    "teacher_forced": dict(target_durations=np.random.default_rng(1).integers(
                               0, 6, size=(3, P)).astype(np.float32),
                           target_pitch=_per_phoneme(-3.5, 3.5, 11),
                           target_energy=_per_phoneme(-3.5, 3.5, 12),
                           target_breath=_per_phoneme(0.0, 1.2, 13),
                           target_rough=_per_phoneme(0.0, 2.5, 14),
                           target_bright=_per_phoneme(-3.5, 3.5, 15)),
    "encoder_bias": dict(encoder_bias=np.random.default_rng(2).standard_normal(
        (3, P, HID)).astype(np.float32)),
}


@pytest.fixture(scope="module")
def base():
    return _params()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(base, name):
    _compare(*base, **CASES[name])


@pytest.mark.parametrize("override", [False, True])
def test_nasality_channel(override):
    kw = dict(target_nasal=_per_phoneme(0.0, 1.0, 16)) if override else {}
    out = _compare(*_params(nasal=True), **kw)
    assert "nasal_pred" in out


def test_per_phoneme_predictors():
    """vp_output_norm=False: the predictors' convs decide every duration."""
    out = _compare(*_params(vp_output_norm=False, seed=3), d_control=2.0)
    assert len(np.unique(out["durations"].numpy()[0])) > 1


def test_reference_pt_from_jax_export_loads(tmp_path):
    from spev_tpu.train.checkpoint import export_reference_checkpoint

    jcfg, params, _ = _params()
    path = str(tmp_path / "export.pt")
    export_reference_checkpoint(path, params, vocab=["<PAD>", "a"], stats={"p_mean": 1.0})
    sd, vocab, stats = load_reference_checkpoint(path)
    assert vocab == ["<PAD>", "a"] and stats == {"p_mean": 1.0}
    model = FastSpeech2(ModelConfig(**SMALL))
    model.load_state_dict(sd)
    _compare(jcfg, params, model.eval())


def test_config_from_a_stored_jax_dict():
    """A stored JAX config dict (with its TPU-only switches) rebuilds the
    port's config; every field the port keeps has the JAX default."""
    stored = dataclasses.asdict(JaxModelConfig(**SMALL, use_nasality=True))
    stored.pop("clamps")
    cfg = ModelConfig.from_dict(stored)
    assert cfg == ModelConfig(**SMALL, use_nasality=True)
    jax_default = dataclasses.asdict(JaxModelConfig())
    for f in dataclasses.fields(ModelConfig):
        assert getattr(ModelConfig(), f.name) == jax_default[f.name] or f.name == "clamps"
    assert dataclasses.asdict(ModelConfig().clamps) == jax_default["clamps"]


def test_random_init_is_seeded():
    cfg = ModelConfig(**SMALL)
    a, b, c = (FastSpeech2.random_init(cfg, seed=s) for s in (4, 4, 5))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder_blocks.0.conv1.weight"], sc["encoder_blocks.0.conv1.weight"])
    assert not sa["embedding.weight"][0].any()
