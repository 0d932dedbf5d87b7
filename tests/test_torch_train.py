"""The port's acoustic training against the JAX package's at a tiny config
(the sizes of tests/test_trainer.py), weights carried across with
utils.params and gradients carried back with the JAX package's own
``fastspeech2_params_from_state_dict``.  The JAX side runs on the CPU at
matmul precision "highest" through its gather length regulator, whose
gradients equal the fused kernel's VJP.

Bars: losses within 1e-5 relative; gradients within 1e-4 of each tensor's
max |g|; the optimizer (clip, AdamW, warmup, skip) within 1e-6 of optax on
shared gradients; five steps' losses within 1e-3 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spev_tpu.config import ModelConfig as JModelConfig
from spev_tpu.config import SpevConfig as JSpevConfig
from spev_tpu.config import TrainConfig as JTrainConfig
from spev_tpu.models import modules as jax_modules
from spev_tpu.parallel.mesh import make_mesh, shard_batch
from spev_tpu.train.loss import compute_losses as jax_compute_losses
from spev_tpu.train.trainer import TrainState, _loss_fn, init_train_state, make_optimizer, make_train_step
from spev_tpu.utils.torch_loader import fastspeech2_params_from_state_dict
from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.models import modules as m
from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
from spev_tpu_torch.train.loss import compute_losses
from spev_tpu_torch.train.trainer import Trainer, loss_and_grads
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree

P, M, H, V, NMEL = 16, 64, 32, 23, 8
MODEL = dict(vocab_size=V, embed_dim=H, hidden_dim=H, n_mels=NMEL, vp_output_norm=False)


def jax_cfg(**train_kw):
    return JSpevConfig(
        model=JModelConfig(**MODEL, max_phonemes=P, max_frames=M),
        train=JTrainConfig(batch_size=8, warmup_steps=10, matmul_precision="highest", **train_kw))


def port_cfg(dropout=0.0, **train_kw):
    return SpevConfig(model=ModelConfig(**MODEL, max_frames=M, dropout=dropout,
                                        vp_dropout=dropout),
                      train=TrainConfig(batch_size=8, warmup_steps=10, **train_kw))


def synth_batch(rng, B=8, n_ph=10):
    ids = np.zeros((B, P), np.int32)
    ids[:, :n_ph] = rng.integers(1, V, size=(B, n_ph))
    durs = np.zeros((B, P), np.float32)
    durs[:, :n_ph] = rng.integers(1, 5, size=(B, n_ph))
    mel_lens = durs.sum(axis=1).astype(np.int32)
    mel = np.zeros((B, M, NMEL), np.float32)
    for b in range(B):
        mel[b, : mel_lens[b]] = rng.standard_normal((mel_lens[b], NMEL)) - 4.0

    def feat(lo, hi):
        return np.where(durs > 0, rng.uniform(lo, hi, (B, P)).astype(np.float32), 0.0)

    return {
        "ids": ids, "lens": np.full((B,), n_ph, np.int32), "durs": durs,
        "mel": np.clip(mel, -10, 2), "mel_lens": mel_lens,
        "log_durs": (np.log(np.maximum(durs, 1) + 1) * (durs > 0)).astype(np.float32),
        "pitch": feat(-1, 1), "energy": feat(-1, 1), "breath": feat(0, 0.8),
        "rough": feat(0, 1.5), "bright": feat(-1, 1),
    }


@pytest.fixture(scope="module")
def jax_side():
    """The JAX config, initial weights and ONE compiled train step."""
    cfg = jax_cfg()
    mesh = make_mesh((1,), ("data",))
    state = init_train_state(jax.random.PRNGKey(0), cfg)
    params0 = jax.tree.map(np.asarray, state.params)
    step = make_train_step(cfg, mesh, state.params, use_dropout=False)
    return cfg, mesh, params0, step


def _fresh_state(cfg, params0):
    params = jax.tree.map(jnp.asarray, params0)
    return TrainState(params, make_optimizer(cfg).init(params), jnp.zeros((), jnp.int32))


def _trainer(params0, tmp_path, cfg=None):
    tr = Trainer(cfg or port_cfg(), [f"p{i}" for i in range(V)], {},
                 ckpt_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "log"), device="cpu")
    tr.model.load_state_dict(fastspeech2_state_dict_from_tree(params0))
    return tr


def _grad_tree(model, grads):
    sd = {name: g.detach().numpy() for (name, _), g in zip(model.named_parameters(), grads)}
    return fastspeech2_params_from_state_dict(sd)


@pytest.mark.parametrize("vw,nasal", [(0.0, False), (1.0, False), (1.0, True)])
def test_losses_match_jax(vw, nasal):
    rng = np.random.default_rng(1)
    batch = synth_batch(rng)
    src_mask = np.arange(P)[None, :] >= batch["lens"][:, None]
    out = {"mel_pred": rng.standard_normal((8, M, NMEL)).astype(np.float32) - 4.0,
           "src_mask": src_mask}
    for k in ("log_duration_pred", "pitch_pred", "energy_pred", "breath_pred", "rough_pred",
              "bright_pred") + (("nasal_pred",) if nasal else ()):
        out[k] = rng.standard_normal((8, P)).astype(np.float32)
    if nasal:
        batch["nasal"] = rng.uniform(0, 1, (8, P)).astype(np.float32)
    jl, jm = jax_compute_losses(jax.tree.map(jnp.asarray, out),
                                jax.tree.map(jnp.asarray, batch), jax_cfg().train, vw)
    tl, tm = compute_losses({k: torch.from_numpy(v) for k, v in out.items()},
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            port_cfg().train, vw)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("vw", [0.0, 1.0])
def test_gradients_match_jax(jax_side, tmp_path, vw):
    cfg, _, params0, _ = jax_side
    batch = synth_batch(np.random.default_rng(2))
    jax_modules.set_matmul_precision("highest")
    (jl, _), jg = jax.value_and_grad(_loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params0), cfg, jax.tree.map(jnp.asarray, batch), None, vw)
    tr = _trainer(params0, tmp_path)
    before = (lr_fused.launches, lr_fused_bwd.launches)
    loss, _, grads = loss_and_grads(tr.model, tr.cfg, tr.to_device(batch), vw)
    assert (lr_fused.launches, lr_fused_bwd.launches) == before  # CPU: plain versions
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ours = _grad_tree(tr.model, grads)
    flat_ref = jax.tree_util.tree_leaves_with_path(jg)
    flat_ours = jax.tree.leaves(ours)
    assert len(flat_ref) == len(flat_ours)
    for (path, ref), got in zip(flat_ref, flat_ours):
        ref = np.asarray(ref)
        bar = 1e-4 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= bar, (jax.tree_util.keystr(path), bar)
    # the encoder gets its gradient through the length regulator's backward
    assert np.abs(ours["encoder_blocks"][0]["conv1"]["weight"]).max() > 0


def test_optimizer_matches_optax(jax_side, tmp_path):
    """Clip, AdamW, warmup and the skip on the same gradients: 3 updates,
    the second skipped (a NaN gradient), the first clipped."""
    cfg, _, params0, _ = jax_side
    rng = np.random.default_rng(4)
    scales = (5.0, 1.0, 1e-3)  # global norms far above and below the clip
    g_trees = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * s).astype(np.float32),
                            params0) for s in scales]
    g_trees[1]["mel_linear"]["bias"][0] = np.nan

    opt = make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, params0)
    opt_state = opt.init(params)
    for g in g_trees:
        if np.isfinite(float(optax.global_norm(g))):
            updates, opt_state = opt.update(jax.tree.map(jnp.asarray, g), opt_state, params)
            params = optax.apply_updates(params, updates)

    tr = _trainer(params0, tmp_path)
    skipped = []
    for g in g_trees:
        sd = fastspeech2_state_dict_from_tree(g)
        grads = [sd[name].clone() for name, _ in tr.model.named_parameters()]
        mt = tr.apply_gradients(grads, torch.tensor(1.0), {})
        skipped.append(mt["skipped"])
    assert skipped == [0.0, 1.0, 0.0] and tr.step == 2
    ours = fastspeech2_state_dict_from_tree(jax.tree.map(np.asarray, params))
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ours[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_five_steps_match_jax(jax_side, tmp_path):
    cfg, mesh, params0, step = jax_side
    batch = synth_batch(np.random.default_rng(6))
    state = _fresh_state(cfg, params0)
    sharded = shard_batch(mesh, batch)
    tr = _trainer(params0, tmp_path)
    tb = tr.to_device(batch)
    for i in range(5):
        state, jm = step(state, sharded, jax.random.PRNGKey(i))
        mt = tr.train_step(tb)
        np.testing.assert_allclose(mt["loss"], float(jm["loss"]), rtol=1e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(mt["lr"], float(jm["lr"]), rtol=1e-6)
        assert mt["skipped"] == float(jm["skipped"]) == 0.0
    assert tr.step == int(state.step) == 5


def _equal_length_batch(rng):
    """Every sample with the same phoneme count and frame total, so the
    micro-batches' loss denominators equal the full batch's."""
    batch = synth_batch(rng)
    durs = np.zeros_like(batch["durs"])
    durs[:, :10] = 3.0
    mel_lens = durs.sum(axis=1).astype(np.int32)
    mel = np.zeros_like(batch["mel"])
    for b in range(len(mel)):
        mel[b, : mel_lens[b]] = rng.standard_normal((mel_lens[b], NMEL)) - 4.0
    batch.update(durs=durs, mel_lens=mel_lens, mel=np.clip(mel, -10, 2),
                 log_durs=(np.log(durs + 1) * (durs > 0)).astype(np.float32))
    return batch


def test_grad_accumulation_matches_full_batch(jax_side, tmp_path):
    _, _, params0, _ = jax_side
    batch = _equal_length_batch(np.random.default_rng(7))
    t1 = _trainer(params0, tmp_path / "a")
    t2 = _trainer(params0, tmp_path / "b", port_cfg(grad_accum=2))
    m1 = t1.train_step(t1.to_device(batch))
    m2 = t2.train_step(t2.to_device(batch))
    assert m1["skipped"] == m2["skipped"] == 0.0 and t1.step == t2.step == 1
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)
    for (name, a), b in zip(t1.model.named_parameters(), t2.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=5e-6, err_msg=name)


def test_grad_accumulation_skips_nan_micro_batch(jax_side, tmp_path):
    _, _, params0, _ = jax_side
    batch = synth_batch(np.random.default_rng(8))
    batch["mel"][0, 0, 0] = np.nan  # poisons only the first micro-batch
    tr = _trainer(params0, tmp_path, port_cfg(grad_accum=2))
    second = {k: v[4:] for k, v in batch.items()}
    ref = _trainer(params0, tmp_path / "ref")
    _, _, g_ref = loss_and_grads(ref.model, ref.cfg, ref.to_device(second), 1.0)
    _, _, g = loss_and_grads(tr.model, tr.cfg, tr.to_device(batch), 1.0)
    for a, b in zip(g, g_ref):  # the mean over the one finite micro-batch
        assert torch.equal(a, b)
    mt = tr.train_step(tr.to_device(batch))
    assert mt["skipped"] == 0.0 and np.isfinite(mt["loss"]) and tr.step == 1
    bad = {**batch, "mel": np.full_like(batch["mel"], np.nan)}
    mt = tr.train_step(tr.to_device(bad))
    assert mt["skipped"] == 1.0 and tr.step == 1


def test_nan_step_changes_nothing_and_budget_aborts(jax_side, tmp_path):
    _, _, params0, _ = jax_side
    tr = _trainer(params0, tmp_path, port_cfg(max_nan_batches=1, prefetch_batches=0))
    good = synth_batch(np.random.default_rng(9))
    tr.train_step(tr.to_device(good))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt_before = [s["exp_avg"].clone() for s in tr.optimizer.state.values()]
    bad = {**good, "mel": good["mel"].copy()}
    bad["mel"][0, 0, 0] = np.nan
    mt = tr.train_step(tr.to_device(bad))
    assert mt["skipped"] == 1.0 and tr.step == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, s in zip(opt_before, tr.optimizer.state.values()):
        assert torch.equal(a, s["exp_avg"]) and float(s["step"]) == 1.0
    with pytest.raises(RuntimeError, match="Too many NaN batches"):
        tr.train_epoch([bad, bad])


def test_resume_from_last_is_exact(jax_side, tmp_path):
    _, _, params0, _ = jax_side
    batch = synth_batch(np.random.default_rng(10))
    straight = _trainer(params0, tmp_path / "a")
    for _ in range(3):
        straight.train_step(straight.to_device(batch))
    first = _trainer(params0, tmp_path / "b")
    for _ in range(2):
        first.train_step(first.to_device(batch))
    first.epoch = 4
    path = first.save("last")
    resumed = _trainer(params0, tmp_path / "c")
    resumed.restore(path)
    assert resumed.step == 2 and resumed.epoch == 4
    resumed.train_step(resumed.to_device(batch))
    for (name, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), name
    # a checkpoint without the optimizer restarts it, with a warning
    first.save("best", include_opt=False)
    again = _trainer(params0, tmp_path / "d")
    with pytest.warns(UserWarning, match="no optimizer state"):
        again.restore(str(tmp_path / "b" / "ckpt" / "best.pt"))
    assert again.step == 2 and not again.optimizer.state


def test_dropout_rate_and_reproducibility():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(3)
    y = m.dropout(x, 0.1, g, training=True)
    assert abs(float((y == 0).float().mean()) - 0.1) < 0.02
    assert torch.all((y == 0) | (y == torch.tensor(1.0) / 0.9))
    again = m.dropout(x, 0.1, torch.Generator().manual_seed(3), training=True)
    assert torch.equal(y, again)
    assert torch.equal(m.dropout(x, 0.1, None, True), x)
    assert torch.equal(m.dropout(x, 0.1, g, False), x)
    assert torch.equal(m.dropout(x, 0.0, g, True), x)


def test_dropout_sites_and_deterministic_forward(jax_side, tmp_path):
    _, _, params0, _ = jax_side
    tr = _trainer(params0, tmp_path, port_cfg(dropout=0.1))
    batch = tr.to_device(synth_batch(np.random.default_rng(11)))
    kw = {f"target_{k}": batch[k] for k in ("pitch", "energy", "breath", "rough", "bright")}
    model = tr.model
    with torch.no_grad():
        model.eval()
        ref = model(batch["ids"], batch["lens"], M, target_durations=batch["durs"], **kw)
        model.train()
        det = model(batch["ids"], batch["lens"], M, target_durations=batch["durs"], **kw)
        drop = [model(batch["ids"], batch["lens"], M, target_durations=batch["durs"],
                      dropout_generator=torch.Generator().manual_seed(s), **kw)
                for s in (1, 1, 2)]
    for k in ("mel_pred", "pitch_pred", "log_duration_pred"):
        assert torch.equal(det[k], ref[k]), k
        assert not torch.equal(drop[0][k], ref[k]), k
    assert torch.equal(drop[0]["mel_pred"], drop[1]["mel_pred"])
    assert not torch.equal(drop[0]["mel_pred"], drop[2]["mel_pred"])


def test_eval_step_and_validate(jax_side, tmp_path):
    _, _, params0, _ = jax_side
    tr = _trainer(params0, tmp_path)
    batch = synth_batch(np.random.default_rng(12))
    ev = tr.eval_step(tr.to_device(batch))
    assert {"val_mel", "val_aux", "mel_pred_0", "mel_target_0", "mel_len_0",
            "log_dur_pred"} <= set(ev)
    val = tr.validate([batch, batch])
    assert np.isfinite(val) and val == pytest.approx(float(ev["val_mel"]), rel=1e-6)
    assert set(tr.last_quality) == {"val_mcd_db", "val_dur_err_pct"}


def test_synthesizer_reads_model_config_from_checkpoint(jax_side, tmp_path):
    """A checkpoint trained with per-phoneme predictors and a narrow model
    is served with that architecture, not the default one."""
    _, _, params0, _ = jax_side
    tr = _trainer(params0, tmp_path)
    path = tr.save("best", include_opt=False)
    synth = Synthesizer(path, hifigan_dir=None, g2p_backend="rules", device="cpu")
    assert synth.model_cfg.vp_output_norm is False and synth.model_cfg.hidden_dim == H
    assert synth.model_cfg.n_mels == NMEL and not synth.model.duration_predictor.use_output_norm
    for k, v in tr.model.state_dict().items():
        assert torch.equal(synth.model.state_dict()[k], v), k


@pytest.mark.parametrize("kw", [{"n_speakers": 4}, {"use_vad": True}], ids=["speakers", "vad"])
def test_advanced_training_is_refused(tmp_path, kw):
    """The configs the Trainer once refused (several speakers, VAD) build
    the advanced model on the CPU, and a batch with speaker ids and VAD
    targets takes a step through it."""
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))
    tr = Trainer(cfg, [f"p{i}" for i in range(V)], {}, ckpt_dir=str(tmp_path),
                 log_dir=str(tmp_path), device="cpu")
    assert tr.model.advanced is not None
    assert (tr.model.advanced.speaker_embedding is not None) == ("n_speakers" in kw)
    rng = np.random.default_rng(14)
    batch = {**synth_batch(rng), "speaker_ids": rng.integers(0, 4, 8).astype(np.int32),
             "vad": rng.uniform(-1, 1, (8, 3)).astype(np.float32)}
    mt = tr.train_step(tr.to_device(batch))
    assert mt["skipped"] == 0.0 and np.isfinite(mt["loss"]) and tr.step == 1


def test_steps_run_in_fp32_and_restore_tf32(tmp_path, monkeypatch):
    """The Trainer's gradient and eval passes run with TF32 off for matmuls
    and cuDNN whatever the process set, and leave its settings as they were."""
    import spev_tpu_torch.train.trainer as trainer_mod

    seen = []

    def spy(fn):
        def call(*a, **k):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return fn(*a, **k)
        return call

    monkeypatch.setattr(trainer_mod, "loss_and_grads", spy(trainer_mod.loss_and_grads))
    monkeypatch.setattr(trainer_mod, "forward_losses", spy(trainer_mod.forward_losses))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tr = Trainer(port_cfg(), [f"p{i}" for i in range(V)], {}, ckpt_dir=str(tmp_path),
                 log_dir=str(tmp_path), device="cpu")
    batch = tr.to_device(synth_batch(np.random.default_rng(13)))
    tr.train_step(batch)
    tr.eval_step(batch)
    # loss_and_grads and its forward, then the eval forward
    assert len(seen) == 3 and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
