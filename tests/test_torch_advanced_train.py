"""Advanced training in the port against the JAX package, on the CPU.

- The labelled build: both packages build one 6-utterance corpus named
  ``{spk}_{utt}_{emotion}`` (3 speakers; one unknown emotion suffix, which
  reads as neutral) with ``multi_speaker`` and ``emotion_vad``: equal
  ``speakers``, ``emotions``, ``emotion_counts`` and per-npz ``speaker_id``
  and ``vad``.
- At a narrow config (hidden 32, 1+1 blocks, VAD, nasality, 3 speakers) the
  advanced loss within 1e-5 relative and every gradient, ``advanced.*`` and
  ``nasal_*`` included, within 1e-4 of its max |g| of JAX's ``_loss_fn``
  (matmul precision "highest"); five steps against ``make_train_step``:
  losses within 1e-3 relative, lr within 1e-6, equal step counts.
- The ``.spev`` train state both ways: JAX's ``Trainer.save`` → the port's
  ``restore`` (moments bit-equal, the next step's loss within 1e-5 of
  JAX's) and the port's ``save`` → JAX's ``load_checkpoint_into`` (the same);
  the port's file has JAX's key set, shapes and dtypes; a ``best.spev``
  without the optimizer warns and restarts it.
- ``cli.spev_advanced --mode train --multi_speaker --emotion_labels`` in
  process on the CPU (a narrow ``ModelConfig``), then ``Synthesizer(best.spev)``
  with speaker 1; and the flag sets of ``spev_tts``, ``real_metrics`` and
  ``spev_advanced`` equal JAX's plus ``--device``.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spev_tpu_torch.config as port_config
from spev_tpu.cli import real_metrics as jax_real_metrics
from spev_tpu.cli import spev_advanced as jax_spev_advanced
from spev_tpu.cli import spev_tts as jax_spev_tts
from spev_tpu.config import ModelConfig as JModelConfig
from spev_tpu.config import SpevConfig as JSpevConfig
from spev_tpu.config import TrainConfig as JTrainConfig
from spev_tpu.data.dataset import SpevDataset as JaxDataset
from spev_tpu.models import modules as jax_modules
from spev_tpu.parallel.mesh import make_mesh, shard_batch
from spev_tpu.train.checkpoint import load_checkpoint, load_checkpoint_into
from spev_tpu.train.trainer import Trainer as JaxTrainer
from spev_tpu.train.trainer import TrainState, _loss_fn, init_train_state, make_optimizer, make_train_step
from spev_tpu.utils.wavio import write_wav
from spev_tpu_torch.cli import real_metrics, spev_advanced, spev_tts
from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.train.checkpoint import load_spev
from spev_tpu_torch.train.trainer import Trainer, loss_and_grads
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree, fastspeech2_tree_from_state_dict

from test_torch_train import M, NMEL, P, V, synth_batch

H = 32
MODEL = dict(vocab_size=V, embed_dim=H, hidden_dim=H, n_mels=NMEL, vp_output_norm=False,
             n_encoder_layers=1, n_decoder_layers=1, use_vad=True, use_nasality=True,
             n_speakers=3)
CORPUS = ["spkA_u0_angry", "spkA_u1_happy", "spkB_u2_sad", "spkB_u3_neutral",
          "spkC_u4_surprise", "spkC_u5_calmish"]


def jax_cfg():
    return JSpevConfig(model=JModelConfig(**MODEL, max_phonemes=P, max_frames=M),
                       train=JTrainConfig(batch_size=8, warmup_steps=10,
                                          matmul_precision="highest"))


def port_cfg():
    return SpevConfig(model=ModelConfig(**MODEL, max_frames=M, dropout=0.0, vp_dropout=0.0),
                      train=TrainConfig(batch_size=8, warmup_steps=10))


def adv_batch(seed):
    rng = np.random.default_rng(seed)
    batch = synth_batch(rng)
    batch["nasal"] = np.where(batch["durs"] > 0, rng.uniform(0, 1, (8, P)), 0.0).astype(np.float32)
    batch["speaker_ids"] = rng.integers(0, 3, 8).astype(np.int32)
    batch["vad"] = rng.uniform(-1, 1, (8, 3)).astype(np.float32)
    return batch


def _flat(tree, pre=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {pre: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{pre}/{k}"))
    return out


# -- the labelled build ------------------------------------------------------


def _write_corpus(root):
    rng = np.random.default_rng(3)
    os.makedirs(root)
    sr = 22050
    for k, name in enumerate(CORPUS):
        t = np.arange(int(0.6 * sr)) / sr
        y = 0.4 * np.sin(2 * np.pi * (110 + 30 * k) * t) + 0.02 * rng.standard_normal(len(t))
        write_wav(os.path.join(root, name + ".wav"), y.astype(np.float32), sr)
        with open(os.path.join(root, name + ".txt"), "w") as f:
            f.write("hello there speaker")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelled")
    corpus = str(root / "corpus")
    _write_corpus(corpus)
    kw = dict(g2p_backend="rules", stats_sample=6, multi_speaker=True, emotion_vad=True)
    jds = JaxDataset(corpus, cache_dir=str(root / "jax_cache"), **kw)
    tds = SpevDataset(corpus, cache_dir=str(root / "port_cache"), device="cpu", **kw)
    return root, corpus, jds, tds


def test_labelled_build_matches_jax(built):
    root, _, jds, tds = built
    assert tds.speakers == jds.speakers == ["spkA", "spkB", "spkC"]
    assert tds.emotions == jds.emotions == ["angry", "happy", "neutral", "sad", "surprise"]
    metas = [json.loads((root / c / "metadata.json").read_text())
             for c in ("jax_cache", "port_cache")]
    assert metas[0]["emotion_counts"] == metas[1]["emotion_counts"] == {
        "angry": 1, "happy": 1, "sad": 1, "neutral": 2, "surprise": 1}
    assert metas[0]["emotions"] == metas[1]["emotions"] and tds.files == jds.files
    for i in range(len(CORPUS)):
        a, b = jds.load_utterance(i), tds.load_utterance(i)
        assert set(a) == set(b)
        assert b["speaker_id"].dtype == a["speaker_id"].dtype == np.int32
        assert int(b["speaker_id"]) == int(a["speaker_id"]) == i // 2
        assert b["vad"].dtype == np.float32 and np.array_equal(b["vad"], a["vad"])
    assert np.array_equal(tds.load_utterance(5)["vad"], np.zeros(3, np.float32))


def test_reread_and_unlabelled_cache(built, tmp_path):
    _, corpus, _, tds = built
    again = SpevDataset(None, cache_dir=tds.cache_dir, emotion_vad=True)
    assert again.speakers == tds.speakers and again.emotions == tds.emotions
    plain = str(tmp_path / "plain")
    SpevDataset(corpus, cache_dir=plain, g2p_backend="rules", stats_sample=6, device="cpu")
    assert "emotions" not in json.loads(open(os.path.join(plain, "metadata.json")).read())
    with pytest.raises(UserError, match="without emotion-VAD labels"):
        SpevDataset(None, cache_dir=plain, emotion_vad=True)
    # the same labelled build over two worker processes
    par = SpevDataset(corpus, cache_dir=str(tmp_path / "w"), build_workers=2, device="cpu",
                      g2p_backend="rules", stats_sample=6, multi_speaker=True, emotion_vad=True)
    assert (par.files, par.speakers, par.emotions) == (tds.files, tds.speakers, tds.emotions)
    metas = [json.loads(open(os.path.join(c, "metadata.json")).read())
             for c in (tds.cache_dir, par.cache_dir)]
    assert metas[0] == metas[1]
    for i in range(len(par)):
        a, b = tds.load_utterance(i), par.load_utterance(i)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# -- the advanced step -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX config, initial weights with a nonzero VAD projection, and one
    compiled advanced train step."""
    cfg = jax_cfg()
    mesh = make_mesh((1,), ("data",))
    state = init_train_state(jax.random.PRNGKey(0), cfg)
    params0 = jax.tree.map(np.asarray, state.params)
    rng = np.random.default_rng(5)
    params0["advanced"]["vad_proj"]["weight"] = rng.normal(0, 0.5, (H, 3)).astype(np.float32)
    params0["advanced"]["vad_proj"]["bias"] = rng.normal(0, 0.1, (H,)).astype(np.float32)
    step = make_train_step(cfg, mesh, params0, use_dropout=False,
                           batch_keys=tuple(sorted(adv_batch(0))))
    return cfg, mesh, params0, step


def _fresh_state(cfg, params0):
    params = jax.tree.map(jnp.asarray, params0)
    return TrainState(params, make_optimizer(cfg).init(params), jnp.zeros((), jnp.int32))


def _trainer(params0, path):
    tr = Trainer(port_cfg(), [f"p{i}" for i in range(V)], {}, ckpt_dir=str(path / "ckpt"),
                 log_dir=str(path / "log"), device="cpu")
    tr.model.load_state_dict(fastspeech2_state_dict_from_tree(params0))
    return tr


def test_trainer_builds_the_advanced_model(tmp_path):
    tr = Trainer(port_cfg(), [f"p{i}" for i in range(V)], {}, ckpt_dir=str(tmp_path),
                 log_dir=str(tmp_path), device="cpu")
    adv = tr.model.advanced
    assert adv is not None and adv.speaker_embedding.weight.shape == (3, H)
    assert not adv.vad_proj.weight.any() and 0 < adv.speaker_embedding.weight.std() < 0.02
    names = [n for n, _ in tr.model.named_parameters()]
    assert {"advanced.vad_proj.weight", "advanced.speaker_embedding.weight",
            "nasal_embedding.weight"} <= set(names)
    assert len(tr.params) == len(names)  # every parameter is in AdamW and the clip
    tb = tr.to_device(adv_batch(1))
    assert tb["speaker_ids"].dtype == torch.long
    m = tr.train_step(tb)
    assert m["skipped"] == 0.0 and np.isfinite(m["loss"]) and tr.step == 1
    assert adv.vad_proj.weight.abs().max() > 0  # the VAD head learns from the batch's vad


def test_advanced_loss_and_gradients_match_jax(jax_side, tmp_path):
    cfg, _, params0, _ = jax_side
    batch = adv_batch(2)
    jax_modules.set_matmul_precision("highest")
    (jl, _), jg = jax.value_and_grad(_loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params0), cfg, jax.tree.map(jnp.asarray, batch), None, 1.0)
    tr = _trainer(params0, tmp_path)
    loss, _, grads = loss_and_grads(tr.model, tr.cfg, tr.to_device(batch), 1.0)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ours = _flat(fastspeech2_tree_from_state_dict(
        {n: g for (n, _), g in zip(tr.model.named_parameters(), grads)}))
    ref = {k: np.asarray(v) for k, v in _flat(jg).items()}
    assert set(ours) == set(ref)
    for path, r in ref.items():
        bar = 1e-4 * np.abs(r).max()
        assert np.abs(ours[path] - r).max() <= bar, (path, bar)
    for path in ("/advanced/vad_proj/weight", "/advanced/speaker_embedding/weight",
                 "/nasal_embedding/weight", "/nasal_predictor/proj/weight"):
        assert np.abs(ref[path]).max() > 0, path


def test_five_advanced_steps_match_jax(jax_side, tmp_path):
    cfg, mesh, params0, step = jax_side
    batch = adv_batch(3)
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


# -- the .spev train state ---------------------------------------------------


def _jax_trainer(path):
    return JaxTrainer(jax_cfg(), [f"p{i}" for i in range(V)], {}, ckpt_dir=str(path / "jck"),
                      log_dir=str(path / "jlog"), mesh=make_mesh((1,), ("data",)))


def _moments(tr):
    """The port's AdamW moments and step as JAX trees keyed by path."""
    named = list(tr.model.named_parameters())
    mu = {n: tr.optimizer.state[p]["exp_avg"] for n, p in named}
    nu = {n: tr.optimizer.state[p]["exp_avg_sq"] for n, p in named}
    steps = {int(tr.optimizer.state[p]["step"]) for _, p in named}
    return (_flat(fastspeech2_tree_from_state_dict(mu)),
            _flat(fastspeech2_tree_from_state_dict(nu)), steps)


def test_jax_last_spev_resumes_in_the_port(jax_side, tmp_path):
    cfg, mesh, params0, step = jax_side
    batch = adv_batch(4)
    sharded = shard_batch(mesh, batch)
    state = _fresh_state(cfg, params0)
    for i in range(2):
        state, _ = step(state, sharded, jax.random.PRNGKey(i))
    jt = _jax_trainer(tmp_path)
    jt.state, jt.epoch = state, 3
    path = jt.save("last")
    tr = _trainer(params0, tmp_path)
    tr.restore(path)
    assert tr.step == 2 and tr.epoch == 3
    mu, nu, steps = _moments(tr)
    adam = state.opt_state[1][0]
    assert steps == {int(adam.count)} == {2}
    for ours, ref in ((mu, _flat(adam.mu)), (nu, _flat(adam.nu))):
        for k, v in ref.items():
            assert np.array_equal(ours[k], np.asarray(v)), k
    state, jm = step(state, sharded, jax.random.PRNGKey(2))
    mt = tr.train_step(tr.to_device(batch))
    np.testing.assert_allclose(mt["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mt["lr"], float(jm["lr"]), rtol=1e-6)
    assert tr.step == int(state.step) == 3


def test_port_last_spev_resumes_in_jax(jax_side, tmp_path):
    cfg, mesh, params0, step = jax_side
    batch = adv_batch(6)
    tr = _trainer(params0, tmp_path)
    tb = tr.to_device(batch)
    for _ in range(2):
        tr.train_step(tb)
    tr.epoch = 5
    path = tr.save("last")
    assert path.endswith("last.spev") and not os.path.exists(path[:-5] + ".pt")
    state, epoch = load_checkpoint_into(path, _fresh_state(cfg, params0))
    assert epoch == 5 and int(state.step) == 2
    adam, sched = state.opt_state[1][0], state.opt_state[1][2]
    assert int(adam.count) == int(sched.count) == 2
    mu, nu, _ = _moments(tr)
    for ours, ref in ((mu, _flat(adam.mu)), (nu, _flat(adam.nu))):
        for k, v in ref.items():
            assert np.array_equal(ours[k], np.asarray(v)), k
    state, jm = step(state, shard_batch(mesh, batch), jax.random.PRNGKey(0))
    mt = tr.train_step(tb)
    np.testing.assert_allclose(float(jm["loss"]), mt["loss"], rtol=1e-5)
    assert tr.step == int(state.step) == 3


def test_port_spev_has_jax_layout(tmp_path):
    cfg = SpevConfig(model=ModelConfig(**MODEL, max_frames=M), train=port_cfg().train)
    tr = Trainer(cfg, [f"p{i}" for i in range(V)], {"p_mean": 1.0},
                 ckpt_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "lg"), device="cpu")
    tr.train_step(tr.to_device(adv_batch(7)))
    jt = _jax_trainer(tmp_path)
    for include_opt in (True, False):
        ours = load_spev(tr.save("last", include_opt=include_opt))
        ref = load_checkpoint(jt.save("last", include_opt=include_opt))
        assert sorted(ours) == sorted(ref) and sorted(ours["meta"]) == sorted(ref["meta"])
        a = {k: (np.shape(v), np.asarray(v).dtype) for k, v in
             _flat({"model": ours["model"], "optimizer": ours["optimizer"]}).items()}
        b = {k: (np.shape(v), np.asarray(v).dtype) for k, v in
             _flat({"model": ref["model"], "optimizer": ref["optimizer"]}).items()}
        assert a == b
        # the stored config: JAX's fields less its TPU-only switches, equal values
        mc, jmc = ours["meta"]["model_config"], ref["meta"]["model_config"]
        assert set(mc) <= set(jmc) and all(mc[k] == jmc[k] for k in mc)
        assert set(jmc) - set(mc) == {"use_pallas_lr", "fused_predictors"}
    opt = ours["optimizer"] if include_opt else load_spev(tr.save("last"))["optimizer"]
    assert opt["0"] == {} and opt["1"]["1"] == {} and int(opt["1"]["2"]["count"]) == 1


def test_best_spev_without_optimizer_restarts_it(jax_side, tmp_path):
    cfg, _, params0, _ = jax_side
    jt = _jax_trainer(tmp_path)
    jt.state = jt.state._replace(step=jnp.asarray(4, jnp.int32))
    path = jt.save("best", include_opt=False)
    tr = _trainer(params0, tmp_path)
    with pytest.warns(UserWarning, match="no optimizer state"):
        tr.restore(path)
    assert tr.step == 4 and not tr.optimizer.state
    ref = fastspeech2_state_dict_from_tree(jax.tree.map(np.asarray, jt.state.params))
    for n, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), ref[n]), n


# -- the CLI -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TinyModelConfig(port_config.ModelConfig):
    """The default config narrowed to what the CPU trains in seconds."""

    embed_dim: int = 32
    hidden_dim: int = 32
    n_encoder_layers: int = 1
    n_decoder_layers: int = 1


def test_cli_advanced_train_then_serve(built, tmp_path, monkeypatch, capsys):
    _, corpus, _, tds = built
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_config, "ModelConfig", TinyModelConfig)
    shutil.copytree(tds.cache_dir, tmp_path / "cache")
    argv = ["--data_dir", corpus, "--cache_dir", "cache", "--name", "adv", "--epochs", "2",
            "--batch_size", "3", "--multi_speaker", "--emotion_labels", "--device", "cpu"]
    assert spev_advanced.train_main(argv) == 0
    out = capsys.readouterr().out
    assert "Multi-speaker: 3 speakers (spkA, spkB, spkC)" in out
    assert "Emotion-VAD labels: angry, happy, neutral, sad, surprise" in out
    ck = tmp_path / "checkpoints" / "adv"
    assert sorted(os.listdir(ck)) == ["best.spev", "last.spev"]
    rows = [json.loads(line) for line in (tmp_path / "logs" / "adv" / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and r["skipped"] == 0 for r in rows)
    meta = load_spev(str(ck / "last.spev"))["meta"]
    assert meta["model_config"]["n_speakers"] == 3 and meta["model_config"]["use_vad"]
    assert meta["model_config"]["use_nasality"] and not meta["model_config"]["vp_output_norm"]
    synth = Synthesizer(str(ck / "best.spev"), hifigan_dir=None, g2p_backend="rules",
                        device="cpu")
    assert synth.has_advanced and synth.model_cfg.n_speakers == 3
    ids = synth.phonemes_to_ids(synth.g2p.phonemes("hello there"))
    wav, mel = synth.synthesize_ids(ids, speaker_id=1, vad=(0.8, 0.6, 0.3))
    assert mel.shape[1] == 80 and len(wav) == mel.shape[0] * 256 and np.isfinite(wav).all()
    # resume one more epoch from last.spev
    assert spev_advanced.train_main([a if a != "2" else "3" for a in argv]
                                    + ["--resume", str(ck / "last.spev")]) == 0
    rows = [json.loads(line) for line in (tmp_path / "logs" / "adv" / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [0, 1, 2]


def test_cli_train_errors_exit_2(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for main in (spev_advanced.train_main, lambda a: spev_tts.main(["--mode", "train"] + a),
                 lambda a: real_metrics.main(["--mode", "train"] + a)):
        assert main(["--data_dir", "nowhere", "--cache_dir", "none", "--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error: no wavs under nowhere") and err.count("\n") == 1


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("ours,ref", [(spev_tts, jax_spev_tts), (real_metrics, jax_real_metrics),
                                      (spev_advanced, jax_spev_advanced)],
                         ids=["spev_tts", "real_metrics", "spev_advanced"])
def test_flag_surfaces_are_jax_plus_device(ours, ref):
    assert _flags(ours.build_parser()) == _flags(ref.build_parser()) | {"--device"}
    defaults = {a.dest: a.default for a in ref.build_parser()._actions}
    for a in ours.build_parser()._actions:
        if a.dest in defaults:
            assert a.default == defaults[a.dest], a.dest
