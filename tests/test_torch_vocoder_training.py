"""Vocoder training in the port against the JAX package, on the CPU.

- The discriminators (MPD periods 2 and 3, two MSD scales; also 5 and 7 on
  a 3-sample signal, where period 7 pads with zeros) on the same weights:
  logits and every feature map within 1e-5 of ``apply_discriminators``.
- JAX's tiny generator (``TINY`` of ``tests/test_vocoder_training.py``)
  with ``periods=(2,)`` and one scale: one split and one fused step from
  JAX's initial state against JAX's split step (losses within 1e-5
  relative, parameters rtol 5e-3 / atol 5e-5, the bar JAX holds its own
  two step forms to), and against each other; bf16 discriminators against
  fp32 (JAX's 8 % bar); ``d_step`` leaves the generator bit-identical and
  lr 0 leaves D unchanged; optax's lr schedule at count 5000; a non-finite
  batch skips.
- The GAN state file both ways (the next step against the uninterrupted
  run: 1e-6 relative within a package, 1e-5 across) and ``gen_*.spev``
  both ways.
- JAX's polyphase-folded generator against the port's (unfolded) one.
- ``log_mel_spectrogram`` values and gradient within 1e-5.
- ``cli.vocoder`` in process: steps, saves, a resume, a warm start with
  ``--disc_warmup``, ``--mesh 2`` outside a launch and the flag surface.
"""

import glob
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spev_tpu.cli import vocoder as jax_cli
from spev_tpu.config import AudioConfig as JAudioConfig
from spev_tpu.models.hifigan import HiFiGANConfig as JaxCfg
from spev_tpu.models.hifigan import init_hifigan
from spev_tpu.models.hifigan_disc import apply_discriminators, init_discriminators
from spev_tpu.models.hifigan_folded import apply_hifigan_folded, fold_hifigan
from spev_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from spev_tpu.train import checkpoint as jax_ckpt
from spev_tpu.train import vocoder_trainer as jvt
from spev_tpu.utils.wavio import write_wav
from spev_tpu_torch.cli import vocoder as cli
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.models.hifigan_disc import Discriminators
from spev_tpu_torch.ops.stft import log_mel_spectrogram
from spev_tpu_torch.train import vocoder_trainer as vt
from spev_tpu_torch.utils.params import (discriminators_state_dict_from_tree,
                                        hifigan_state_dict_from_tree, state_dict_from_tree,
                                        tree_from_state_dict)

TINY_KW = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
               upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), num_mels=80)
JTINY, TINY = JaxCfg(**TINY_KW), HiFiGANConfig(**TINY_KW)
AUDIO = JAudioConfig()
LOSSES = ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel")


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 8, 80)).astype(np.float32) - 6.0
    wav = (0.3 * rng.standard_normal((2, 8 * AUDIO.hop_length))).astype(np.float32)
    return mel, wav


@pytest.fixture(scope="module")
def jax_run(batch):
    """JAX's initial state (numpy), its split step, and the state and
    metrics after one step: computed once for the module."""
    mel, wav = batch
    state = jvt.init_vocoder_train_state(jax.random.PRNGKey(0), JTINY, periods=(2,), n_scales=1)
    init = _np_tree(state)
    step = jvt.make_vocoder_train_step(JTINY, AUDIO, periods=(2,))
    after, m = step(state, jnp.asarray(mel), jnp.asarray(wav))
    return SimpleNamespace(init=init, step=step, after=_np_tree(after),
                           metrics={k: float(v) for k, v in m.items()})


def _fresh_jax(np_state):
    return jax.tree.map(jnp.asarray, np_state)


def _port_state(np_state, **kw):
    """A port state with the weights (not the optimizer) of a JAX state."""
    st = vt.init_vocoder_train_state(TINY, gen_state_dict=state_dict_from_tree(np_state.gen_params),
                                     periods=(2,), n_scales=1, device="cpu", **kw)
    st.discriminators.load_state_dict(discriminators_state_dict_from_tree(np_state.disc_params))
    return st


def _tensors(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _assert_params_close(st, gen_tree, disc_tree, rtol=5e-3, atol=5e-5):
    for net, tree in ((st.generator, gen_tree), (st.discriminators, disc_tree)):
        ref = state_dict_from_tree(tree)
        for name, t in net.state_dict().items():
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=rtol, atol=atol,
                                       err_msg=name)


def _rel(a, b):
    return abs(a - b) / abs(b)


# -- discriminators --------------------------------------------------------------


@pytest.mark.parametrize("periods,n_scales,T", [((2, 3), 2, 1031), ((2, 3), 2, 1032),
                                                ((5, 7), 1, 3)],
                         ids=["reflect-pads", "no-pad", "zero-pad"])
def test_discriminators_match_jax(periods, n_scales, T):
    params = _np_tree(init_discriminators(jax.random.PRNGKey(2), periods=periods,
                                          n_scales=n_scales))
    wav = np.random.default_rng(T).standard_normal((2, T)).astype(np.float32)
    ref = apply_discriminators(jax.tree.map(jnp.asarray, params), jnp.asarray(wav),
                               periods=periods)
    disc = Discriminators(periods, n_scales)
    disc.load_state_dict(discriminators_state_dict_from_tree(params))
    with torch.no_grad():
        outs = disc(torch.from_numpy(wav))
    assert len(outs) == len(ref) == len(periods) + n_scales
    for (lj, fj), (lt, ft) in zip(ref, outs):
        assert lt.shape == lj.shape
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=0)
        assert len(ft) == len(fj)
        for a, b in zip(fj, ft):
            a = np.moveaxis(np.asarray(a), -1, 1)  # NHWC / NLC → NCHW / NCL
            assert b.shape == a.shape
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0)


def test_random_init_is_torch_style_and_seeded():
    a, b = (Discriminators.random_init((2,), 1, seed=5) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.msd[0].convs[1].weight  # (128, 128 / 4, 41)
    bound = 1.0 / np.sqrt(32 * 41)
    top = float(w.detach().abs().max())
    assert 0.9 * bound < top <= bound
    names = {n for n, _ in a.named_parameters()}
    assert {"mpd.0.convs.0.weight", "mpd.0.conv_post1.bias", "mpd.0.conv_post2.weight",
            "msd.0.convs.6.weight", "msd.0.conv_post.bias"} <= names


# -- steps -------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_step_matches_jax(jax_run, batch, fused):
    st, m = vt.make_vocoder_train_step(TINY, fused=fused)(_port_state(jax_run.init),
                                                          *_tensors(batch))
    assert m["skipped"] == 0.0 and st.step == 1 and st.gen_count == st.disc_count == 1
    for k in LOSSES:
        assert _rel(m[k], jax_run.metrics[k]) < 1e-5, (k, m[k], jax_run.metrics[k])
    _assert_params_close(st, jax_run.after.gen_params, jax_run.after.disc_params)


def test_fused_and_split_steps_agree(jax_run, batch):
    split, ms = vt.make_vocoder_train_step(TINY)(_port_state(jax_run.init), *_tensors(batch))
    fused, mf = vt.make_vocoder_train_step(TINY, fused=True)(_port_state(jax_run.init),
                                                            *_tensors(batch))
    for k in LOSSES:
        assert _rel(mf[k], ms[k]) < 1e-5, k
    for a, b in ((split.generator, fused.generator), (split.discriminators, fused.discriminators)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=5e-3,
                                       atol=5e-5, err_msg=name)


def test_bf16_discriminators_track_fp32(jax_run, batch):
    """``--disc_dtype bf16``: finite steps, fp32 master weights and
    optimizer moments, first-step losses within JAX's 8 % bar of fp32."""
    _, m32 = vt.make_vocoder_train_step(TINY)(_port_state(jax_run.init), *_tensors(batch))
    step = vt.make_vocoder_train_step(TINY, disc_dtype="bf16", fused=True)
    st = _port_state(jax_run.init)
    first = None
    for _ in range(3):
        st, m = step(st, *_tensors(batch))
        first = first or m
        assert m["skipped"] == 0.0 and all(np.isfinite(m[k]) for k in LOSSES)
    for p in list(st.generator.parameters()) + list(st.discriminators.parameters()):
        assert p.dtype == torch.float32 and st.disc_opt.state.get(p, st.gen_opt.state.get(p))[
            "exp_avg"].dtype == torch.float32
    for k in ("d_loss", "g_loss", "g_mel"):
        assert abs(first[k] - m32[k]) < 0.08 * max(1.0, abs(m32[k])), (k, first[k], m32[k])


def test_d_step_freezes_generator_and_lr0_freezes_d(jax_run, batch):
    st = _port_state(jax_run.init)
    gen_before = {k: v.clone() for k, v in st.generator.state_dict().items()}
    disc_before = {k: v.clone() for k, v in st.discriminators.state_dict().items()}
    st, d_loss, ok = vt.make_vocoder_train_step(TINY).d_step(st, *_tensors(batch))
    assert ok and np.isfinite(d_loss) and st.disc_count == 1 and st.gen_count == st.step == 0
    for k, v in st.generator.state_dict().items():
        assert torch.equal(v, gen_before[k]), k
    assert not torch.equal(st.discriminators.state_dict()["mpd.0.convs.0.weight"],
                           disc_before["mpd.0.convs.0.weight"])
    _, d_loss_j, _ = jax_run.step.d_step(_fresh_jax(jax_run.init), *map(jnp.asarray, batch))
    assert _rel(d_loss, float(d_loss_j)) < 1e-5

    st0 = _port_state(jax_run.init, lr=0.0)
    st0, _, ok = vt.make_vocoder_train_step(TINY, lr=0.0).d_step(st0, *_tensors(batch))
    assert ok
    for k, v in st0.discriminators.state_dict().items():
        assert torch.equal(v, disc_before[k]), k


def test_lr_schedule_at_count_5000(jax_run, batch, tmp_path):
    """optax ``exponential_decay(2e-4, 1000, 0.999)`` is smooth: at count
    5000 the next update runs at 2e-4·0.999**5.  A JAX state with both
    counts at 5000 goes through the state file into the port, and one
    d_step on each side gives the same discriminators."""
    assert vt.vocoder_lr(2e-4, 5000) == pytest.approx(2e-4 * 0.999 ** 5, rel=1e-12)
    assert vt.vocoder_lr(2e-4, 500) == pytest.approx(2e-4 * 0.999 ** 0.5, rel=1e-12)
    with_counts = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(5000, np.int32) if getattr(path[-1], "name", "") == "count"
        else x, jax_run.init)
    path = str(tmp_path / "state.spev")
    jvt.save_state(path, _fresh_jax(with_counts))
    st = vt.load_state(path, _port_state(jax_run.init))
    assert st.gen_count == st.disc_count == 5000 and st.step == 0
    st, d_loss, ok = vt.make_vocoder_train_step(TINY).d_step(st, *_tensors(batch))
    assert ok and st.disc_count == 5001
    assert st.disc_opt.param_groups[0]["lr"] == pytest.approx(2e-4 * 0.999 ** 5, rel=1e-12)
    jst, _, _ = jax_run.step.d_step(_fresh_jax(with_counts), *map(jnp.asarray, batch))
    assert int(jst.disc_opt[0].count) == int(jst.disc_opt[2].count) == 5001
    ref = state_dict_from_tree(_np_tree(jst.disc_params))
    before = state_dict_from_tree(jax_run.init.disc_params)
    rel = []
    for name, t in st.discriminators.state_dict().items():
        # the update itself (~2·lr an element, all of one lr): a 0.5 % lr
        # error would show on every element; where the gradient is near zero
        # (eps-dominated) the update is ill-conditioned, hence the atol
        delta = t.numpy() - before[name].numpy()
        ref_delta = ref[name].numpy() - before[name].numpy()
        np.testing.assert_allclose(delta, ref_delta, rtol=5e-3,
                                   atol=1e-3 * np.abs(ref_delta).max(), err_msg=name)
        rel.append(np.abs(delta - ref_delta).ravel() / np.abs(ref_delta).ravel())
    assert np.percentile(np.concatenate(rel), 99) < 1e-4


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_nonfinite_batch_skips(jax_run, batch, fused):
    mel, wav = batch
    wav = wav.copy()
    wav[0, 5] = np.nan
    st = _port_state(jax_run.init)
    before = [p.detach().clone() for p in st.generator.parameters()]
    st, m = vt.make_vocoder_train_step(TINY, fused=fused)(st, torch.from_numpy(mel),
                                                          torch.from_numpy(wav))
    assert m["skipped"] == 1.0 and st.step == 0 and st.gen_count == st.disc_count == 0
    assert not st.gen_opt.state and not st.disc_opt.state
    for p, q in zip(st.generator.parameters(), before):
        assert torch.equal(p, q)


# -- files -------------------------------------------------------------------------


def test_state_file_port_to_jax(jax_run, batch, tmp_path):
    step = vt.make_vocoder_train_step(TINY)
    st, _ = step(_port_state(jax_run.init), *_tensors(batch))
    path = str(tmp_path / "state_latest.spev")
    vt.save_state(path, st)
    cont, m_cont = step(st, *_tensors(batch))  # the uninterrupted run

    resumed = vt.load_state(path, _port_state(jax_run.init))
    assert (resumed.step, resumed.gen_count, resumed.disc_count) == (1, 1, 1)
    res, m_res = step(resumed, *_tensors(batch))
    for k in LOSSES:
        assert _rel(m_res[k], m_cont[k]) < 1e-6, k
    _assert_params_close(res, tree_from_state_dict(cont.generator.state_dict()),
                         tree_from_state_dict(cont.discriminators.state_dict()),
                         rtol=1e-6, atol=0)

    template = jvt.init_vocoder_train_state(jax.random.PRNGKey(1), JTINY, periods=(2,),
                                            n_scales=1)
    jres = jvt.load_state(path, template)
    assert int(jres.step) == 1 and int(jres.gen_opt[0].count) == 1
    for a in jax.tree.leaves(jres):
        assert a.dtype in (np.float32, np.int32)
    jres, jm = jax_run.step(jres, *map(jnp.asarray, batch))
    for k in LOSSES:
        assert _rel(float(jm[k]), m_cont[k]) < 1e-5, k
    _assert_params_close(cont, _np_tree(jres.gen_params), _np_tree(jres.disc_params))


def test_state_file_jax_to_port(jax_run, batch, tmp_path):
    path = str(tmp_path / "state_latest.spev")
    jvt.save_state(path, _fresh_jax(jax_run.after))
    _, jm = jax_run.step(_fresh_jax(jax_run.after), *map(jnp.asarray, batch))
    st = vt.load_state(path, _port_state(jax_run.init))
    assert (st.step, st.gen_count, st.disc_count) == (1, 1, 1)
    for p in st.generator.parameters():
        assert torch.equal(st.gen_opt.state[p]["step"], torch.tensor(1.0))
    st, m = vt.make_vocoder_train_step(TINY)(st, *_tensors(batch))
    for k in LOSSES:
        assert _rel(m[k], float(jm[k])) < 1e-5, k
    assert st.step == 2


def test_state_file_refuses_another_configuration(jax_run, tmp_path):
    from spev_tpu_torch.errors import UserError

    path = str(tmp_path / "state.spev")
    vt.save_state(path, _port_state(jax_run.init))
    other = vt.init_vocoder_train_state(TINY, periods=(2,), n_scales=2, device="cpu")
    with pytest.raises(UserError, match="does not match"):
        vt.load_state(path, other)


def test_generator_spev_both_ways(jax_run, tmp_path):
    st = _port_state(jax_run.after)
    st.step = 7
    port_file = str(tmp_path / "gen_port.spev")
    vt.save_generator(port_file, st, TINY)
    params, vocab, stats = jax_ckpt.load_params(port_file)
    ref = state_dict_from_tree(jax_run.after.gen_params)
    for name, t in state_dict_from_tree(params).items():
        assert torch.equal(t, ref[name]), name
    meta = jax_ckpt.load_checkpoint(port_file)["meta"]
    assert meta["step_num"] == 7 and meta["model_config"] == {
        "hifigan": True, "resblock": "2", "upsample_rates": [8, 8, 4]}
    assert vocab == [] and stats == {}

    jax_file = str(tmp_path / "gen_jax.spev")
    jvt.save_generator(jax_file, _fresh_jax(jax_run.after), JTINY)
    gen = vt.load_generator(jax_file, TINY)
    for name, t in gen.state_dict().items():
        assert torch.equal(t, ref[name]), name


# -- the folded generator, the log-mel -----------------------------------------------


def _tiny_v1():
    return dict(resblock="1", upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                upsample_initial_channel=32, resblock_kernel_sizes=(3, 7, 11),
                resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)), num_mels=8)


def _tiny_v3():
    return dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                upsample_initial_channel=16, resblock_kernel_sizes=(3, 5, 7),
                resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)), num_mels=8)


@pytest.mark.parametrize("kw", [_tiny_v1(), _tiny_v3()], ids=["v1", "v3"])
def test_folded_generator_matches_port(kw):
    """``fused_folded`` may run the unfolded generator here: JAX's
    polyphase-folded graph gives the port's generator's waveform."""
    jcfg, cfg = JaxCfg(**kw), HiFiGANConfig(**kw)
    # scaled up from the 0.01 init so the waveform is not trivially near zero
    params = jax.tree.map(lambda a: np.asarray(a) * 20.0, init_hifigan(jax.random.PRNGKey(0), jcfg))
    mel = np.random.default_rng(0).standard_normal((2, 19, 8)).astype(np.float32)
    ref = np.asarray(apply_hifigan_folded(fold_hifigan(jax.tree.map(jnp.asarray, params), jcfg),
                                          jcfg, jnp.asarray(mel)))
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(hifigan_state_dict_from_tree(params, cfg))
    with torch.no_grad():
        out = gen.eval()(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape and np.abs(ref).mean() > 1e-3
    assert np.abs(out - ref).mean() < 1e-5


def test_log_mel_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    y = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
    w = rng.standard_normal((2, 80, 17)).astype(np.float32)
    kw = dict(sr=22050, n_fft=1024, hop_length=256, n_mels=80, fmin=0.0, fmax=11025.0)
    f = jax.vmap(lambda s: jax_log_mel(s, **kw))
    ref = np.asarray(f(jnp.asarray(y)))
    gref = np.asarray(jax.grad(lambda s: jnp.sum(f(s) * w))(jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_(True)
    out = log_mel_spectrogram(yt, **kw)
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), yt)
    assert out.shape == ref.shape == (2, 80, 17)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), gref, atol=1e-5 * np.abs(gref).max(), rtol=0)


# -- the CLI ---------------------------------------------------------------------------


def _wavs(root, n=2, seconds=1.0):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    t = np.arange(int(seconds * 22050)) / 22050
    for i in range(n):
        y = 0.2 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.01 * rng.standard_normal(len(t))
        write_wav(os.path.join(root, f"w{i}.wav"), y.astype(np.float32), 22050)


TINY_ARGS = ["--config", "tiny", "--batch_size", "2", "--segment_frames", "16", "--periods", "2",
             "--scales", "1", "--log_every", "1", "--device", "cpu"]


def test_cli_end_to_end(tmp_path, monkeypatch, capsys):
    data = str(tmp_path / "wavs")
    _wavs(data)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--data_dir", data, "--name", "a", "--steps", "2", "--save_every", "1",
                     *TINY_ARGS]) == 0
    ck = tmp_path / "checkpoints" / "a"
    assert sorted(os.listdir(ck)) == ["gen_00000001.spev", "gen_00000002.spev",
                                      "state_latest.spev"]
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "a" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in LOSSES)

    # an exact resume: the step count goes on
    assert cli.main(["--data_dir", data, "--name", "b", "--steps", "1", "--save_every", "1",
                     "--resume_state", str(ck / "state_latest.spev"), *TINY_ARGS]) == 0
    assert "resumed full GAN state" in capsys.readouterr().out
    st = vt.load_state(str(tmp_path / "checkpoints" / "b" / "state_latest.spev"),
                       vt.init_vocoder_train_state(TINY, periods=(2,), n_scales=1, device="cpu"))
    assert (st.step, st.gen_count, st.disc_count) == (3, 3, 3)

    # a warm start from the trainer's own generator: the warmup step trains D only
    gen_file = str(ck / "gen_00000002.spev")
    assert cli.main(["--data_dir", data, "--name", "c", "--steps", "2", "--save_every", "2",
                     "--finetune_from", gen_file, "--disc_warmup", "1", *TINY_ARGS]) == 0
    out = capsys.readouterr().out
    assert "fine-tuning from" in out and "[disc warmup]" in out
    st = vt.load_state(str(tmp_path / "checkpoints" / "c" / "state_latest.spev"),
                       vt.init_vocoder_train_state(TINY, periods=(2,), n_scales=1, device="cpu"))
    assert (st.step, st.gen_count, st.disc_count) == (1, 1, 2)
    assert glob.glob(str(tmp_path / "checkpoints" / "c" / "gen_*.spev")) == [
        str(tmp_path / "checkpoints" / "c" / "gen_00000002.spev")]


def test_cli_finetunes_from_an_upstream_directory(jax_run, tmp_path, monkeypatch, capsys):
    """``--finetune_from DIR`` (config.json + a weight-normed g_*): the
    generator's architecture comes from the directory, not ``--config``."""
    updir = tmp_path / "upstream"
    updir.mkdir()
    with open(updir / "config.json", "w") as f:
        json.dump({**TINY_KW, "upsample_rates": list(TINY.upsample_rates),
                   "upsample_kernel_sizes": list(TINY.upsample_kernel_sizes),
                   "resblock_kernel_sizes": list(TINY.resblock_kernel_sizes),
                   "resblock_dilation_sizes": [list(d) for d in TINY.resblock_dilation_sizes]},
                  f)
    sd = state_dict_from_tree(jax_run.init.gen_params)
    normed = {}
    for k, v in sd.items():  # the upstream weight-norm form: v and g = ‖v‖ over dims 1..
        if k.endswith("weight"):
            normed[k + "_v"] = v
            normed[k + "_g"] = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        else:
            normed[k] = v
    torch.save({"generator": normed}, updir / "g_00000000")
    data = str(tmp_path / "wavs")
    _wavs(data, n=1)
    monkeypatch.chdir(tmp_path)
    argv = [a for a in TINY_ARGS if a not in ("--config", "tiny")]
    assert cli.main(["--data_dir", data, "--name", "ft", "--steps", "1", "--disc_warmup", "0",
                     "--finetune_from", str(updir), "--config", "v1", *argv]) == 0
    assert f"fine-tuning from {updir}" in capsys.readouterr().out
    gen = vt.load_generator(str(tmp_path / "checkpoints" / "ft" / "gen_00000001.spev"), TINY)
    for name, t in gen.state_dict().items():  # one Adam step (~lr) from the directory's weights
        assert t.shape == sd[name].shape
        np.testing.assert_allclose(t.numpy(), sd[name].numpy(), atol=1e-3, err_msg=name)


@pytest.mark.parametrize("extra,msg", [(["--mesh", "2"], "torch.distributed.run"),
                                       (["--disc_warmup", "3"], "must be < --steps"),
                                       (["--segment_frames", "400"], "long enough")],
                         ids=["mesh", "warmup", "too-short"])
def test_cli_user_errors(tmp_path, monkeypatch, capsys, extra, msg):
    data = str(tmp_path / "wavs")
    _wavs(data, n=1)
    monkeypatch.chdir(tmp_path)
    argv = ["--data_dir", data, "--steps", "2", *TINY_ARGS]
    assert cli.main(argv + extra) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and msg in err


def test_flag_surface_is_jax_plus_device(monkeypatch):
    captured = {}

    class Stop(Exception):
        pass

    def grab(self, argv=None, namespace=None):
        captured["parser"] = self
        raise Stop

    monkeypatch.setattr(jax_cli.argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Stop):
        jax_cli.main(["--data_dir", "x"])
    monkeypatch.undo()

    def flags(p):
        return {s: a for a in p._actions for s in a.option_strings if s not in ("-h", "--help")}

    ours, ref = flags(cli.build_parser()), flags(captured["parser"])
    assert set(ours) == set(ref) | {"--device"}
    for s, a in ref.items():
        assert (ours[s].default, ours[s].choices, ours[s].type) == (a.default, a.choices,
                                                                    a.type), s
