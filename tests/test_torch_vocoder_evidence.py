"""The GAN-vocoder evidence (`spev_tpu_torch.diag.vocoder_evidence`) against
the JAX package's ``tools/gan_copysynth.py``, ``tools/prep_gta_work.py`` and
``tools/gta_demo.py``, run unchanged on the CPU, at 12 formant utterances
with tiny generators (``cli.vocoder``'s ``tiny`` widths, taken for ``v3`` in
both packages):

- copy synthesis of three utterances with one seeded JAX generator: the GAN
  column's MCD within 1e-3 dB per utterance; the Griffin-Lim column, both
  sides drawing JAX's initial phases, within 1e-2 dB (32 momentum
  iterations carry the two packages' rounding differences further than the
  4 of ``tests/test_torch_griffin_lim.py``);
- ``prepare_gta_work`` beside ``prep_gta_work.py``: the same files, byte for
  byte, the same ``meta.json`` keys and ``va_idx``;
- ``evaluate_arms`` beside ``phase_eval`` on one acoustic checkpoint (the
  port's, hidden 32, one block each side) and three JAX generators, both
  reading one feature cache: ``pred_mcd`` and ``copy_mcd`` within 1e-2 dB per
  utterance and arm (before the tool's rounding to 0.01), the same JSON
  keys, three wavs an arm;
- ``run_finetune``: the same ``cli.vocoder`` arguments as JAX's for both
  arms (and with ``--resume_state``), and a 2-step tiny arm on the CPU
  writes its ``gen_*.spev``.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spev_tpu.data.synthetic import generate_formant_corpus
from spev_tpu.models import hifigan as jax_hifigan
from spev_tpu.train.checkpoint import save_checkpoint
from spev_tpu_torch.cli.vocoder import generator_config
from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.diag import vocoder_evidence as ve
from spev_tpu_torch.models import hifigan as port_hifigan
from spev_tpu_torch.models import hifigan_disc
from spev_tpu_torch.ops import griffin_lim as port_gl
from spev_tpu_torch.train.trainer import Trainer

N = 12
VAL_FRACTION = 0.25  # three held-out utterances of twelve
TINY = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),))


def _jax_phase(T, F, seed=0):
    # what spev_tpu.ops.griffin_lim.griffin_lim draws
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (T, F), minval=-np.pi, maxval=np.pi)))


def _jax_tool(name):
    """``tools.<name>`` imported with the process's environment kept."""
    saved = dict(os.environ)
    try:
        module = __import__(f"tools.{name}", fromlist=[name])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return module


@pytest.fixture(scope="module", autouse=True)
def _narrow():
    """Two torch threads (the six-worker run shares the cores), ``v3`` as
    the tiny widths in both packages, JAX's Griffin-Lim phases in the port,
    narrow discriminators for the CPU arm."""
    mp = pytest.MonkeyPatch()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    mp.setattr(jax_hifigan.HiFiGANConfig, "v3", staticmethod(
        lambda: jax_hifigan.HiFiGANConfig(**TINY)))
    mp.setattr(port_hifigan.HiFiGANConfig, "v3", staticmethod(
        lambda: port_hifigan.HiFiGANConfig(**TINY)))
    mp.setattr(port_gl, "random_phase", _jax_phase)
    mp.setattr(hifigan_disc, "_MPD_CHANNELS", (4, 8, 8, 8))
    mp.setattr(hifigan_disc, "_MSD_SPEC", tuple(
        (min(i, 8) if i > 1 else 1, min(o, 8), k, s, 1, p)
        for i, o, k, s, g, p in hifigan_disc._MSD_SPEC))
    yield
    mp.undo()
    torch.set_num_threads(n)


def _save_generator(path, seed, scale=20.0):
    """A seeded tiny JAX generator, scaled up from its 0.01 init so that its
    waveform is not trivially near zero, saved as JAX's ``gen_*.spev``."""
    cfg = jax_hifigan.HiFiGANConfig(**TINY)
    params = jax.tree.map(lambda a: np.asarray(a) * scale,
                          jax_hifigan.init_hifigan(jax.random.PRNGKey(seed), cfg))
    save_checkpoint(path, params=params, model_config={
        "hifigan": True, "resblock": "2", "upsample_rates": [8, 8, 4]})
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The formant corpus and its cache (built by the port: the layout both
    packages read), a seeded hidden-32 acoustic checkpoint written by the
    port's `Trainer` (read by both), and three seeded JAX generators."""
    work = str(tmp_path_factory.mktemp("ve"))
    root, cache = os.path.join(work, "corpus"), os.path.join(work, "cache")
    tg = generate_formant_corpus(root, n_utterances=N, seed=0)
    ds = SpevDataset(root, textgrid_dir=tg, cache_dir=cache, g2p_backend="rules",
                     stats_sample=60, device="cpu")
    cfg = SpevConfig(
        model=ModelConfig(vocab_size=len(ds.vocab), embed_dim=32, hidden_dim=32, n_mels=80,
                          n_encoder_layers=1, n_decoder_layers=1, max_frames=256,
                          vp_output_norm=False),
        train=TrainConfig(batch_size=16, warmup_steps=50, epochs=1))
    acoustic = Trainer(cfg, ds.vocab, ds.stats, ckpt_dir=os.path.join(work, "ck"),
                       log_dir=os.path.join(work, "logs"), device="cpu").save("acoustic")
    gens = {arm: _save_generator(os.path.join(work, f"gen_{arm}.spev"), seed)
            for seed, arm in enumerate(("baseline", "control", "gta"))}
    wavs = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".wav"))
    return dict(work=work, root=root, cache=cache, acoustic=acoustic, gens=gens, wavs=wavs)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def works(corpus, tmp_path_factory):
    """``prep_gta_work.py`` and ``prepare_gta_work`` on the same inputs."""
    theirs, ours = (str(tmp_path_factory.mktemp(n)) for n in ("jax_work", "port_work"))
    prep = _jax_tool("prep_gta_work")
    argv = ["prep_gta_work.py", "--work", theirs, "--acoustic", corpus["acoustic"],
            "--corpus", corpus["root"], "--cache", corpus["cache"],
            "--val_fraction", str(VAL_FRACTION)]
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", argv)
    try:
        prep.main()
    finally:
        mp.undo()
    meta = ve.prepare_gta_work(ours, corpus["acoustic"], corpus["root"], corpus["cache"],
                               val_fraction=VAL_FRACTION, device="cpu")
    return theirs, ours, meta


def _recording(monkeypatch, module, seen):
    """Record every MCD that ``module.mel_cepstral_distortion`` returns."""
    fn = module.mel_cepstral_distortion

    def recorded(a, b):
        seen.append(float(fn(a, b)))
        return seen[-1]

    monkeypatch.setattr(module, "mel_cepstral_distortion", recorded)


def test_copy_synthesis_matches_jax(corpus, monkeypatch, capsys):
    gen, wavs = corpus["gens"]["baseline"], corpus["wavs"][:3]
    tool = _jax_tool("gan_copysynth")
    seen = []
    _recording(monkeypatch, tool, seen)
    monkeypatch.setattr(sys, "argv", ["gan_copysynth.py", gen, *wavs, "--config", "v3"])
    tool.main()
    theirs = capsys.readouterr().out.splitlines()
    out_dir = os.path.join(corpus["work"], "copysynth")
    ours = ve.copy_synthesis(gen, wavs, config="v3", out_dir=out_dir, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    # the tool scores Griffin-Lim first, then the GAN, for each wav
    gl, gan = seen[0::2], seen[1::2]
    rows = [ours["per_utterance"][os.path.splitext(os.path.basename(w))[0]] for w in wavs]
    np.testing.assert_allclose([r["mcd_gan_db"] for r in rows], gan, rtol=0, atol=1e-3)
    np.testing.assert_allclose([r["mcd_gl_db"] for r in rows], gl, rtol=0, atol=1e-2)
    assert ours["mean_mcd_gan_db"] == pytest.approx(np.mean(gan), abs=1e-3)
    assert ours["min_mcd_gan_db"] == min(r["mcd_gan_db"] for r in rows)
    assert ours["max_mcd_gan_db"] == max(r["mcd_gan_db"] for r in rows)
    assert len(lines) == len(theirs) == 4
    assert [s.split(":")[0] for s in lines[:3]] == [s.split(":")[0] for s in theirs[:3]]
    assert lines[3].startswith("mean over 3: ")
    assert sorted(os.listdir(out_dir)) == sorted(
        os.path.splitext(os.path.basename(w))[0] + "_copysynth_gan.wav" for w in wavs)
    skip = ve.copy_synthesis(gen, wavs[:1], skip_gl=True, device="cpu")
    row = next(iter(skip["per_utterance"].values()))
    assert row["mcd_gl_db"] is None and row["mcd_gan_db"] == pytest.approx(gan[0], abs=1e-3)


def test_prepare_gta_work_matches_jax(works):
    theirs, ours, meta = works
    assert _files(ours) == _files(theirs)
    for name in _files(theirs):
        if name == "meta.json":
            continue
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(theirs, "meta.json")) as f:
        ref = json.load(f)
    with open(os.path.join(ours, "meta.json")) as f:
        assert json.load(f) == meta
    assert list(meta) == list(ref) and meta == ref
    assert len(meta["va_idx"]) == 3
    train_wavs = [n for n in _files(os.path.join(ours, "corpus_train")) if n.endswith(".wav")]
    assert len(train_wavs) == N - 3 and not set(meta["val_wavs"]) & set(train_wavs)


def test_evaluate_arms_matches_jax(corpus, works, monkeypatch):
    from spev_tpu.diag import quality as jax_quality
    from spev_tpu_torch.diag import quality as port_quality

    theirs, ours, _ = works
    # one feature cache for both: the comparison is of the evaluation
    for w in (theirs, ours):
        shutil.copytree(corpus["cache"], os.path.join(w, "cache_eval"))
    gens = {arm: corpus["gens"][arm] for arm in ("gta", "control")}
    jax_out, port_out = (os.path.join(w, "gta_metrics.json") for w in (theirs, ours))
    jax_mcd, port_mcd = [], []
    _recording(monkeypatch, jax_quality, jax_mcd)
    _recording(monkeypatch, port_quality, port_mcd)
    ref = _jax_tool("gta_demo").phase_eval(theirs, corpus["gens"]["baseline"], gens, jax_out,
                                           "v3")
    wav_dir = os.path.join(ours, "wavs")
    res = ve.evaluate_arms(ours, corpus["gens"]["baseline"], gens, port_out, "v3",
                           wav_dir=wav_dir, device="cpu")
    # per utterance and arm: the predicted mel's MCD, then the copy's
    assert len(port_mcd) == len(jax_mcd) == 3 * 3 * 2
    np.testing.assert_allclose(port_mcd, jax_mcd, rtol=0, atol=1e-2)
    with open(port_out) as f:
        assert json.load(f) == res
    assert list(res) == list(ref) and res["n_val"] == ref["n_val"] == 3
    assert res["acoustic"] == ref["acoustic"] == {}
    assert list(res["per_utterance"]) == list(ref["per_utterance"]) == ["val0", "val1", "val2"]
    for j, row in ref["per_utterance"].items():
        assert list(res["per_utterance"][j]) == list(row) == ["baseline", "gta", "control"]
        for arm, v in row.items():
            assert list(res["per_utterance"][j][arm]) == list(v)
    for arm, v in ref["summary_mean_mcd_db"].items():
        assert list(res["summary_mean_mcd_db"][arm]) == list(v) == ["pred_mcd", "copy_mcd"]
    assert sorted(os.listdir(wav_dir)) == sorted(
        f"val{j}_predmel_{arm}.wav" for j in range(3) for arm in ("baseline", "gta", "control"))


def test_run_finetune_matches_jax_and_trains(corpus, works, monkeypatch):
    theirs, ours, _ = works
    tool = _jax_tool("gta_demo")
    cmds = []

    def capture(cmd, **kw):
        cmds.append(cmd)
        assert kw["cwd"] == theirs
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(tool.subprocess, "run", capture)
    base = corpus["gens"]["baseline"]
    for gta in (True, False):
        for kw in (dict(disc_warmup=3), dict(resume_state="/s/state_latest.spev")):
            out = tool.run_finetune(theirs, base, 40, gta, "v3", 16, 32, **kw)
            assert cmds[-1][:3] == [sys.executable, "-m", "spev_tpu.cli.vocoder"]
            name = ve.arm_name(gta, kw.get("resume_state"))
            assert ve.finetune_argv(ours, base, 40, gta, "v3", 16, 32, **kw) == [
                a.replace(theirs, ours) for a in cmds[-1][3:]]
            assert out.replace(theirs, ours) == os.path.join(
                ours, "checkpoints", name, "gen_00000040.spev")
    # a 2-step tiny control arm on the CPU
    base_tiny = str(corpus["gens"]["baseline"])
    assert generator_config("tiny") == port_hifigan.HiFiGANConfig(**TINY)
    out = ve.run_finetune(ours, base_tiny, 2, False, config="tiny", batch_size=2,
                          segment_frames=8, device="cpu")
    assert out == os.path.join(ours, "checkpoints", "control_ft", "gen_00000002.spev")
    assert os.path.exists(out) and os.getcwd() != ours
    gen = ve._vocoder(out, "tiny", "cpu").generator
    assert all(torch.isfinite(p).all() for p in gen.parameters())
    # an existing arm is skipped
    assert ve.run_finetune(ours, base_tiny, 2, False, config="tiny", device="cpu") == out
