"""The port's checkpoint evaluation against the JAX package on the CPU: both
packages' `evaluate_checkpoint` on one in-memory numpy dataset and a
JAX-written ``.spev`` (base, and with speakers, VAD and nasality):
per-utterance ``mcd_db``, ``dur_err_pct``, ``f0_rmse_hz`` and
``vocoded_mcd_db`` (a tiny HiFi-GAN on both sides) within 2e-3 (they are
rounded to 3 places), ``frames`` equal, the same keys, skips and pass
flags; both evaluation CLIs on one written cache; `evaluate_pair`,
`StepTimer` and `timed_steps`."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.diag.quality import evaluate_pair as jax_evaluate_pair
from spev_tpu.infer.evaluate import evaluate_checkpoint as jax_evaluate
from spev_tpu.infer.vocoder import Vocoder as JaxVocoder
from spev_tpu.models import advanced as jax_adv
from spev_tpu.models.fastspeech2 import init_fastspeech2
from spev_tpu.models.hifigan import HiFiGANConfig as JaxHCfg
from spev_tpu.models.hifigan import HiFiGANGenerator as JaxGen
from spev_tpu.models.hifigan import init_hifigan
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.checkpoint import model_config_dict, save_checkpoint
from spev_tpu_torch.diag.profiling import StepTimer, timed_steps, trace
from spev_tpu_torch.diag.quality import evaluate_pair
from spev_tpu_torch.infer.evaluate import evaluate_checkpoint
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree
from tests._torch_cache import PHONES, write_cache

H, NMEL = 32, 80
SMALL = dict(embed_dim=H, hidden_dim=H, n_mels=NMEL, n_encoder_layers=2, n_decoder_layers=2,
             vp_output_norm=False)
ADV = dict(use_vad=True, use_nasality=True, n_speakers=3)
STATS = {"p_mean": 5.0, "p_std": 0.3, "e_mean": -3.0, "e_std": 1.0}
HCFG = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=NMEL)
BUCKETS = dict(phoneme_buckets=(64,), frame_buckets=(128, 256))
TOL = 2e-3


class MemDataset:
    """Utterances in memory, with the dataset surface evaluation reads."""

    def __init__(self, seed=0, n=7):
        rng = np.random.default_rng(seed)
        self.utts = []
        for i in range(n):
            # the last utterance overflows the largest frame bucket
            n_ph = int(rng.integers(5, 40))
            durs = rng.integers(1, 7, n_ph).astype(np.int32)
            if i == n - 1:
                durs[:] = 9
            T = int(durs.sum())
            pitch = rng.uniform(-1, 1, n_ph).astype(np.float32)
            pitch[rng.uniform(size=n_ph) < 0.2] = 0.0  # unvoiced targets
            self.utts.append({
                "phs": [PHONES[k] for k in rng.integers(0, len(PHONES), n_ph)],
                "durs": durs,
                "mel": np.clip(rng.standard_normal((T, NMEL)) - 4.0, -10, 2).astype(np.float32),
                "pitch": pitch,
                "energy": rng.uniform(-1, 1, n_ph).astype(np.float32),
                "breath": rng.uniform(0, 0.8, n_ph).astype(np.float32),
                "rough": rng.uniform(0, 1.5, n_ph).astype(np.float32),
                "bright": rng.uniform(-1, 1, n_ph).astype(np.float32),
                "nasal": rng.uniform(0, 1, n_ph).astype(np.float32),
                "speaker_id": np.int32(i % 3),
                "vad": rng.uniform(-1, 1, 3).astype(np.float32),
            })
        # lengths of all but one: that one is found by loading it
        self.lengths = [(len(u["phs"]), int(u["mel"].shape[0])) for u in self.utts]
        self.lengths[1] = None

    def __len__(self):
        return len(self.utts)

    def load_utterance(self, i):
        return dict(self.utts[i])


def _spev(path, advanced, seed=0):
    vocab = JaxVocab.build(PHONES)
    cfg = JaxModelConfig(vocab_size=len(vocab), **SMALL, **(ADV if advanced else {}))
    key = jax.random.PRNGKey(seed)
    params = jax.tree.map(np.asarray, (jax_adv.init_advanced if advanced
                                       else init_fastspeech2)(key, cfg))
    dp = params["duration_predictor"]["proj"]
    dp["bias"] = np.asarray([np.log(4.0)], np.float32)
    params["pitch_predictor"]["proj"]["bias"] = np.asarray([0.3], np.float32)
    if advanced:
        rng = np.random.default_rng(seed)
        params["advanced"]["vad_proj"]["weight"] = rng.normal(0, 0.5, (H, 3)).astype(np.float32)
    save_checkpoint(path, params, vocab=vocab.symbols, stats=STATS,
                    model_config=model_config_dict(cfg))
    return path


def _same(jres, tres):
    assert tres["skipped"] == jres["skipped"]
    jper, tper = jres["per_utterance"], tres["per_utterance"]
    assert sorted(tper) == sorted(jper)
    for i, j in jper.items():
        t = tper[i]
        assert set(t) == set(j) and t["frames"] == j["frames"]
        for k in set(j) - {"frames"}:
            assert abs(t[k] - j[k]) <= TOL, (i, k, t[k], j[k])
    ja, ta = jres["aggregate"], tres["aggregate"]
    assert set(ta) == set(ja)
    for k, v in ja.items():
        if isinstance(v, bool) or k.startswith("n_"):
            assert ta[k] == v, k
        else:
            assert abs(ta[k] - v) <= TOL, (k, ta[k], v)


@pytest.mark.parametrize("advanced", [False, True], ids=["base", "speakers_vad"])
def test_evaluate_checkpoint_matches_jax(tmp_path, advanced):
    ckpt = _spev(str(tmp_path / "m.spev"), advanced)
    ds = MemDataset()
    jres = jax_evaluate(ckpt, ds, batch_size=3, **BUCKETS)
    tres = evaluate_checkpoint(ckpt, ds, batch_size=3, device="cpu", **BUCKETS)
    _same(jres, tres)
    assert tres["skipped"] == [6] and len(tres["per_utterance"]) == 6
    assert all("f0_rmse_hz" in v for v in tres["per_utterance"].values())
    sub = evaluate_checkpoint(ckpt, ds, indices=[0, 2], batch_size=3, device="cpu", **BUCKETS)
    assert sorted(sub["per_utterance"]) == [0, 2]
    assert sub["per_utterance"][2] == tres["per_utterance"][2]


def test_conditioning_moves_the_score(tmp_path):
    """The speaker/VAD checkpoint is scored with its conditioning: without
    the labels its MCD changes."""
    ckpt = _spev(str(tmp_path / "m.spev"), advanced=True)
    ds = MemDataset()
    with_labels = evaluate_checkpoint(ckpt, ds, batch_size=3, device="cpu", **BUCKETS)
    for u in ds.utts:
        del u["vad"], u["speaker_id"]
    without = evaluate_checkpoint(ckpt, ds, batch_size=3, device="cpu", **BUCKETS)
    a, b = with_labels["per_utterance"], without["per_utterance"]
    assert any(a[i]["mcd_db"] != b[i]["mcd_db"] for i in a)
    _same(jax_evaluate(ckpt, ds, batch_size=3, **BUCKETS), without)


def test_vocoded_mcd_matches_jax(tmp_path):
    ckpt = _spev(str(tmp_path / "m.spev"), advanced=False)
    ds = MemDataset()
    hparams = jax.tree.map(lambda a: np.asarray(a) * 10.0,
                           init_hifigan(jax.random.PRNGKey(1), JaxHCfg(**HCFG)))
    jvoc = JaxVocoder(generator=JaxGen(JaxHCfg(**HCFG), jax.tree.map(jnp.asarray, hparams)),
                      frame_buckets=(128, 256))
    gen = HiFiGANGenerator(HiFiGANConfig(**HCFG))
    gen.load_state_dict(hifigan_state_dict_from_tree(hparams, gen.cfg))
    tvoc = Vocoder(generator=gen, frame_buckets=(128, 256), device="cpu")
    idx = [0, 2, 3]
    jres = jax_evaluate(ckpt, ds, indices=idx, batch_size=2, vocoder=jvoc, **BUCKETS)
    tres = evaluate_checkpoint(ckpt, ds, indices=idx, batch_size=2, vocoder=tvoc, device="cpu",
                               **BUCKETS)
    _same(jres, tres)
    for v in tres["per_utterance"].values():
        assert np.isfinite(v["vocoded_mcd_db"]) and v["vocoded_mcd_db"] > 0
    assert tres["aggregate"]["meets_vocoded_mcd_target_6db"] is False


def test_evaluate_cli_matches_jax(tmp_path, capsys):
    from spev_tpu.cli.evaluate import main as jax_main
    from spev_tpu_torch.cli.evaluate import main

    cache = write_cache(str(tmp_path / "cache"), n_utts=12, n_mels=NMEL)
    ckpt = _spev(str(tmp_path / "m.spev"), advanced=False)
    args = ["--checkpoint", ckpt, "--data_dir", str(tmp_path / "none"), "--cache_dir", cache,
            "--batch_size", "4"]
    out, jout = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert main(args + ["--split", "all", "--device", "cpu", "--json", out]) == 0
    printed = capsys.readouterr().out
    assert "evaluated 12 utterances (all split of 12; 0 over-bucket)" in printed
    assert "MCD:" in printed and "duration error:" in printed and "F0 RMSE:" in printed
    jax_main(args + ["--split", "all", "--json", jout])
    with open(out) as f, open(jout) as g:
        _same(json.load(g), json.load(f))
    # the 95/5 split of 12 utterances: one in val
    assert main(args + ["--split", "val", "--device", "cpu"]) == 0
    assert "evaluated 1 utterances" in capsys.readouterr().out
    # user errors: one line, status 2
    assert main(args[:2] + ["--data_dir", str(tmp_path / "none"), "--cache_dir",
                            str(tmp_path / "empty"), "--device", "cpu"]) == 2
    assert main(["--checkpoint", str(tmp_path / "missing.spev")] + args[2:]
                + ["--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err


def test_evaluation_defaults_to_the_card(tmp_path, monkeypatch):
    from spev_tpu_torch.cli.evaluate import build_parser, main

    ckpt = _spev(str(tmp_path / "m.spev"), advanced=False)
    cache = write_cache(str(tmp_path / "cache"), n_utts=4, n_mels=NMEL)
    argv = ["--checkpoint", ckpt, "--data_dir", str(tmp_path), "--cache_dir", cache]
    assert build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_checkpoint(ckpt, MemDataset())


def test_evaluate_pair_matches_jax():
    rng = np.random.default_rng(0)
    sr, n = 22050, 11025
    t = np.arange(n) / sr
    wa = (0.5 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    wb = (0.5 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)
    ma, mb = rng.standard_normal((40, NMEL)) - 4, rng.standard_normal((44, NMEL)) - 4
    da, db = rng.integers(0, 8, 20), rng.integers(0, 8, 20)
    ours = evaluate_pair(ma, mb, wa, wb, da, db, device="cpu")
    ref = jax_evaluate_pair(ma, mb, wa, wb, da, db)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert abs(ours[k] - v) < 1e-3, k
    assert set(evaluate_pair(ma, mb)) == {"mcd_db", "mcd_target_db"}


def test_step_timer_and_timed_steps(tmp_path):
    timer = StepTimer()
    x = torch.ones(8)
    for _ in range(3):
        out = timer.record(lambda a, k: {"y": (a * k,)}, x, k=2.0)
    assert torch.equal(out["y"][0], x * 2)
    s = timer.summary(warmup=1)
    assert s["steps"] == 2 and 0 <= s["min_s"] <= s["mean_s"] <= s["max_s"]
    assert len(timer.times) == 3
    assert StepTimer().summary() == {"steps": 0}
    assert timed_steps(torch.add, [(x, x)] * 4, warmup=1)["steps"] == 3
    with trace(str(tmp_path / "trace")) as d:
        torch.ones(4).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
