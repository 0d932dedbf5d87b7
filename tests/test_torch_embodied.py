"""The embodied agent, its BiLSTM policy and its CLIs in the port against
the JAX package, on the CPU.

- `EmbodiedAgent` static and temporal, each with two emotions, on the tiny
  advanced ``.spev`` and HiFi-GAN of tests/test_torch_advanced.py, with
  JAX's event noise replayed in the port: equal lengths and waveform MAE
  < 1e-5 — the segment order, the 0.1 s silences, the events and the
  per-phoneme control curves (a temporal segment over the largest phoneme
  bucket included).
- `PolicyModel` with JAX's weights carried over against
  ``apply_policy_model``: within 1e-5.
- ``cli.embodied`` (``main`` and ``temporal_main``) in process: exit 0 with
  a waveform, exit 2 with one ``error:`` line on a bad checkpoint; the flag
  sets equal JAX's plus ``--device``.
"""

import jax
import numpy as np
import pytest
import torch

from spev_tpu.agents.embodied import EmbodiedAgent as JaxAgent
from spev_tpu.cli import embodied as jax_cli
from spev_tpu.models import modules as jax_modules
from spev_tpu.models.policy import apply_policy_model, init_policy_model
from spev_tpu_torch.agents.embodied import EmbodiedAgent
from spev_tpu_torch.cli import embodied as cli
from spev_tpu_torch.models.policy import PolicyModel
from spev_tpu_torch.utils.params import policy_state_dict_from_tree
from spev_tpu_torch.utils.wavio import read_wav

from test_torch_advanced import _pair, hifigan, jax_noise, spev_path  # noqa: F401 (fixtures)

TEXT = "I made it [sigh] but I am so tired [breath] let us go"
LONG = "calm [grunt] " + " ".join(["calming phrase edge"] * 8)


@pytest.mark.parametrize("temporal,emotion,text", [
    (False, "exhausted", TEXT), (False, "angry", TEXT),
    (True, "relief", TEXT), (True, "anxious", LONG)],
    ids=["static-exhausted", "static-angry", "temporal-relief", "temporal-anxious-long"])
def test_agent_matches_jax(spev_path, hifigan, jax_noise, temporal, emotion, text):
    js, ts = _pair(spev_path, hifigan)
    ref = np.asarray(JaxAgent(None, synthesizer=js, temporal=temporal).synthesize(text, emotion))
    ours = EmbodiedAgent(None, synthesizer=ts, temporal=temporal, device="cpu").synthesize(
        text, emotion)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert np.abs(ours - ref).mean() < 1e-5
    assert np.isfinite(ours).all() and np.abs(ours).mean() > 1e-3
    if text == LONG:  # the segment is cut into spans of the largest bucket
        assert len(ts.g2p.phonemes(LONG.split("]")[1])) > ts.phoneme_buckets[-1]


def test_agent_orchestration(spev_path, hifigan):
    """Events, silences and speech in order (the speech within 1e-6: the
    frame bucket adapts between requests); an empty text is 100 zeros; an
    unknown event is 100 zeros and its silence."""
    _, ts = _pair(spev_path, hifigan)
    agent = EmbodiedAgent(None, synthesizer=ts, device="cpu")
    speech = agent._speech_segment("let us go", "neutral")
    n_ev = int(22050 * 1.2)  # the sigh
    out = agent.synthesize("[sigh] let us go", "neutral")
    assert len(out) == n_ev + 2205 + len(speech)
    assert not out[n_ev:n_ev + 2205].any()
    np.testing.assert_allclose(out[n_ev + 2205:], speech, atol=1e-6, rtol=0)
    assert len(agent.synthesize("[hmm]", "neutral")) == 100 + 2205
    np.testing.assert_array_equal(agent.synthesize("  ", "neutral"), np.zeros(100, np.float32))


@pytest.mark.parametrize("hidden,T", [(16, 12), (128, 7)])
def test_policy_matches_jax(hidden, T):
    params = jax.tree.map(np.asarray, init_policy_model(jax.random.PRNGKey(hidden), 50, hidden))
    ids = np.random.default_rng(T).integers(0, 50, size=(3, T))
    jax_modules.set_matmul_precision("highest")
    ref = apply_policy_model(params, ids)
    model = PolicyModel(50, hidden)
    model.load_state_dict(policy_state_dict_from_tree(params))
    with torch.no_grad():
        ours = model(torch.from_numpy(ids))
    for name, a, b in zip(("breath", "rough", "bright"), ours, ref):
        assert a.shape == (3, T)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("temporal", [False, True], ids=["embodied", "temporal"])
def test_cli_in_process(spev_path, tmp_path, capsys, temporal):
    main = cli.temporal_main if temporal else cli.main
    out = str(tmp_path / "e.wav")
    argv = ["--text", "hello [sigh] there", "--emotion", "exhausted", "--checkpoint", spev_path,
            "--hifigan_dir", str(tmp_path / "none"), "--device", "cpu", "--output", out]
    assert main(argv) == 0
    assert f"Output saved to {out}" in capsys.readouterr().out
    wav, sr = read_wav(out)
    assert sr == 22050 and len(wav) > int(22050 * (0.5 if temporal else 1.2)) + 2205
    bad = argv[:5] + [str(tmp_path / "missing.spev")] + argv[6:]
    assert main(bad) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and err.count("\n") == 1


@pytest.mark.parametrize("temporal", [False, True], ids=["embodied", "temporal"])
def test_flag_surfaces_are_jax_plus_device(temporal):
    def flags(p):
        return {s: a for a in p._actions for s in a.option_strings}

    ours, ref = flags(cli.build_parser(temporal)), flags(jax_cli._parser(temporal))
    assert set(ours) == set(ref) | {"--device"}
    for s, a in ref.items():
        assert (ours[s].default, ours[s].choices) == (a.default, a.choices), s
