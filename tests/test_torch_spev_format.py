""".spev checkpoints between the PyTorch port and the JAX package: the
port's msgpack encoder against ``msgpack.packb(x, use_bin_type=True)``
byte for byte; files written by ``spev_tpu.train.checkpoint`` (advanced +
nasality model, optax state) read by the port leaf for leaf; files written
by the port read by ``flax.serialization`` and ``spev_tpu``'s
``load_params``; chunked leaves; ``cli.convert`` against JAX's; and
``.spev`` accepted by the Synthesizer and ``cli.infer``."""

import msgpack
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from spev_tpu.cli.convert import main as jax_convert
from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.config import SpevConfig as JaxSpevConfig
from spev_tpu.train import checkpoint as jax_ckpt
from spev_tpu.train.trainer import init_train_state
from spev_tpu_torch.cli.convert import main as convert_main
from spev_tpu_torch.cli.infer import main as infer_main
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.train import checkpoint as ckpt
from spev_tpu_torch.utils import msgpack as mp
from spev_tpu_torch.utils.params import (fastspeech2_state_dict_from_tree,
                                         fastspeech2_tree_from_state_dict, read_checkpoint)

SMALL = dict(embed_dim=32, hidden_dim=32, n_mels=80, n_encoder_layers=2, n_decoder_layers=2)
ADV = dict(use_vad=True, use_nasality=True, n_speakers=3, vp_output_norm=False)
VOCAB = ["<PAD>", "<SIL>", "<UNK>"] + list("abdefhiklmnoprstuwzæðŋɑɔəɛɪʃʊʌ")

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
SCALARS = [None, True, False, 0.0, -0.0, 1.5, -2.25e300, float("inf"), "", "a" * 31,
           "a" * 32, "é" * 128, "x" * 65536, b"", b"ab", b"x" * 256, b"y" * 65536]
CONTAINERS = [[], [1, [2, "3"]], list(range(15)), list(range(16)), list(range(65536)), {},
              {"a": 1, "b": [None, 2.5]}, {str(i): i for i in range(15)},
              {str(i): i for i in range(16)}, {str(i): i for i in range(65536)}]


@pytest.mark.parametrize("x", INTS + SCALARS + CONTAINERS,
                         ids=lambda x: f"{type(x).__name__}-{len(x) if hasattr(x, '__len__') else x}")
def test_msgpack_bytes_match_the_package(x):
    packed = msgpack.packb(x, use_bin_type=True)
    assert mp.packb(x) == packed
    assert mp.unpackb(packed) == msgpack.unpackb(packed, raw=False)


def test_msgpack_float32_ext_and_errors():
    f32 = msgpack.packb(1.25, use_single_float=True)
    assert mp.unpackb(f32) == 1.25
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "i": np.int32(5),
            "s": np.float64(2.5), "e": np.zeros((0, 3)), "b": np.array(True), "c": 1 + 2j,
            "n": [np.ones(2, np.int64), {"y": 1, "x": 2}]}
    blob = serialization.msgpack_serialize(tree)
    assert mp.serialize(tree) == blob
    back = mp.restore(blob)
    for k in ("w", "e", "b"):
        assert back[k].dtype == tree[k].dtype and np.array_equal(back[k], tree[k])
    assert back["i"] == 5 and type(back["i"]) is np.int32 and back["c"] == 1 + 2j
    with pytest.raises(mp.MsgpackError):
        mp.unpackb(blob[:-3])
    with pytest.raises(mp.MsgpackError):
        mp.unpackb(blob + b"\x00")


def test_bfloat16_leaf_reads_as_a_torch_tensor():
    arr = np.asarray(jnp.asarray([0.5, -2.0, 3.0], jnp.bfloat16))
    back = mp.restore(serialization.msgpack_serialize({"x": arr}))["x"]
    assert back.dtype == torch.bfloat16 and back.tolist() == [0.5, -2.0, 3.0]
    again = serialization.msgpack_restore(mp.serialize({"x": back}))["x"]
    assert again.dtype == arr.dtype and np.array_equal(again, arr)


def test_chunked_leaf_is_reassembled(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    big = np.arange(50, dtype=np.float32).reshape(5, 10)
    blob = serialization.msgpack_serialize({"model": {"w": big, "v": np.ones(3)}})
    raw = msgpack.unpackb(blob, raw=False, ext_hook=lambda c, d: None)
    assert "__msgpack_chunked_array__" in raw["model"]["w"]  # flax did chunk it
    back = mp.restore(blob)["model"]
    assert back["w"].dtype == big.dtype and np.array_equal(back["w"], big)


def _jax_state(seed=0):
    jcfg = JaxModelConfig(vocab_size=len(VOCAB), **SMALL, **ADV)
    state = init_train_state(jax.random.PRNGKey(seed), JaxSpevConfig(model=jcfg))
    params = jax.tree.map(np.asarray, state.params)
    rng = np.random.default_rng(seed)
    params["advanced"]["vad_proj"]["weight"] = rng.normal(size=(32, 3)).astype(np.float32)
    return jcfg, params, state.opt_state


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(b) is type(a) and b.dtype == a.dtype, path
        assert np.array_equal(a, b), path
    else:
        assert a == b and type(a) is type(b), path


def test_jax_resumable_spev_reads_leaf_for_leaf(tmp_path):
    jcfg, params, opt_state = _jax_state()
    path = str(tmp_path / "last.spev")
    jax_ckpt.save_checkpoint(path, params, opt_state=opt_state, step=12, epoch=3, vocab=VOCAB,
                             stats={"p_mean": 1.5, "frames_per_phoneme": 6.0},
                             model_config=jax_ckpt.model_config_dict(jcfg))
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got = ckpt.load_spev(path)
    _leaves_equal(ref, got)
    assert got["optimizer"] is not None and got["meta"] == ref["meta"]
    tree, vocab, stats = ckpt.load_params(path)
    jtree, jvocab, jstats = jax_ckpt.load_params(path)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), jtree, tree)
    assert (vocab, stats) == (jvocab, jstats)
    assert ckpt.load_model_config(path) == jax_ckpt.load_model_config(path)
    # read_checkpoint: the .pt-shaped dict the Synthesizer consumes
    rc = read_checkpoint(path)
    assert (rc["step_num"], rc["epoch"], rc["vocab"]) == (12, 3, VOCAB)
    assert rc["model_config"]["use_vad"] and rc["model_config"]["n_speakers"] == 3
    model = FastSpeech2(ModelConfig.from_dict({**rc["model_config"], "vocab_size": len(VOCAB)}))
    model.load_state_dict(rc["model"])  # strict: advanced.* and nasal_* all land


def test_port_spev_reads_back_in_jax(tmp_path):
    jcfg, params, _ = _jax_state(seed=1)
    sd = fastspeech2_state_dict_from_tree(params)
    assert {"advanced.vad_proj.weight", "advanced.speaker_embedding.weight",
            "nasal_predictor.proj.weight", "nasal_embedding.weight"} <= set(sd)
    model = FastSpeech2(ModelConfig(vocab_size=len(VOCAB), **SMALL, **ADV))
    model.load_state_dict(sd)
    path = str(tmp_path / "port.spev")
    meta = dict(vocab=VOCAB, stats={"p_mean": 0.5}, step=7, epoch=2,
                model_config=ckpt.model_config_dict(model.cfg))
    ckpt.save_spev(path, model.state_dict(), **meta)
    with open(path, "rb") as f:
        blob = f.read()
    raw = serialization.msgpack_restore(blob)
    assert raw["optimizer"] is None and raw["meta"]["step_num"] == 7
    jtree, vocab, stats = jax_ckpt.load_params(path)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), params, jtree)
    assert jax.tree.structure(jtree) == jax.tree.structure(params)
    assert (vocab, stats) == (VOCAB, {"p_mean": 0.5})
    assert JaxModelConfig(**jax_ckpt.load_model_config(path)) == jcfg
    # the same payload from JAX's writer is the same bytes
    ref = str(tmp_path / "jax.spev")
    jax_ckpt.save_checkpoint(ref, params, step=7, epoch=2, vocab=VOCAB,
                             stats={"p_mean": 0.5}, model_config=meta["model_config"])
    with open(ref, "rb") as f:
        assert f.read() == blob
    # the state dict survives the tree round trip exactly
    again = fastspeech2_state_dict_from_tree(fastspeech2_tree_from_state_dict(sd))
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def test_corrupt_spev_is_a_user_error(tmp_path):
    bad = tmp_path / "bad.spev"
    bad.write_bytes(b"\x93\x01")
    with pytest.raises(UserError, match="not a .spev"):
        ckpt.load_spev(str(bad))
    other = tmp_path / "other.spev"
    other.write_bytes(mp.packb({"x": 1}))
    with pytest.raises(UserError, match="no 'model'"):
        read_checkpoint(str(other))


def test_trainer_refuses_to_resume_from_spev(tmp_path):
    """The Trainer resumes from a .spev: one without optimizer state loads
    its weights and restarts the optimizer with a warning; it refuses one
    whose optimizer tree is not the JAX package's AdamW chain."""
    from spev_tpu_torch.config import SpevConfig
    from spev_tpu_torch.train.trainer import Trainer

    model = FastSpeech2.random_init(ModelConfig(vocab_size=len(VOCAB), **SMALL))
    path = str(tmp_path / "m.spev")
    ckpt.save_spev(path, model.state_dict(), vocab=VOCAB, stats={}, step=3, epoch=1)
    trainer = Trainer(SpevConfig(model=model.cfg), VOCAB, {}, ckpt_dir=str(tmp_path / "c"),
                      log_dir=str(tmp_path / "l"), device="cpu")
    with pytest.warns(UserWarning, match="no optimizer state"):
        trainer.restore(path)
    assert (trainer.step, trainer.epoch) == (3, 1) and not trainer.optimizer.state
    for k, v in model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k
    bad = str(tmp_path / "bad.spev")
    ckpt.save_spev(bad, model.state_dict(), vocab=VOCAB, stats={}, optimizer={"0": {}})
    with pytest.raises(UserError, match="not that of the JAX package's AdamW chain"):
        trainer.restore(bad)


def _reference_pt(tmp_path):
    """A reference-schema .pt (4+4 blocks: JAX's importer assumes the
    reference depth) written by JAX's exporter."""
    jcfg = JaxModelConfig(vocab_size=len(VOCAB), embed_dim=32, hidden_dim=32, n_mels=80)
    params = jax.tree.map(np.asarray, init_train_state(
        jax.random.PRNGKey(3), JaxSpevConfig(model=jcfg)).params)
    params["duration_predictor"]["output_norm"]["bias"] = np.asarray([np.log(7.0)], np.float32)
    path = str(tmp_path / "ref.pt")
    jax_ckpt.export_reference_checkpoint(path, params, VOCAB, {"p_mean": 0.25}, step=5, epoch=1)
    return path


def _stdout(capsys, fn, argv):
    capsys.readouterr()
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_convert_matches_jax(tmp_path, capsys):
    pt = _reference_pt(tmp_path)
    rc, out, _ = _stdout(capsys, convert_main, ["to-spev", pt, str(tmp_path / "port.spev")])
    assert rc == 0
    jax_convert(["to-spev", pt, str(tmp_path / "jax.spev")])
    port_tree = ckpt.load_spev(str(tmp_path / "port.spev"))
    jax_tree = ckpt.load_spev(str(tmp_path / "jax.spev"))
    _leaves_equal(jax_tree, port_tree)
    assert (tmp_path / "port.spev").read_bytes() == (tmp_path / "jax.spev").read_bytes()
    # info: the same five lines for the .pt and the .spev
    for src in (pt, str(tmp_path / "jax.spev")):
        rc, out, _ = _stdout(capsys, convert_main, ["info", src])
        _, jout, _ = _stdout(capsys, jax_convert, ["info", src])
        assert rc == 0 and out == jout and len(out.splitlines()) == 5
    # to-pt: the reference key set, loadable by JAX's importer to equal params
    for name, fn in (("port.pt", convert_main), ("jax.pt", jax_convert)):
        fn(["to-pt", str(tmp_path / "jax.spev"), str(tmp_path / name)])
    port_pt = torch.load(tmp_path / "port.pt", weights_only=True)
    jax_pt = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert set(port_pt) == set(jax_pt) and set(port_pt["model"]) == set(jax_pt["model"])
    jp = jax_ckpt.import_reference_checkpoint(str(tmp_path / "port.pt"))
    jj = jax_ckpt.import_reference_checkpoint(str(tmp_path / "jax.pt"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), jj[0], jp[0])
    assert jp[1:] == jj[1:]


def test_convert_to_pt_names_what_it_drops(tmp_path, capsys):
    jcfg, params, _ = _jax_state()
    src = str(tmp_path / "adv.spev")
    jax_ckpt.save_checkpoint(src, params, vocab=VOCAB, stats={})
    rc, _, err = _stdout(capsys, convert_main, ["to-pt", src, str(tmp_path / "adv.pt")])
    assert rc == 0
    assert err.count("\n") == 1 and "advanced" in err and "nasal_predictor" in err
    sd = torch.load(tmp_path / "adv.pt", weights_only=True)["model"]
    assert not any(k.startswith(("advanced.", "nasal_")) for k in sd)
    rc, _, err = _stdout(capsys, convert_main, ["cache", "a", "b"])
    assert rc == 2 and "not found: a" in err and err.startswith("error:")
    rc, _, err = _stdout(capsys, convert_main, ["info", str(tmp_path / "missing.spev")])
    assert rc == 2 and err.startswith("error:")


def test_synthesizer_and_cli_accept_spev(tmp_path, capsys):
    pt = _reference_pt(tmp_path)
    spev = str(tmp_path / "m.spev")
    assert convert_main(["to-spev", pt, spev]) == 0
    kw = dict(g2p_backend="rules", device="cpu", phoneme_buckets=(64,), frame_buckets=(256, 512))
    m_pt = Synthesizer(pt, model_cfg=ModelConfig(embed_dim=32, hidden_dim=32), **kw)
    m_spev = Synthesizer(spev, model_cfg=ModelConfig(embed_dim=32, hidden_dim=32), **kw)
    assert not m_spev.has_advanced
    w1, mel1 = m_pt.synthesize("hello there")
    w2, mel2 = m_spev.synthesize("hello there")
    assert np.array_equal(mel1, mel2) and np.array_equal(w1, w2)
    # the stored config of a port-written .spev rebuilds the architecture
    model = FastSpeech2.random_init(ModelConfig(vocab_size=len(VOCAB), **SMALL), seed=2)
    with torch.no_grad():
        model.duration_predictor.output_norm.bias.fill_(np.log(7.0))
    path = str(tmp_path / "small.spev")
    ckpt.save_spev(path, model.state_dict(), vocab=VOCAB, stats={},
                   model_config=ckpt.model_config_dict(model.cfg))
    assert Synthesizer(path, **kw).model_cfg == model.cfg
    out = str(tmp_path / "o.wav")
    rc, stdout, _ = _stdout(capsys, infer_main, ["--checkpoint", path, "--text", "hi",
                                                  "--hifigan_dir", str(tmp_path / "none"),
                                                  "--device", "cpu", "--output", out])
    assert rc == 0 and "wrote" in stdout
