"""The port's data parallelism (``spev_tpu_torch.parallel``) on the CPU.

- `make_mesh`'s errors (an indivisible model axis, a model axis without a
  process group), `rows_of`, and the `Trainer` without a process group
  (one rank of a one-position data axis).
- `Synthesizer(mesh=...)` over two CPU entries against the unsharded
  `synthesize_many` (waveform MAE < 1e-5, equal lengths).
- A two-process gloo run through `multiproc.spawn_ranks` (one spawn for the
  module, a timeout of its own): each rank takes half of a global batch
  whose rows hold different valid lengths.  The acoustic loss and every
  gradient equal the port's one-process values on the whole batch within
  1e-6 relative (with ``grad_accum=2``, on the batch whose micro-batches
  are the ranks' halves' halves), and JAX's ``_loss_fn`` and gradients on
  the whole batch within 1e-5 of each gradient's max |g| (dropout off); the
  validation mel L1 equals the one-process one.  One fused
  `VocoderTrainStep`: losses against the one-process step within 1e-6
  relative and the applied D and G gradients within `VOC_GRAD_REL` of
  their max |g|; the losses of ``d_step``/``g_step`` within 1e-5 relative
  of JAX's on the whole crop batch, and their gradients within
  `VOC_JAX_GRAD_REL` of JAX's, both evaluated in float64.
- `dryrun_multiprocess(2)`: JAX's data×model mesh, (1, 2), ok, with equal
  losses.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spev_tpu.config import ModelConfig as JModelConfig
from spev_tpu.config import SpevConfig as JSpevConfig
from spev_tpu.config import AudioConfig as JAudioConfig
from spev_tpu.config import TrainConfig as JTrainConfig
from spev_tpu.models import modules as jax_modules
from spev_tpu.models.fastspeech2 import init_fastspeech2
from spev_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from spev_tpu.train import vocoder_trainer as jvt
from spev_tpu.train.trainer import _loss_fn
from spev_tpu.utils.torch_loader import fastspeech2_params_from_state_dict
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.hifigan import HiFiGANGenerator
from spev_tpu_torch.parallel import distributed
from spev_tpu_torch.parallel.mesh import make_mesh, rows_of
from spev_tpu_torch.parallel.multiproc import dryrun_multiprocess, spawn_ranks
from spev_tpu_torch.parallel.tensor_parallel import check_model_axis
from spev_tpu_torch.train import vocoder_trainer as vt
from spev_tpu_torch.train.trainer import Trainer
from spev_tpu_torch.utils.params import state_dict_from_tree, tree_from_state_dict

from _torch_dp_cases import (H, MODEL, P, VOCAB, acoustic_batch, acoustic_cfg, voc_batch,
                             voc_cfg, vocoder_run)

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT_S = 240
# A conv weight gradient sums over rows and time; over two half batches the
# sum runs in another order, and in the discriminators, whose real and fake
# terms cancel, that moves it by a few 1e-6 of its max |g| (3.5e-6 for D and
# 2.4e-6 for G seen), above the acoustic step's 1e-6.
VOC_GRAD_REL = 1e-5
# Against JAX's gradients evaluated in float64 (its float32 CPU gradients of
# the MSD's grouped convolutions stray 5.0e-3 of max |g| from that
# evaluation, the port's two ranks 3.5e-6; the test prints both).  D's bar
# is the acoustic step's 1e-5 of max |g|.  G's float32 error, from the
# generator and the mel L1's |.|, reaches 1.2e-5 of max |g|, so its bar is
# 2e-5.
VOC_JAX_GRAD_REL = {"d": 1e-5, "g": 2e-5}


# -- meshes ---------------------------------------------------------------------


def test_make_mesh_errors():
    with pytest.raises(ValueError, match=r"mesh shape \(3,\) needs 3 devices, have 2"):
        make_mesh((3,), devices=["cpu", "cpu"])
    with pytest.raises(UserError, match="must divide n_heads 3"):
        check_model_axis(ModelConfig(n_heads=3), 2)
    with pytest.raises(UserError, match="process group"):
        make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 1), ("data",), devices=["cpu"] * 2)
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    assert mesh.shape == {"data": 2, "model": 1} and mesh.data_size == 2
    assert mesh.group is None and mesh.data_index == 0
    with pytest.raises(ValueError, match="does not split"):
        rows_of({"x": torch.zeros(3)}, 0, 2)
    batch = {"x": torch.arange(4), "y": np.arange(8).reshape(4, 2)}
    assert [rows_of(batch, i, 2)["x"].tolist() for i in range(2)] == [[0, 1], [2, 3]]
    assert rows_of(batch, 1, 2)["y"].tolist() == [[4, 5], [6, 7]]


def test_no_process_group_without_coordinates(monkeypatch):
    for k in ("SPEV_COORDINATOR", "SPEV_NUM_PROCESSES", "SPEV_PROCESS_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    monkeypatch.setenv("SPEV_NUM_PROCESSES", "2")
    with pytest.raises(UserError, match="torch.distributed.run"):
        distributed.initialize(device="cpu")


def test_trainer_without_a_process_group_is_one_rank(tmp_path):
    tr = Trainer(acoustic_cfg(), VOCAB, {}, ckpt_dir=str(tmp_path / "c"),
                 log_dir=str(tmp_path / "l"), device="cpu")
    assert tr.mesh.shape == {"data": 1} and tr.group is None and tr.is_main
    assert tr.mesh.local_device == torch.device("cpu")
    batch = acoustic_batch()
    assert tr.local_rows(batch) is batch


def _path_str(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


# -- serving over a mesh ---------------------------------------------------------


def test_synthesizer_mesh_matches_one_device():
    from spev_tpu.text.lexicon import LEXICON
    from spev_tpu.text.vocab import Vocab as JaxVocab

    small = dict(embed_dim=H, hidden_dim=H, n_mels=80, n_encoder_layers=1, n_decoder_layers=1)
    vocab = JaxVocab.build(set("".join(LEXICON.values())))
    params = init_fastspeech2(jax.random.PRNGKey(0), JModelConfig(vocab_size=len(vocab), **small))
    params["duration_predictor"]["output_norm"]["bias"] = jnp.asarray([np.log(7.0)])
    ckpt = (jax.tree.map(np.asarray, params), vocab.symbols, {})
    kw = dict(model_cfg=ModelConfig(**small), g2p_backend="rules", phoneme_buckets=(64,),
              frame_buckets=(128, 256, 512))
    gen = HiFiGANGenerator.random_init(voc_cfg(), seed=1)
    one = Synthesizer(ckpt, device="cpu", **kw)
    one.vocoder = Vocoder(generator=gen, device="cpu")
    two = Synthesizer(ckpt, mesh=make_mesh((2,), devices=["cpu", "cpu"]), **kw)
    two.vocoder = Vocoder(generator=gen, device="cpu")
    assert two._replicas[1] is not two.model
    texts = ["hi there", "we need to find a new way home", "mid length one", "bye",
             "a b c d", "one more", "the last one", "eight"]
    ctl = dict(pitch_scale=np.linspace(0.9, 1.2, 8), breathiness=0.2)
    rows1 = one.synthesize_many(texts, batch_size=4, **ctl)
    rows2 = two.synthesize_many(texts, batch_size=4, **ctl)
    assert two._voc_replicas[1][1] is not gen
    for (w1, m1), (w2, m2) in zip(rows1, rows2):
        assert w1.shape == w2.shape and m1.shape == m2.shape
        assert np.abs(w1 - w2).mean() < 1e-5
        np.testing.assert_allclose(m2, m1, atol=1e-5)
    with pytest.raises(ValueError, match="does not split"):
        two.synthesize_many(texts[:3], batch_size=3)


# -- two processes --------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_run():
    """Two gloo ranks of `tests/_torch_dp_worker.py`: rank 0's results (rank
    1's must agree bit for bit)."""
    with tempfile.TemporaryDirectory() as out:
        spawn_ranks(2, "_torch_dp_worker:main", (out,), timeout_s=SPAWN_TIMEOUT_S, path=(HERE,))
        res = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    return res[0]


def _one_process(tmp_path, batch, accum=1):
    tr = Trainer(acoustic_cfg(grad_accum=accum), VOCAB, {}, ckpt_dir=str(tmp_path / "c"),
                 log_dir=str(tmp_path / "l"), device="cpu")
    loss, metrics, grads = tr.global_gradients(tr.to_device(batch))
    return tr, loss, metrics, grads


def _close(ours, ref, rel, what):
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(np.asarray(ours, np.float64) - ref)))
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("prefix,accum", [("acoustic", 1), ("accum", 2)])
def test_dp_acoustic_step_matches_one_process(dp_run, tmp_path, prefix, accum):
    batch = acoustic_batch()
    if accum == 2:
        # micro-batch i of the two ranks: rows 2i..2i+1 of each half
        batch = {k: v[[0, 1, 4, 5, 2, 3, 6, 7]] for k, v in batch.items()}
    tr, loss, metrics, grads = _one_process(tmp_path, batch, accum)
    _close(dp_run[f"{prefix}_loss"], float(loss.detach()), 1e-6, "loss")
    for k, v in metrics.items():
        _close(dp_run[f"{prefix}_m_{k}"], float(v.detach()), 1e-6, k)
    for (name, _), g in zip(tr.model.named_parameters(), grads):
        _close(dp_run[f"{prefix}_g_{name}"], g.numpy(), 1e-6, name)


def test_dp_validation_matches_one_process(dp_run, tmp_path):
    tr = Trainer(acoustic_cfg(), VOCAB, {}, ckpt_dir=str(tmp_path / "c"),
                 log_dir=str(tmp_path / "l"), device="cpu")
    _close(dp_run["val_mel"], tr.validate([acoustic_batch()]), 1e-6, "val_mel")


def test_dp_acoustic_step_matches_jax(dp_run, tmp_path):
    tr = Trainer(acoustic_cfg(), VOCAB, {}, ckpt_dir=str(tmp_path / "c"),
                 log_dir=str(tmp_path / "l"), device="cpu")
    sd = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    params = fastspeech2_params_from_state_dict(sd)
    jcfg = JSpevConfig(model=JModelConfig(**{k: v for k, v in MODEL.items()}, max_phonemes=P),
                       train=JTrainConfig(batch_size=8, warmup_steps=10,
                                          matmul_precision="highest"))
    jax_modules.set_matmul_precision("highest")
    batch = jax.tree.map(jnp.asarray, acoustic_batch())
    (jl, _), jg = jax.value_and_grad(_loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jcfg, batch, None, 1.0)
    _close(dp_run["acoustic_loss"], float(jl), 1e-5, "loss")
    ours = fastspeech2_params_from_state_dict(
        {name: dp_run[f"acoustic_g_{name}"] for name, _ in tr.model.named_parameters()})
    ref = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree.leaves(ours)
    assert len(ref) == len(got)
    for (path, r), g in zip(ref, got):
        _close(g, np.asarray(r, np.float64), 1e-5, _path_str(path))


def test_dp_vocoder_step_matches_one_process(dp_run):
    ref = vocoder_run(vt, vt.VocoderTrainStep(voc_cfg(), fused=True))
    assert ref["m_skipped"] == 0.0
    losses = ("m_", "s_")
    grads = sorted(k for k in ref if not k.startswith(losses))
    assert grads[0] == "d_0" and grads[-1].startswith("g_")
    worst = {}
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        err = float(np.max(np.abs(dp_run[f"voc_{k}"] - r)) / max(np.max(np.abs(r)), 1e-30))
        worst[k[0]] = max(worst.get(k[0], 0.0), err)
        _close(dp_run[f"voc_{k}"], ref[k], 1e-6 if k.startswith(losses) else VOC_GRAD_REL, k)
    print("worst relative gap by kind (fused losses m, split losses s, D d, G g):", worst)


def _grad_catcher(*_, **__):
    """An optax transformation that applies no update and keeps the
    gradients as its state: JAX's ``d_step``/``g_step`` then hand back the
    gradients they computed."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_dp_vocoder_step_matches_jax(dp_run, monkeypatch):
    cfg = voc_cfg()
    jcfg = JHiFiGANConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(JHiFiGANConfig)})
    st = vt.init_vocoder_train_state(cfg, periods=(2,), n_scales=1, device="cpu")
    gen, disc = (tree_from_state_dict(m.state_dict())
                 for m in (st.generator, st.discriminators))
    mel, wav = (t.numpy() for t in voc_batch())

    # JAX's d_step and g_step, each from the initial state; the optimizer
    # keeps their gradients in place of updates
    monkeypatch.setattr(jvt, "make_vocoder_optimizer", _grad_catcher)
    zero = jnp.zeros((), jnp.int32)
    d32 = jvt.make_vocoder_train_step(jcfg, JAudioConfig(), periods=(2,)).d_step(
        jvt.VocoderTrainState(gen, disc, {}, _grad_catcher().init(disc), zero),
        jnp.asarray(mel), jnp.asarray(wav))[0].disc_opt  # float32: printed only
    with jax.enable_x64():  # the reference: losses and gradients in float64
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

        def state():
            g, d = f64(gen), f64(disc)
            return jvt.VocoderTrainState(g, d, _grad_catcher().init(g), _grad_catcher().init(d),
                                         jnp.zeros((), jnp.int32))

        step = jvt.make_vocoder_train_step(jcfg, JAudioConfig(), periods=(2,))
        d_state, d_loss, _ = step.d_step(state(), f64(mel), f64(wav))
        g_state, g_loss, aux, _ = step.g_step(state(), f64(mel), f64(wav))
        d_grads, g_grads = d_state.disc_opt, g_state.gen_opt
        to_np = lambda tree: state_dict_from_tree(jax.tree.map(np.asarray, tree))
        refs = {"d": to_np(d_grads), "g": to_np(g_grads)}
    for k, v in {"d_loss": d_loss, "g_loss": g_loss, **aux}.items():
        _close(dp_run[f"voc_s_{k}"], float(v), 1e-5, k)
    jax32 = to_np(d32)
    worst = {"jax_d_float32": max(
        float(np.max(np.abs(jax32[n].numpy() - r.numpy())) / np.max(np.abs(r.numpy())))
        for n, r in refs["d"].items())}
    for which, net in (("d", st.discriminators), ("g", st.generator)):
        for i, (name, _) in enumerate(net.named_parameters()):
            r = refs[which][name].numpy().astype(np.float64)
            got = dp_run[f"voc_{which}_{i}"]
            assert got.shape == r.shape, name
            err = float(np.max(np.abs(got - r)) / max(np.max(np.abs(r)), 1e-30))
            worst[which] = max(worst.get(which, 0.0), err)
            _close(got, r, VOC_JAX_GRAD_REL[which], f"{which}: {name}")
    print("worst gap to JAX's float64 gradients (the port's D d and G g; JAX's own float32 D):",
          worst)


def test_dryrun_multiprocess(tmp_path):
    res = dryrun_multiprocess(2, out_json=str(tmp_path / "mp.json"), timeout_s=SPAWN_TIMEOUT_S)
    assert res["ok"] and res["mesh"] == {"data": 1, "model": 2} and res["step"] == 1
    assert res["losses"][0] == res["losses"][1] == res["loss"] and np.isfinite(res["loss"])
    assert (tmp_path / "mp.json").exists()
