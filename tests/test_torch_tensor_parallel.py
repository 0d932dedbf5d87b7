"""The port's 'model' mesh axis (Megatron tensor parallelism of the FFT
blocks, ``spev_tpu_torch.parallel.tensor_parallel``) on the CPU.

One module-scope spawn of ``tests/_torch_dp_worker.py:tp_main`` on four gloo
ranks through `multiproc.spawn_ranks`, a (2, 2) data×model mesh:
- every rank sits at data index r // 2 and model index r % 2;
- each rank's shards of the base and the advanced model have the shapes of
  JAX's shards under ``param_shardings`` on ``make_mesh((4, 2), ("data",
  "model"))`` (the conftest's 8 virtual devices), leaf by leaf;
- one FFT block with dropout 0.1, forward and backward over a model group,
  equals the unsharded block with the same generator within 1e-6 (the
  output, the input's gradient, and each gathered parameter gradient within
  1e-6 of its max |g|): the masks are equal;
- one train step (dropout off) equals JAX's ``make_train_step`` on the
  (4, 2) mesh: loss within 1e-6 relative, the gathered gradients within
  1e-5 of each tensor's max |g| of JAX's (``_loss_fn`` on the whole batch),
  the gathered updated parameters within 1e-5 (absolute; the first update
  moves a weight by lr/10 = 1e-4) wherever JAX's gradient is above
  `GRAD_FLOOR` of its tensor's max |g|.
  AdamW's first update is ``lr·g/(|g| + eps)``, about ``±lr`` whatever
  |g|, so a gradient that is zero but for rounding (the attention's key
  bias: softmax ignores a constant added to a row's scores) moves a
  weight by up to lr either way in either package; there the two updates
  are held to lr each.
- ``save`` writes the reference layout, which a one-process `Trainer`
  restores bit for bit, and a tensor-parallel Trainer restored from it
  takes the same next step as the one that saved it.
- a Trainer whose 3 heads the model axis does not divide raises
  `UserError` on every rank;
- with ``remat`` (``'full'`` and ``'dots'``) and dropout 0.1 a step's loss
  equals the step's without remat, its gathered gradients lie within 1e-6
  of each max |g|, and the dropout generator ends in the same state;
- ``cli.train --model_axis 2`` trains ten epochs on the mesh: rank 0
  prints the epochs and the probes (run by its model group), the other
  ranks print none of them, ``last``, ``best`` and ``ckpt_10`` are
  written, and a one-process `Synthesizer` serves ``ckpt_10.pt``.
In process: a model axis without a process group raises `UserError`; the
block without a group is the unsharded one.
"""

import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from spev_tpu.config import ModelConfig as JModelConfig
from spev_tpu.config import SpevConfig as JSpevConfig
from spev_tpu.config import TrainConfig as JTrainConfig
from spev_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spev_tpu.parallel.mesh import param_shardings, shard_batch
from spev_tpu.models import modules as jax_modules
from spev_tpu.train.trainer import (TrainState, _loss_fn, init_train_state, make_optimizer,
                                    make_train_step)
from spev_tpu.utils.torch_loader import fastspeech2_params_from_state_dict
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.parallel.multiproc import spawn_ranks
from spev_tpu_torch.train.trainer import Trainer
from spev_tpu_torch.utils.params import (fastspeech2_state_dict_from_tree,
                                         fastspeech2_tree_from_state_dict)

from _torch_dp_cases import (ADV_MODEL, MODEL, P, VOCAB, acoustic_batch, acoustic_cfg,
                             block_input)

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT_S = 240
RANKS = 4
TP = dict(mesh_shape=(2, 2), mesh_axes=("data", "model"))
# ten times the gradient bar: above it the two gradients share a sign
GRAD_FLOOR = 1e-4


@pytest.fixture(scope="module")
def tp_run():
    """The four ranks' results and the directory holding rank 0's
    checkpoint."""
    out = tempfile.TemporaryDirectory()
    spawn_ranks(RANKS, "_torch_dp_worker:tp_main", (out.name,), timeout_s=SPAWN_TIMEOUT_S,
                path=(HERE,))
    res = [dict(np.load(os.path.join(out.name, f"rank{r}.npz"))) for r in range(RANKS)]
    yield res, out.name
    out.cleanup()


def _close(ours, ref, rel, what):
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(np.asarray(ours, np.float64) - ref)))
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"
    return err / scale


def _path_str(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def test_ranks_sit_model_axis_innermost(tp_run):
    res, _ = tp_run
    assert [r["coords"].tolist() for r in res] == [[0, 0, 2, 2], [0, 1, 2, 2], [1, 0, 2, 2],
                                                   [1, 1, 2, 2]]
    for k in res[0]:
        if k.startswith(("step_", "resume_", "shape_")):
            for r in res[1:]:
                np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


@pytest.mark.parametrize("kind", ["base", "adv"])
def test_shard_shapes_match_jax(tp_run, kind):
    res, _ = tp_run
    model = ADV_MODEL if kind == "adv" else MODEL
    jcfg = JSpevConfig(model=JModelConfig(**model, max_phonemes=P))
    params = init_train_state(jax.random.PRNGKey(0), jcfg).params
    mesh = jax_make_mesh((4, 2), ("data", "model"))
    shardings = param_shardings(mesh, params)
    ref = {_path_str(p): s.shard_shape(leaf.shape) for (p, leaf), s in
           zip(jax.tree_util.tree_leaves_with_path(params), jax.tree.leaves(shardings))}
    for r in res:
        shapes = {k[len(f"shape_{kind}_"):]: np.zeros(tuple(v), np.float32)
                  for k, v in r.items() if k.startswith(f"shape_{kind}_")}
        ours = jax.tree_util.tree_leaves_with_path(fastspeech2_tree_from_state_dict(shapes))
        got = {_path_str(p): leaf.shape for p, leaf in ours}
        assert got == ref
    full = {_path_str(p): leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(params)}
    cut = [k for k in ref if ref[k] != full[k]]
    assert len(cut) == 6 * 8 and all(k.startswith(("encoder_blocks.", "decoder_blocks."))
                                      for k in cut)


def test_fft_block_matches_unsharded(tp_run):
    res, _ = tp_run
    cfg = ModelConfig(**{**MODEL, "dropout": 0.1})
    block = FastSpeech2.random_init(cfg, seed=3).encoder_blocks[0].train()
    x, mask, w = block_input()
    x.requires_grad_(True)
    y = block(x, mask, torch.Generator().manual_seed(7))
    grads = torch.autograd.grad((y * w).sum(), [x] + list(block.parameters()))
    for r in res:
        np.testing.assert_allclose(r["block_y"], y.detach().numpy(), atol=1e-6, rtol=0)
        _close(r["block_gx"], grads[0].numpy(), 1e-6, "input")
        for (name, _), g in zip(block.named_parameters(), grads[1:]):
            _close(r[f"block_g_encoder_blocks.0.{name}"], g.numpy(), 1e-6, name)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's train step on the (4, 2) mesh from the port's initial weights:
    (loss, updated parameters as a port state dict)."""
    jcfg = JSpevConfig(model=JModelConfig(**MODEL, max_phonemes=P),
                       train=JTrainConfig(batch_size=8, warmup_steps=10,
                                          matmul_precision="highest", **TP))
    full = FastSpeech2.random_init(ModelConfig(**MODEL), seed=0)
    params = jax.tree.map(jax.numpy.asarray, fastspeech2_params_from_state_dict(
        {k: v.numpy() for k, v in full.state_dict().items()}))
    state = TrainState(params, make_optimizer(jcfg).init(params),
                       jax.numpy.zeros((), jax.numpy.int32))
    mesh = jax_make_mesh((4, 2), ("data", "model"))
    step = make_train_step(jcfg, mesh, params, use_dropout=False)  # sets "highest"
    jax_modules.set_matmul_precision("highest")
    (_, _), grads = jax.value_and_grad(_loss_fn, has_aux=True)(
        params, jcfg, jax.tree.map(jax.numpy.asarray, acoustic_batch()), None, 1.0)
    state, metrics = step(state, shard_batch(mesh, acoustic_batch()), jax.random.PRNGKey(0))
    as_sd = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                          fastspeech2_state_dict_from_tree(jax.tree.map(np.asarray, tree)).items()}
    return (float(metrics["loss"]), float(metrics["skipped"]), as_sd(grads),
            as_sd(state.params), {k: v.numpy() for k, v in full.state_dict().items()})


def test_train_step_matches_jax_mesh(tp_run, jax_step):
    res, _ = tp_run
    loss, skipped, grads, params, before = jax_step
    r = res[0]
    assert skipped == 0.0 and float(r["step_skipped"]) == 0.0
    assert abs(float(r["step_loss"]) - loss) <= 1e-6 * abs(loss)
    lr = 1e-3 / 10  # the first update's warmup
    worst_g = worst_p = 0.0
    floored = 0
    for name, p in params.items():
        g = grads[name]
        worst_g = max(worst_g, _close(r[f"step_g_{name}"], g, 1e-5, f"gradient {name}"))
        real = np.abs(g) > GRAD_FLOOR * np.abs(g).max()
        ours = r[f"step_p_{name}"]
        gap = float(np.max(np.abs(ours[real] - p[real]), initial=0.0))
        assert gap <= 1e-5, f"{name}: updated parameters {gap:.3e} apart"
        worst_p = max(worst_p, gap)
        moved = np.abs(np.stack([ours[~real], p[~real]]) - before[name][~real])
        assert np.all(moved <= 1.01 * lr), name
        floored += int((~real).sum())
    print(f"worst gap to JAX: gradients {worst_g:.3e} of max |g|, updated parameters "
          f"{worst_p:.3e}; {floored} weights with rounding-noise gradients")


def test_save_restores_in_one_process_and_resumes(tp_run, tmp_path):
    res, out = tp_run
    r = res[0]
    one = Trainer(acoustic_cfg(), VOCAB, {}, ckpt_dir=str(tmp_path), log_dir=str(tmp_path),
                  device="cpu")
    for path in ("last.spev", "last.pt"):
        one.restore(os.path.join(out, "ckpt", path))
        assert one.step == 1
        for name, t in one.model.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), r[f"step_p_{name}"], err_msg=name)
    assert r["resume_step"].tolist() == [2, 2]
    assert r["resume_loss"][0] == r["resume_loss"][1]
    for k in r:
        if k.startswith("resume_p_"):
            np.testing.assert_array_equal(r[k], res[1][k], err_msg=k)


def test_indivisible_or_groupless_model_axis_raises(tp_run, tmp_path):
    res, _ = tp_run
    for r in res:
        assert "must divide n_heads 3" in str(r["three_heads_error"])
    with pytest.raises(UserError, match="torch.distributed.run"):
        Trainer(acoustic_cfg(**TP), VOCAB, {}, ckpt_dir=str(tmp_path), log_dir=str(tmp_path),
                device="cpu")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_on_the_model_axis_equals_no_remat(tp_run, policy):
    res, _ = tp_run
    for r in res:
        assert float(r[f"remat_{policy}_loss"]) == float(r["remat_none_loss"])
        np.testing.assert_array_equal(r[f"remat_{policy}_gen"], r["remat_none_gen"])
        names = [k[len("remat_none_g_"):] for k in r if k.startswith("remat_none_g_")]
        assert len(names) > 50
        for name in names:
            _close(r[f"remat_{policy}_g_{name}"], r[f"remat_none_g_{name}"], 1e-6, name)


def test_cli_train_on_a_model_axis_saves_and_probes(tp_run):
    res, out = tp_run
    assert [int(r["cli_rc"]) for r in res] == [0] * RANKS
    printed = [str(r["cli_printed"]) for r in res]
    assert "Data-parallel over 2 rank(s), model axis 2" in printed[0]
    assert "Epoch 10:" in printed[0] and "Probe 3:" in printed[0]
    assert "failed" not in printed[0]
    for p in printed[1:]:
        assert "Epoch" not in p and "Probe" not in p
    ck = os.path.join(out, "cli", "checkpoints", "tp")
    for name in ("last", "best", "ckpt_10"):
        for ext in (".spev", ".pt"):
            assert os.path.exists(os.path.join(ck, name + ext)), name + ext
    with open(os.path.join(out, "cli", "logs", "tp", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 10 and all(np.isfinite(r["train_loss"]) for r in rows)
    synth = Synthesizer(os.path.join(ck, "ckpt_10.pt"), hifigan_dir=None, g2p_backend="rules",
                        device="cpu")
    assert synth.model_cfg.hidden_dim == 32 and synth.model_cfg.n_heads == 2
    wav, mel = synth.synthesize("Hello there.")
    assert np.isfinite(wav).all() and np.isfinite(mel).all() and mel.shape[1] == 8


def test_block_without_a_group_is_unsharded():
    cfg = ModelConfig(**MODEL)
    block = FastSpeech2(cfg).encoder_blocks[0]
    assert block.model_group is None and block.attention.n_heads == cfg.n_heads
    assert tuple(block.conv1.weight.shape) == (4 * cfg.hidden_dim, cfg.hidden_dim, 9)
    assert tuple(block.attention.out_proj.weight.shape) == (cfg.hidden_dim, cfg.hidden_dim)

