"""Rematerialisation of the FFT blocks (``ModelConfig.remat``) on the CPU at
the sizes of tests/test_torch_train.py.

- With dropout on, ``'full'`` and ``'dots'`` give the step without remat:
  loss equal, every gradient within 1e-6 of its max |g|, and the dropout
  generator in the same state after the step, so the next step's masks
  agree too (two steps, parameters within 1e-6).
- With dropout off, a remat step equals JAX's remat step
  (``tests/test_trainer.py::test_remat_train_step_matches_plain``'s
  configs): loss within 1e-5 relative, gradients within 1e-4 of max |g| of
  ``_loss_fn`` traced with ``remat=True``.
- The length regulator stays outside every checkpoint: its forward runs
  once a forward and its backward once a backward (the plain versions,
  counted on the CPU).
- Without gradients (eval) no block is checkpointed.
- The stored config keeps ``remat``/``remat_policy`` both ways.
The model axis with remat runs in tests/test_torch_tensor_parallel.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spev_tpu.models import modules as jax_modules
from spev_tpu.train.checkpoint import load_checkpoint
from spev_tpu.train.trainer import _loss_fn
from spev_tpu.train.trainer import Trainer as JaxTrainer
from spev_tpu_torch.models import fastspeech2
from spev_tpu_torch.ops.cuda import length_regulator_kernel as lrk
from spev_tpu_torch.train.checkpoint import load_spev

from test_torch_train import V, _grad_tree, _trainer, jax_cfg, port_cfg, synth_batch

POLICIES = ("full", "dots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These steps are tiny: one thread each keeps them fast when several
    test workers share the cores (the caller's count is restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params0():
    from spev_tpu.train.trainer import init_train_state

    state = init_train_state(jax.random.PRNGKey(0), jax_cfg())
    return jax.tree.map(np.asarray, state.params)


def _cfg(policy=None, dropout=0.0, precision="high"):
    cfg = port_cfg(dropout=dropout)
    model = cfg.model if policy is None else dataclasses.replace(cfg.model, remat=True,
                                                                 remat_policy=policy)
    return dataclasses.replace(cfg, model=model,
                               train=dataclasses.replace(cfg.train, matmul_precision=precision))


def _close(ours, ref, rel, what):
    ref = ref.detach().numpy()
    err = float(np.abs(ours.detach().numpy() - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), (what, err)


@pytest.mark.parametrize("precision", ["high", "mixed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat_with_dropout(params0, tmp_path, monkeypatch, policy, precision):
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(lrk, "lr_fused_plain", counted(lrk.lr_fused_plain, "fwd"))
    monkeypatch.setattr(lrk, "lr_fused_bwd_plain", counted(lrk.lr_fused_bwd_plain, "bwd"))
    batch = synth_batch(np.random.default_rng(31))
    plain = _trainer(params0, tmp_path / "plain", _cfg(None, 0.1, precision))
    remat = _trainer(params0, tmp_path / policy, _cfg(policy, 0.1, precision))
    names = [n for n, _ in plain.model.named_parameters()]
    for step in range(2):
        tb = plain.to_device(batch)
        lp, _, gp = plain.gradients(tb)
        calls.update(fwd=0, bwd=0)
        lr, _, gr = remat.gradients(tb)
        assert calls == {"fwd": 1, "bwd": 1}
        assert float(lr.detach()) == float(lp.detach()), step
        for name, a, b in zip(names, gr, gp):
            _close(a, b, 1e-6, f"step {step} {name}")
        assert torch.equal(remat.generator.get_state(), plain.generator.get_state())
        plain.apply_gradients(gp, lp, {})
        remat.apply_gradients(gr, lr, {})
    for name, a, b in zip(names, remat.model.parameters(), plain.model.parameters()):
        _close(a, b, 1e-6, name)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_matches_jax(params0, tmp_path, policy):
    batch = synth_batch(np.random.default_rng(7))
    jcfg = jax_cfg()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, remat=True,
                                                                remat_policy=policy))
    jax_modules.set_matmul_precision("highest")
    (jl, _), jg = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True), static_argnums=(1,))(
        jax.tree.map(jnp.asarray, params0), jcfg, jax.tree.map(jnp.asarray, batch), None, 1.0)
    tr = _trainer(params0, tmp_path, _cfg(policy))
    loss, _, grads = tr.gradients(tr.to_device(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ours = jax.tree.leaves(_grad_tree(tr.model, grads))
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(jg), ours):
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), jax.tree_util.keystr(path)


def test_no_checkpoint_without_gradients(params0, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a block was checkpointed without gradients")

    monkeypatch.setattr(fastspeech2, "remat_block", refuse)
    tr = _trainer(params0, tmp_path, _cfg("full"))
    ev = tr.eval_step(tr.to_device(synth_batch(np.random.default_rng(12))))
    assert np.isfinite(float(ev["val_mel"]))


@pytest.mark.parametrize("policy", POLICIES)
def test_stored_config_keeps_remat_both_ways(params0, tmp_path, policy):
    tr = _trainer(params0, tmp_path / "port", _cfg(policy))
    mc = load_spev(tr.save("best", include_opt=False))["meta"]["model_config"]
    assert (mc["remat"], mc["remat_policy"]) == (True, policy)
    restored = type(tr.cfg.model).from_dict(mc)
    assert (restored.remat, restored.remat_policy) == (True, policy)
    jcfg = jax_cfg()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, remat=True,
                                                                remat_policy=policy))
    jt = JaxTrainer(jcfg, [f"p{i}" for i in range(V)], {}, ckpt_dir=str(tmp_path / "jax"),
                    log_dir=str(tmp_path / "jax"))
    jmc = load_checkpoint(jt.save("best", include_opt=False))["meta"]["model_config"]
    restored = type(tr.cfg.model).from_dict(jmc)
    assert (restored.remat, restored.remat_policy) == (True, policy)
