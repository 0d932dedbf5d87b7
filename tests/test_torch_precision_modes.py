"""The acoustic trainer's four matmul precision modes against the JAX
package's, on the CPU at the sizes of tests/test_torch_train.py.

On the card 'highest' and 'high' run fp32 with TF32 off, 'mixed' the same
forward with the backward products of every linear, attention product and
conv1d in TF32, 'default' every model product in TF32 (the table in
``spev_tpu_torch.models.modules``).  TF32 flags do nothing on the CPU, as
JAX's precision strings lower alike there, so:

- each mode's loss and gradients equal JAX's ``_loss_fn`` traced in the same
  mode (its custom VJPs under 'mixed'): loss within 1e-5 relative, every
  gradient within 1e-4 of its tensor's max |g| (test_torch_train.py's bars);
- 'mixed''s step equals 'high''s: loss within 1e-6 relative, parameters
  within JAX's own rtol 2e-4, atol 1e-5 (tests/test_trainer.py);
- a 'mixed' step with dropout and ``grad_accum=2`` runs and applies;
- a dispatch mode records the TF32 flags every product of a step sees:
  off in every forward, on in 'mixed''s backward products (each inside one
  of the routed autograd Functions) and nowhere else, on everywhere under
  'default', and the process's flags as they were after the step;
- an unknown mode raises ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from spev_tpu.models import modules as jax_modules
from spev_tpu.train.trainer import _loss_fn
from spev_tpu_torch.config import TrainConfig
from spev_tpu_torch.models import modules as m
from spev_tpu_torch.train.trainer import Trainer

from test_torch_train import _grad_tree, _trainer, jax_cfg, port_cfg, synth_batch

MODES = ("highest", "high", "mixed", "default")
PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
            torch.ops.aten.convolution, torch.ops.aten.convolution_backward}
ROUTED = {"_LinearMixedBackward", "_MatmulMixedBackward", "_Conv1dMixedBackward"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These steps are tiny: one thread each keeps them fast when several
    test workers share the cores (the caller's count is restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_precision():
    """The port's session mode is module state, as JAX's is: start and end
    every test at JAX's default."""
    m.set_matmul_precision("high")
    yield
    m.set_matmul_precision("high")


@pytest.fixture(scope="module")
def params0():
    from spev_tpu.train.trainer import init_train_state

    state = init_train_state(jax.random.PRNGKey(0), jax_cfg())
    return jax.tree.map(np.asarray, state.params)


def _port(mode, params0, tmp_path, **train_kw):
    cfg = port_cfg(**train_kw)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, matmul_precision=mode))
    return _trainer(params0, tmp_path, cfg)


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_matches_jax(params0, tmp_path, mode):
    batch = synth_batch(np.random.default_rng(21))
    jcfg = dataclasses.replace(jax_cfg(), train=dataclasses.replace(jax_cfg().train,
                                                                    matmul_precision=mode))
    jax_modules.set_matmul_precision(mode)  # read while tracing, as make_train_step does
    (jl, _), jg = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True), static_argnums=(1,))(
        jax.tree.map(jnp.asarray, params0), jcfg, jax.tree.map(jnp.asarray, batch), None, 1.0)
    tr = _port(mode, params0, tmp_path)
    loss, _, grads = tr.gradients(tr.to_device(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ours = jax.tree.leaves(_grad_tree(tr.model, grads))
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(jg), ours):
        ref = np.asarray(ref)
        bar = 1e-4 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= bar, (mode, jax.tree_util.keystr(path), bar)


def test_mixed_loss_equals_high_and_params_close(params0, tmp_path):
    batch = synth_batch(np.random.default_rng(11))
    out = {}
    for mode in ("high", "mixed"):
        tr = _port(mode, params0, tmp_path / mode)
        mt = tr.train_step(tr.to_device(batch))
        assert mt["skipped"] == 0.0 and tr.step == 1
        out[mode] = (mt["loss"], [p.detach().numpy().copy() for p in tr.model.parameters()])
    assert out["mixed"][0] == pytest.approx(out["high"][0], rel=1e-6)
    for a, b in zip(out["high"][1], out["mixed"][1]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


def test_mixed_step_with_dropout_and_grad_accum(params0, tmp_path):
    tr = _port("mixed", params0, tmp_path, dropout=0.1, grad_accum=2)
    mt = tr.train_step(tr.to_device(synth_batch(np.random.default_rng(3))))
    assert np.isfinite(mt["loss"]) and mt["skipped"] == 0.0 and tr.step == 1


class _FlagRecorder(TorchDispatchMode):
    """Every product's (backward?, autograd node, cuBLAS TF32, cuDNN TF32)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in PRODUCTS:
            node = torch._C._current_autograd_node()
            self.seen.append((node is not None, type(node).__name__ if node else None,
                              torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("caller", [(True, True), (False, False), (True, False)],
                         ids=["caller_tf32", "caller_fp32", "caller_cublas_only"])
def test_tf32_only_where_the_mode_puts_it(params0, tmp_path, monkeypatch, mode, caller):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller[0])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller[1])
    tr = _port(mode, params0, tmp_path)
    batch = tr.to_device(synth_batch(np.random.default_rng(13)))
    with _FlagRecorder() as rec:
        tr.train_step(batch)
    step = rec.seen
    with _FlagRecorder() as rec:
        tr.eval_step(batch)
    evals = rec.seen
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == caller
    assert m.get_matmul_precision() == "high"  # the session mode restored
    fwd = [s for s in step if not s[0]] + evals
    bwd = [s for s in step if s[0]]
    assert fwd and bwd and not any(s[0] for s in evals)
    on = mode == "default"
    assert {s[2:] for s in fwd} == {(on, on)}, mode
    if mode == "mixed":
        # every backward product of the base model runs in a routed Function
        assert {s[1] for s in bwd} <= ROUTED and {s[1] for s in bwd} == ROUTED
        assert {s[2:] for s in bwd} == {(True, True)}
    else:
        assert not {s[1] for s in bwd} & ROUTED
        assert {s[2:] for s in bwd} == {(on, on)}, mode


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="matmul_precision"):
        TrainConfig(matmul_precision="bf16")
    with pytest.raises(ValueError):
        m.set_matmul_precision("fp8")
    with pytest.raises(ValueError):
        with m.matmul_precision("tf32"):
            pass
    assert m.get_matmul_precision() == "high"
    assert TrainConfig().matmul_precision == "mixed"
    m.set_matmul_precision("mixed")
    assert m.get_matmul_precision() == "high"  # the forward's value
