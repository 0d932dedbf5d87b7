"""The JAX package's public names and their counterparts in the port.

- The names the port once lacked, each against its JAX function:
  ``AudioConfig.n_freqs``, ``SpevConfig.replace``, ``default_config``,
  ``Vocab.sil_id``/``decode``, ``phonemize_text``, ``read_metrics``,
  ``write_outputs``, ``import_reference_checkpoint``/
  ``export_reference_checkpoint`` (files written by either package read by
  the other) and ``set_matmul_precision``/``get_matmul_precision``.
- A walk of ``spev_tpu``'s source (top-level functions and classes not
  starting with ``_``, and their methods): each name has a counterpart of
  the same name in ``spev_tpu_torch`` or stands in `COUNTERPARTS` with the
  port's counterpart, which must resolve.  A `COUNTERPARTS` entry for a
  name the port already has, or one the JAX package no longer has, fails
  too, so the list stays exact.
"""

import ast
import dataclasses
import importlib
import io
import pathlib
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import spev_tpu.config as jconfig
import spev_tpu_torch.config as pconfig
from spev_tpu.cli.common import write_outputs as jax_write_outputs
from spev_tpu.diag.metrics import log_metrics as jax_log_metrics
from spev_tpu.diag.metrics import read_metrics as jax_read_metrics
from spev_tpu.models import modules as jax_modules
from spev_tpu.text.g2p import phonemize_text as jax_phonemize_text
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.checkpoint import export_reference_checkpoint as jax_export
from spev_tpu.train.checkpoint import import_reference_checkpoint as jax_import
from spev_tpu.train.trainer import init_train_state
from spev_tpu_torch.cli.common import write_outputs
from spev_tpu_torch.diag import plots
from spev_tpu_torch.diag.metrics import log_metrics, read_metrics
from spev_tpu_torch.models import modules as m
from spev_tpu_torch.text.g2p import phonemize_text
from spev_tpu_torch.text.vocab import Vocab
from spev_tpu_torch.train.checkpoint import (export_reference_checkpoint,
                                             import_reference_checkpoint)

from test_torch_train import jax_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = "spev_tpu_torch."

# JAX name (module, qualified name) → the port's counterpart
# ("module:attribute[.attribute]" under spev_tpu_torch)
COUNTERPARTS = {
    # JAX's functional init/apply pairs are nn.Modules with seeded inits here
    "diag.probes.jnp_tree": "train.trainer:Trainer.to_device",
    "models.advanced.init_advanced_extras": "models.advanced:AdvancedExtras.init_",
    "models.advanced.init_advanced": "models.fastspeech2:FastSpeech2.random_init",
    "models.fastspeech2.init_fastspeech2": "models.fastspeech2:FastSpeech2.random_init",
    "models.fastspeech2.apply_fastspeech2": "models.fastspeech2:FastSpeech2.forward",
    "models.fastspeech2.FastSpeech2.init": "models.fastspeech2:FastSpeech2.random_init",
    "models.fastspeech2.FastSpeech2.apply": "models.fastspeech2:FastSpeech2.forward",
    "models.hifigan.conv_transpose1d": "models.hifigan:HiFiGANGenerator.forward",
    "models.hifigan.apply_hifigan": "models.hifigan:HiFiGANGenerator.forward",
    "models.hifigan.init_hifigan": "models.hifigan:HiFiGANGenerator.random_init",
    "models.hifigan.hifigan_params_from_state_dict": "utils.params:hifigan_tree_from_state_dict",
    # the folded generator is a TPU layout: the unfolded cuDNN generator
    # runs in its place (tests/test_torch_vocoder_training.py holds the two
    # within 1e-5)
    "models.hifigan.HiFiGANGenerator.folded": "models.hifigan:HiFiGANGenerator",
    "models.hifigan.HiFiGANGenerator.runtime": "models.hifigan:HiFiGANGenerator.forward",
    "models.hifigan.HiFiGANGenerator.jitted_runtime": "models.hifigan:HiFiGANGenerator.forward",
    "models.hifigan_folded.FoldedConv": "models.hifigan:HiFiGANGenerator",
    "models.hifigan_folded.FoldedConv.tree_flatten": "models.hifigan:HiFiGANGenerator",
    "models.hifigan_folded.FoldedConv.tree_unflatten": "models.hifigan:HiFiGANGenerator",
    "models.hifigan_folded.stage_folds": "models.hifigan:HiFiGANGenerator",
    "models.hifigan_folded.fold_hifigan": "models.hifigan:HiFiGANGenerator",
    "models.hifigan_folded.apply_hifigan_folded": "models.hifigan:HiFiGANGenerator.forward",
    "models.hifigan_disc.init_period_disc": "models.hifigan_disc:PeriodDiscriminator",
    "models.hifigan_disc.apply_period_disc": "models.hifigan_disc:PeriodDiscriminator.forward",
    "models.hifigan_disc.init_scale_disc": "models.hifigan_disc:ScaleDiscriminator",
    "models.hifigan_disc.apply_scale_disc": "models.hifigan_disc:ScaleDiscriminator.forward",
    "models.hifigan_disc.init_discriminators": "models.hifigan_disc:Discriminators.random_init",
    "models.hifigan_disc.apply_discriminators": "models.hifigan_disc:Discriminators.forward",
    "models.modules.init_linear": "models.modules:init_module_",
    "models.modules.init_conv1d": "models.modules:init_module_",
    "models.modules.init_layer_norm": "models.modules:init_module_",
    "models.modules.init_embedding": "models.modules:init_module_",
    "models.modules.init_mha": "models.modules:init_module_",
    "models.policy.init_policy_model": "models.policy:PolicyModel",
    "models.policy.apply_policy_model": "models.policy:PolicyModel.forward",
    # shardings are process groups and cut state dicts here
    "parallel.distributed.global_batch_sharding": "parallel.distributed:make_global_batch",
    "parallel.mesh.replicated": "parallel.mesh:shard_state_dict",
    "parallel.mesh.batch_sharding": "parallel.mesh:rows_of",
    "parallel.mesh.param_shardings": "parallel.mesh:shard_rule",
    "parallel.mesh.shard_batch": "parallel.distributed:make_global_batch",
    # a step is timed to the end of its device work (JAX's context manager
    # timed only the enqueue)
    "diag.profiling.StepTimer.step": "diag.profiling:StepTimer.record",
    # the train state and its steps are the Trainer's
    "train.checkpoint.load_checkpoint": "train.checkpoint:load_spev",
    "train.checkpoint.load_checkpoint_into": "train.trainer:Trainer.restore",
    "train.trainer.TrainState": "train.trainer:Trainer",
    "train.trainer.make_optimizer": "train.trainer:Trainer.apply_gradients",
    "train.trainer.init_train_state": "train.trainer:Trainer",
    "train.trainer.make_train_step": "train.trainer:Trainer.train_step",
    "train.trainer.make_eval_step": "train.trainer:Trainer.eval_step",
    "train.vocoder_trainer.make_vocoder_train_step": "train.vocoder_trainer:VocoderTrainStep",
    # the XLA compilation cache → the built kernels' .so cache
    "utils.cache.enable_compilation_cache": "ops.cuda.build:build_all",
    "utils.native.ensure_built": "utils.native:available",
    "utils.platform.on_tpu": "utils.platform:resolve_device",
    "utils.platform.fetch_overlapped": "train.trainer:Trainer.apply_gradients",
    # the reference .pt reader (torch.load(weights_only=True) here)
    "utils.torch_loader.read_torch_pickle": "utils.params:read_checkpoint",
    "utils.torch_loader.load_checkpoint": "utils.params:read_checkpoint",
    "utils.torch_loader.fastspeech2_params_from_state_dict":
        "utils.params:fastspeech2_tree_from_state_dict",
    "utils.torch_loader.fastspeech2_params_to_state_dict":
        "utils.params:fastspeech2_state_dict_from_tree",
}


def _public(root: pathlib.Path) -> dict:
    """{(module, qualified name)}: top-level functions and classes not
    starting with ``_``, and the methods of those classes."""
    out = set()
    for path in sorted(root.rglob("*.py")):
        mod = ".".join(path.relative_to(root).with_suffix("").parts)
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                out.add((mod, node.name))
                if isinstance(node, ast.ClassDef):
                    out.update((mod, f"{node.name}.{sub.name}") for sub in node.body
                               if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                               and not sub.name.startswith("_"))
    return out


def _resolve(target: str):
    mod, attr = target.split(":")
    obj = importlib.import_module(P + mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_public_jax_name_has_a_counterpart():
    jax_names = _public(ROOT / "spev_tpu")
    port_names = {name for _, name in _public(ROOT / "spev_tpu_torch")}
    assert len(jax_names) > 250
    missing = [f"{mod}.{name}" for mod, name in sorted(jax_names)
               if name not in port_names and f"{mod}.{name}" not in COUNTERPARTS]
    assert not missing, f"no counterpart in the port: {missing}"
    listed = {f"{mod}.{name}": name for mod, name in jax_names}
    stale = [k for k in COUNTERPARTS if k not in listed or listed[k] in port_names]
    assert not stale, f"COUNTERPARTS entries the port has by name, or JAX lacks: {stale}"
    for target in COUNTERPARTS.values():
        assert _resolve(target) is not None, target


def test_config_names_match_jax():
    for n_fft in (512, 800, 1024):
        assert pconfig.AudioConfig(n_fft=n_fft).n_freqs == jconfig.AudioConfig(n_fft=n_fft).n_freqs
    ours, ref = pconfig.default_config(), jconfig.default_config()
    for section in ("audio", "model", "train"):
        a, b = dataclasses.asdict(getattr(ours, section)), dataclasses.asdict(getattr(ref, section))
        assert {k: v for k, v in a.items() if k in b} == {k: b[k] for k in a if k in b}, section
    # the fields the port leaves out are the JAX package's TPU-only switches
    left_out = {k for s in ("audio", "model", "train")
                for k in dataclasses.asdict(getattr(ref, s))
                if k not in dataclasses.asdict(getattr(ours, s))}
    assert left_out == {"win_length", "use_pallas_lr", "fused_predictors", "max_phonemes",
                        "dropout_rng_impl", "metrics_window"}
    train = pconfig.TrainConfig(matmul_precision="default")
    assert ours.replace(train=train).train is train and ours.train.matmul_precision == "mixed"
    assert ref.replace(train=jconfig.TrainConfig(matmul_precision="default")).train \
        .matmul_precision == "default"


def test_vocab_and_phonemize_text_match_jax():
    text = "Hello there, this is a quick test."
    phones = phonemize_text(text, "rules")
    assert phones == jax_phonemize_text(text, "rules")
    ours, ref = Vocab.build(phones), JaxVocab.build(phones)
    assert ours.sil_id == ref.sil_id and ours.pad_id == ref.pad_id
    ids = ours.encode(phones)
    assert ours.decode(ids) == ref.decode(ids) == phones
    assert Vocab(["a", "b"]).sil_id == JaxVocab(["a", "b"]).sil_id == 0


def test_read_metrics_reads_either_package(tmp_path):
    assert read_metrics(str(tmp_path)) == jax_read_metrics(str(tmp_path)) == []
    log_metrics(str(tmp_path), 1, {"loss": 2.5})
    jax_log_metrics(str(tmp_path), 2, {"loss": np.float32(1.25), "lr": 1e-4})
    ours = read_metrics(str(tmp_path))
    assert ours == jax_read_metrics(str(tmp_path))
    assert [(r["step"], r["loss"]) for r in ours] == [(1, 2.5), (2, 1.25)]


def test_write_outputs_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(4000) * 0.1).astype(np.float32)
    mel = rng.standard_normal((20, 80)).astype(np.float32)
    printed = {}
    for name, fn in (("ours", write_outputs), ("ref", jax_write_outputs)):
        (tmp_path / name).mkdir()
        with redirect_stdout(io.StringIO()) as out:
            fn(wav, mel, str(tmp_path / name / "out.wav"), 16000)
        printed[name] = out.getvalue().replace(str(tmp_path / name), "DIR").splitlines()
    wavs = [(tmp_path / name / "out.wav").read_bytes() for name in ("ours", "ref")]
    assert wavs[0] == wavs[1]
    assert printed["ours"][0] == printed["ref"][0] == "Audio saved to DIR/out.wav"
    if plots.available():
        assert printed["ours"] == printed["ref"]
    assert (tmp_path / "ours" / "out_mel.png").exists() == plots.available()


def test_reference_checkpoint_import_and_export_both_ways(tmp_path):
    params = jax.tree.map(np.asarray, init_train_state(jax.random.PRNGKey(3), jax_cfg()).params)
    vocab, stats = ["<PAD>", "<SIL>", "a"], {"p_mean": 1.5, "e_std": 0.25}
    jax_export(str(tmp_path / "jax.pt"), params, vocab, stats, step=7, epoch=2)
    export_reference_checkpoint(str(tmp_path / "port.pt"), params, vocab, stats, step=7, epoch=2)
    for path in ("jax.pt", "port.pt"):
        ours = import_reference_checkpoint(str(tmp_path / path))
        ref = jax_import(str(tmp_path / path))
        assert ours[1:] == ref[1:] == (vocab, stats, 7, 2)
        a, b = jax.tree.leaves(ours[0]), jax.tree.leaves(ref[0])
        assert len(a) == len(b) == len(jax.tree.leaves(params))
        for x, y, z in zip(a, b, jax.tree.leaves(params)):
            np.testing.assert_array_equal(x, np.asarray(y))
            np.testing.assert_array_equal(x, z)
    sd = torch.load(tmp_path / "port.pt", weights_only=True)["model"]
    assert set(sd) == set(torch.load(tmp_path / "jax.pt", weights_only=True)["model"])


@pytest.mark.parametrize("mode", ["highest", "high", "mixed", "default"])
def test_session_precision_matches_jax(mode):
    try:
        m.set_matmul_precision(mode)
        jax_modules.set_matmul_precision(mode)
        assert m.get_matmul_precision() == jax_modules.get_matmul_precision()
    finally:
        m.set_matmul_precision("high")
