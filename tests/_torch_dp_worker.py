"""The ranks of the multi-process checks, each run through
`spev_tpu_torch.parallel.multiproc.spawn_ranks`.  Each joins a gloo group
and writes ``<out_dir>/rank{r}.npz``.

`main`, the two-process data-parallel checks of
``tests/test_torch_parallel.py``:
- the acoustic trainer's global loss, metrics and gradients on its half of
  the global batch (``acoustic_*``), the same with ``grad_accum=2``
  (``accum_*``) and its validation mel L1 (``val_mel``);
- one fused `VocoderTrainStep`'s losses (``voc_m_*``), and the gradients
  that ``d_step`` and ``g_step`` apply from the initial state
  (``voc_d_*``, ``voc_g_*``), on its half of the crop batch.

`tp_main`, the four-process tensor-parallel checks of
``tests/test_torch_tensor_parallel.py`` on a (2, 2) data×model mesh:
- the rank's mesh coordinates and the shapes of its shards of the base and
  the advanced model (``shape_base_*``, ``shape_adv_*``);
- one FFT block with dropout 0.1 (generator seed 7), forward and backward
  on `block_input`: the output, the input's gradient and the
  gathered parameter gradients (``block_*``);
- one train step on its data index's rows of the global batch: the loss,
  the gradient norm, the gathered gradients and updated parameters
  (``step_*``); then
  ``save("last")`` into ``<out_dir>/ckpt``, a fresh tensor-parallel
  Trainer restored from it, and one more step of each (``resume_*``);
- the message of the `UserError` a Trainer with 3 heads raises on the
  mesh (``three_heads_error``);
- the gradients of one step with dropout 0.1 without remat and with each
  remat policy (``remat_{none,full,dots}_*``: the loss, the gathered
  gradients, the dropout generator's state after the step);
- ``cli.train --model_axis 2`` for ten epochs of a tiny model on a cache
  in ``<out_dir>/cli``, so that every save gathers and rank 0's model
  group runs the probes: its exit status and what it printed
  (``cli_rc``, ``cli_printed``).
"""

import contextlib
import dataclasses
import io
import os
import tempfile

import numpy as np
import torch

from spev_tpu_torch.parallel import distributed

from _torch_cache import write_cache
from _torch_dp_cases import (ADV_MODEL, MODEL, NMEL, VOCAB, H, acoustic_batch, acoustic_cfg,
                             block_input, voc_cfg, vocoder_run)
from spev_tpu_torch.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TinyModelConfig(ModelConfig):
    """The default config narrowed to what the CPU trains in seconds."""

    embed_dim: int = H
    hidden_dim: int = H
    n_mels: int = NMEL
    n_encoder_layers: int = 2
    n_decoder_layers: int = 2


def main(rank: int, n: int, coordinator: str, out_dir: str) -> None:
    from spev_tpu_torch.parallel.mesh import make_mesh
    from spev_tpu_torch.train import vocoder_trainer as vt
    from spev_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    distributed.initialize(coordinator, n, rank, device="cpu")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for prefix, accum in (("acoustic", 1), ("accum", 2)):
            tr = Trainer(acoustic_cfg(grad_accum=accum), VOCAB, {},
                         ckpt_dir=os.path.join(tmp, "c"), log_dir=os.path.join(tmp, "l"),
                         device="cpu")
            batch = acoustic_batch()
            loss, metrics, grads = tr.global_gradients(tr.to_device(tr.local_rows(batch)))
            out[f"{prefix}_loss"] = loss.numpy()
            for k, v in metrics.items():
                out[f"{prefix}_m_{k}"] = v.numpy()
            for (name, _), g in zip(tr.model.named_parameters(), grads):
                out[f"{prefix}_g_{name}"] = g.numpy()
        out["val_mel"] = np.float32(tr.validate([batch]))

    step = vt.VocoderTrainStep(voc_cfg(), fused=True, mesh=make_mesh((n,), ("data",)))
    for k, v in vocoder_run(vt, step).items():
        out[f"voc_{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()



def tp_main(rank: int, n: int, coordinator: str, out_dir: str) -> None:
    from spev_tpu_torch.errors import UserError
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2, FFTBlock
    from spev_tpu_torch.parallel.mesh import gather_state_dict, shard_state_dict
    from spev_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    distributed.initialize(coordinator, n, rank, device="cpu")
    tp = dict(mesh_shape=(n // 2, 2), mesh_axes=("data", "model"))
    ckpt = os.path.join(out_dir, "ckpt")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(acoustic_cfg(**tp), VOCAB, {}, ckpt_dir=ckpt, log_dir=tmp, device="cpu")
        mesh = tr.mesh
        out["coords"] = np.asarray([mesh.data_index, mesh.model_index, mesh.data_size,
                                    mesh.model_size])
        adv = FastSpeech2(ModelConfig(**ADV_MODEL), model_group=mesh.model_group)
        for kind, model in (("base", tr.model), ("adv", adv)):
            for name, t in model.state_dict().items():
                out[f"shape_{kind}_{name}"] = np.asarray(t.shape)

        # one FFT block, dropout on: the masks must equal the unsharded block's
        cfg = ModelConfig(**{**MODEL, "dropout": 0.1})
        full = {f"encoder_blocks.0.{k}": v for k, v in
                FastSpeech2.random_init(cfg, seed=3).encoder_blocks[0].state_dict().items()}
        block = FFTBlock(cfg, mesh.model_group).train()
        block.load_state_dict({k[len("encoder_blocks.0."):]: v
                               for k, v in shard_state_dict(full, mesh).items()})
        x, mask, w = block_input()
        x.requires_grad_(True)
        y = block(x, mask, torch.Generator().manual_seed(7))
        names = [f"encoder_blocks.0.{k}" for k, _ in block.named_parameters()]
        grads = torch.autograd.grad((y * w).sum(), [x] + list(block.parameters()))
        out["block_y"], out["block_gx"] = y.detach().numpy(), grads[0].numpy()
        for name, g in gather_state_dict(dict(zip(names, grads[1:])), mesh).items():
            out[f"block_g_{name}"] = g.numpy()

        batch = acoustic_batch()
        rows = tr.to_device(tr.local_rows(batch))
        loss, metrics, grads = tr.global_gradients(rows)  # train_step's two halves
        names = [n for n, _ in tr.model.named_parameters()]
        for name, g in gather_state_dict(dict(zip(names, grads)), mesh).items():
            out[f"step_g_{name}"] = g.numpy()
        m = tr.apply_gradients(grads, loss, metrics)
        out["step_loss"], out["step_grad_norm"] = np.float64(m["loss"]), np.float64(m["grad_norm"])
        out["step_skipped"] = np.float64(m["skipped"])
        for name, t in gather_state_dict(tr.model.state_dict(), mesh).items():
            out[f"step_p_{name}"] = t.numpy().copy()  # the next steps update in place
        tr.save("last")
        distributed.barrier()  # rank 0 writes
        again = Trainer(acoustic_cfg(**tp), VOCAB, {}, ckpt_dir=tmp, log_dir=tmp, device="cpu")
        again.restore(os.path.join(ckpt, "last.spev"))
        out["resume_loss"] = np.asarray([tr.train_step(rows)["loss"],
                                         again.train_step(rows)["loss"]])
        out["resume_step"] = np.asarray([tr.step, again.step])
        for name, t in gather_state_dict(again.model.state_dict(), mesh).items():
            out[f"resume_p_{name}"] = t.numpy()
        distributed.barrier()  # every rank read the checkpoint before the test may

        three = dataclasses.replace(acoustic_cfg(**tp), model=ModelConfig(**{**MODEL,
                                                                            "n_heads": 3}))
        try:
            Trainer(three, VOCAB, {}, ckpt_dir=tmp, log_dir=tmp, device="cpu")
        except UserError as e:
            out["three_heads_error"] = np.asarray(str(e))

        # remat over the model group, dropout on: a checkpointed sharded
        # block recomputes its all-reduces in the backward on every rank
        for policy in (None, "full", "dots"):
            cfg = acoustic_cfg(**tp)
            model = dataclasses.replace(cfg.model, dropout=0.1, vp_dropout=0.1,
                                        remat=policy is not None, remat_policy=policy or "full")
            t = Trainer(dataclasses.replace(cfg, model=model), VOCAB, {}, ckpt_dir=tmp,
                        log_dir=tmp, device="cpu")
            loss, _, grads = t.global_gradients(rows)
            key = f"remat_{policy or 'none'}"
            out[f"{key}_loss"] = np.float64(loss)
            out[f"{key}_gen"] = t.generator.get_state().numpy()
            names = [n for n, _ in t.model.named_parameters()]
            for name, g in gather_state_dict(dict(zip(names, grads)), mesh).items():
                out[f"{key}_g_{name}"] = g.numpy()
    out.update(cli_train_on_model_axis(rank, os.path.join(out_dir, "cli")))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()


def cli_train_on_model_axis(rank: int, run: str) -> dict:
    """``cli.train --model_axis 2`` in ``run`` (rank 0 writes the cache):
    ten epochs, so that ``last`` is saved twice, ``best`` on improvements
    and ``ckpt_10`` with the probes."""
    from spev_tpu_torch import config as port_config
    from spev_tpu_torch.cli import train as train_cli

    if rank == 0:
        write_cache(os.path.join(run, "cache"), n_utts=8, seed=1, n_mels=NMEL, max_ph=24,
                    max_dur=4)
    distributed.barrier()
    argv = ["--cache_dir", "cache", "--name", "tp", "--epochs", "10", "--batch_size", "4",
            "--save_every", "5", "--warmup_epochs", "1", "--warmup_steps", "5",
            "--model_axis", "2", "--device", "cpu"]
    cwd, original = os.getcwd(), port_config.ModelConfig
    port_config.ModelConfig = TinyModelConfig
    os.chdir(run)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = train_cli.main(argv)
    finally:
        os.chdir(cwd)
        port_config.ModelConfig = original
    distributed.barrier()  # rank 0 has written the checkpoints
    return {"cli_rc": np.int64(rc), "cli_printed": np.asarray(printed.getvalue())}
