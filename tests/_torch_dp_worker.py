"""One rank of the two-process data-parallel checks in
``tests/test_torch_parallel.py``: joins a gloo group, then writes
``<out_dir>/rank{r}.npz`` with

- the acoustic trainer's global loss, metrics and gradients on its half of
  the global batch (``acoustic_*``), the same with ``grad_accum=2``
  (``accum_*``) and its validation mel L1 (``val_mel``);
- one fused `VocoderTrainStep`'s losses (``voc_m_*``), and the gradients
  that ``d_step`` and ``g_step`` apply from the initial state
  (``voc_d_*``, ``voc_g_*``), on its half of the crop batch.

Each rank runs ``main`` through `spev_tpu_torch.parallel.multiproc.spawn_ranks`.
"""

import os
import tempfile

import numpy as np
import torch

from spev_tpu_torch.parallel import distributed

from _torch_dp_cases import VOCAB, acoustic_batch, acoustic_cfg, voc_cfg, vocoder_run


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

