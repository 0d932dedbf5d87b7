"""Multi-process dry run of data- and tensor-parallel training (counterpart
of ``spev_tpu.parallel.multiproc``).

`dryrun_multiprocess(n)` spawns n CPU processes (n even) that form a gloo
process group against a localhost coordinator, build JAX's data×model mesh
over the group with one device a rank, ``(n/2, 2)`` on ``("data",
"model")``, and take one full acoustic train step (dropout on) at the JAX
dry run's sizes (16 phonemes, 64 frames, hidden 32 with 2 heads, vocab 31,
16 mels).  Each model group of two ranks shares the FFT blocks and feeds
its data index's rows of one global batch; the gradients cross the process
boundary in the trainer's all-reduces.  The loss must be bit-equal in every
process.  Process 0's result is returned and optionally written as JSON.
`spawn_ranks` is the harness: it runs any ``module:function`` as the ranks
of a gloo group, and the port's multi-process tests use it too.

    python -m spev_tpu_torch.parallel.multiproc [N] [out.json]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_TAG = "MULTIPROC_RESULT "


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dry_run_batch(B: int, P: int = 16, M: int = 64, V: int = 31, n_mels: int = 16) -> dict:
    """The JAX dry run's global batch (numpy, seed 0): 8 phonemes of 4
    frames a row."""
    import numpy as np

    rng = np.random.default_rng(0)
    n_ph = 8
    ids = np.zeros((B, P), np.int32)
    ids[:, :n_ph] = rng.integers(1, V, size=(B, n_ph))
    durs = np.zeros((B, P), np.float32)
    durs[:, :n_ph] = 4

    def feat(lo, hi):
        return np.where(durs > 0, rng.uniform(lo, hi, (B, P)), 0.0).astype(np.float32)

    return {
        "ids": ids,
        "lens": np.full((B,), n_ph, np.int32),
        "durs": durs,
        "mel": np.clip(rng.standard_normal((B, M, n_mels)).astype(np.float32) - 4.0, -10, 2),
        "mel_lens": durs.sum(axis=1).astype(np.int32),
        "log_durs": (np.log(np.maximum(durs, 1) + 1) * (durs > 0)).astype(np.float32),
        "pitch": feat(-1, 1),
        "energy": feat(-1, 1),
        "breath": feat(0, 0.8),
        "rough": feat(0, 1.5),
        "bright": feat(-1, 1),
    }


def dryrun_worker(process_id: int, num_processes: int, coordinator: str) -> dict:
    """One process's leg: join the group, take one step on its rows, check
    the loss against every other process.  Returns the result dict."""
    import torch
    import torch.distributed as dist

    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.parallel import distributed
    from spev_tpu_torch.train.trainer import Trainer

    distributed.initialize(coordinator, num_processes, process_id, device="cpu")
    try:
        P, M, H, V, n_mels = 16, 64, 32, 31, 16
        B = 4 * num_processes
        cfg = SpevConfig(
            model=ModelConfig(vocab_size=V, embed_dim=H, hidden_dim=H, n_mels=n_mels,
                              max_frames=M),
            train=TrainConfig(batch_size=B, warmup_steps=10,
                              mesh_shape=(num_processes // 2, 2), mesh_axes=("data", "model")))
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(cfg, [f"p{i}" for i in range(V)], {},
                              ckpt_dir=os.path.join(tmp, "ckpt"), log_dir=os.path.join(tmp, "log"),
                              device="cpu")
            rows = trainer.local_rows(_dry_run_batch(B, P, M, V, n_mels))
            metrics = trainer.train_step(trainer.to_device(rows))
        loss = metrics["loss"]
        if not torch.isfinite(torch.tensor(loss)):
            raise RuntimeError(f"multiproc dry run loss is not finite: {loss}")
        losses = [None] * num_processes
        dist.all_gather_object(losses, loss)
        if any(x != losses[0] for x in losses):
            raise RuntimeError(f"the processes' losses differ: {losses}")
        return {
            "ok": True,
            "n_processes": num_processes,
            "devices_per_process": 1,
            "mesh": trainer.mesh.shape,
            "loss": loss,
            "losses": losses,
            "step": trainer.step,
        }
    finally:
        distributed.shutdown()


def spawn_ranks(n_processes: int, target: str, args: Sequence = (), timeout_s: float = 600.0,
                path: Sequence[str] = ()) -> list:
    """Run ``target`` (``"module:function"``, importable from the repo or
    from ``path``) in ``n_processes`` fresh processes as
    ``function(process_id, n_processes, coordinator, *args)``, where
    ``coordinator`` is a free localhost ``host:port`` for
    `distributed.initialize`.  Returns each process's return value (it must
    be JSON-serialisable) in process order.  Raises RuntimeError when a
    process fails or the run outlasts ``timeout_s``; no process outlives
    the call."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    sys_path = [REPO, *path]
    with tempfile.TemporaryDirectory() as logs:
        procs, files = [], []
        try:
            for pid in range(n_processes):
                code = (
                    f"import sys, json, importlib; sys.path[:0] = {sys_path!r}; "
                    f"mod, fn = {target!r}.split(':'); "
                    f"r = getattr(importlib.import_module(mod), fn)({pid}, {n_processes}, "
                    f"{coordinator!r}, *{list(args)!r}); "
                    f"print({_TAG!r} + json.dumps(r))"
                )
                f = open(os.path.join(logs, f"rank{pid}.log"), "w+")
                files.append(f)
                procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=f,
                                              stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + timeout_s
            for i, pr in enumerate(procs):
                try:
                    pr.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"{target} timed out after {timeout_s} s (process "
                                       f"{i})") from None
            results = []
            for i, (pr, f) in enumerate(zip(procs, files)):
                f.seek(0)
                out = f.read()
                if pr.returncode != 0:
                    raise RuntimeError(f"{target} process {i} failed (rc={pr.returncode}):\n"
                                       f"{out[-3000:]}")
                line = next((ln for ln in out.splitlines() if ln.startswith(_TAG)), None)
                if line is None:
                    raise RuntimeError(f"no result line from {target} process {i}:\n"
                                       f"{out[-3000:]}")
                results.append(json.loads(line[len(_TAG):]))
            return results
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
            for f in files:
                f.close()


def dryrun_multiprocess(n_processes: int = 2, out_json: Optional[str] = None,
                        timeout_s: float = 600.0) -> dict:
    """Spawn the workers, wait, and return process 0's result.  Raises
    ValueError for an odd ``n_processes`` (the model axis is 2 wide), and
    RuntimeError when a worker fails or the run outlasts ``timeout_s``."""
    if n_processes % 2:
        raise ValueError(f"n_processes must be even (got {n_processes}): the mesh is "
                         "(n/2, 2) over ('data', 'model')")
    result = spawn_ranks(n_processes, "spev_tpu_torch.parallel.multiproc:dryrun_worker",
                         timeout_s=timeout_s)[0]
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    res = dryrun_multiprocess(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                              out_json=sys.argv[2] if len(sys.argv) > 2 else None)
    print(json.dumps(res))
