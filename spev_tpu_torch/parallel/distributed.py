"""Multi-process set-up (counterpart of ``spev_tpu.parallel.distributed``).

``initialize()`` starts a ``torch.distributed`` process group: NCCL when the
device is CUDA (each rank on ``cuda:{LOCAL_RANK}``), gloo on the CPU.  It
reads its coordinates from the arguments, else from ``SPEV_COORDINATOR``
(``host:port``), ``SPEV_NUM_PROCESSES`` and ``SPEV_PROCESS_ID``, else from
the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` that
``python -m torch.distributed.run`` sets, so

    python -m torch.distributed.run --nproc_per_node N -m spev_tpu_torch.cli.train ...

trains data-parallel over N ranks.  Without any of them the run stays in
one process.  Unlike the JAX package, a failed initialisation raises: a run
asked to span N processes never goes on as one.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional

import torch

from spev_tpu_torch.errors import UserError
from spev_tpu_torch.parallel.mesh import Mesh, rows_of


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> bool:
    """Start the process group once (idempotent).  Returns True when one is
    up, False for a single-process run (no coordinates anywhere).  Raises
    `UserError` for incomplete coordinates, and lets any failure of
    ``init_process_group`` through."""
    if is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("SPEV_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None:
        num_processes = _env_int("SPEV_NUM_PROCESSES") or _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("SPEV_PROCESS_ID")
        if process_id is None:
            process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise UserError(
            f"incomplete process-group coordinates (coordinator {coordinator_address!r}, "
            f"{num_processes} processes, process id {process_id}); launch with "
            "python -m torch.distributed.run, or set SPEV_COORDINATOR, SPEV_NUM_PROCESSES "
            "and SPEV_PROCESS_ID")
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for an NCCL process group; pass "
                               "device='cpu' for gloo")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else int(process_id) % torch.cuda.device_count())
    _dist().init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                               world_size=int(num_processes), rank=int(process_id))
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    if is_initialized():
        _dist().destroy_process_group()


def rank() -> int:
    return _dist().get_rank() if is_initialized() else 0


def world_size() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def local_device() -> torch.device:
    """This rank's device: ``cuda:{current}`` under NCCL, the CPU under
    gloo or without a group."""
    if is_initialized() and _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if is_initialized():
        _dist().barrier()


def make_global_batch(mesh: Mesh, global_batch: dict) -> dict:
    """This rank's rows of a global batch (every rank holds the same global
    batch, e.g. from a `BucketBatcher` with the same seed); B must divide by
    the data axis."""
    return rows_of(global_batch, mesh.data_index, mesh.data_size)


def all_reduce_flat(tensors, group, op: str = "sum"):
    """One all-reduce of a list of tensors through a single flat fp32
    buffer: the counterpart of the gradient all-reduce XLA emits.  Returns
    new tensors of the inputs' shapes, summed (``op="sum"``) or averaged
    (``"mean"``) over the group's ranks; every rank gets the same bits."""
    dist = _dist()
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    if op == "mean":
        flat = flat / dist.get_world_size(group)
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[pos:pos + n].view(t.shape).to(t.dtype))
        pos += n
    return out
