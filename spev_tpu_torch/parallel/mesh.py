"""Device meshes (counterpart of ``spev_tpu.parallel.mesh``).

A `Mesh` is an array of devices with named axes.  Only the ``data`` axis is
ported: the batch's rows are split over it (`rows_of`) and every parameter
is replicated.
- **Over a process group** (``torch.distributed`` is initialised, as under
  ``python -m torch.distributed.run``): the data axis spans the group's
  ranks, one device each, and the trainers all-reduce their gradients over
  the group (`spev_tpu_torch.parallel.distributed`).
- **In one process** (no group): the data axis spans local devices, as
  `Synthesizer(mesh=...)` uses it, one model replica per device.

The JAX package's ``model`` axis (Megatron tensor parallelism of the FFT
blocks and attention) and its parameter sharding rules are not ported: a
mesh with ``model`` above 1 raises `UserError`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spev_tpu_torch.errors import UserError


class Mesh:
    """``devices``: an object array of ``torch.device`` in the mesh's shape;
    ``axis_names``: one name per dimension; ``group``: the process group
    whose ranks the positions are (position i of the data axis is rank i),
    or None for a mesh inside one process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_size(self) -> int:
        return self.shape.get("data", 1)

    @property
    def data_index(self) -> int:
        """This process's position on the data axis (0 inside one process)."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def local_device(self) -> torch.device:
        """The device this process computes on."""
        return self.devices.reshape(-1)[self.data_index]


def _group_devices():
    """(group, each rank's device) when a process group is up, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from spev_tpu_torch.parallel.distributed import local_device

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(local_device()))
    return dist.group.WORLD, [torch.device(n) for n in names]


def make_mesh(shape: Sequence[int] = (1,), axes: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.  With ``devices`` given,
    over those devices in one process.  Otherwise over the ranks of the
    process group when one is up (its size must equal the mesh's), else over
    the local CUDA devices.  Raises ValueError when there are too few
    devices, `UserError` for a ``model`` axis above 1."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if dict(zip(axes, shape)).get("model", 1) > 1:
        raise UserError(f"mesh {dict(zip(axes, shape))}: the 'model' axis (tensor parallelism) "
                        "is not ported to PyTorch yet (ROADMAP.md, section 1)")
    n = int(np.prod(shape))
    group = None
    if devices is None:
        found = _group_devices()
        if found is not None:
            group, devices = found
            if n < len(devices):
                raise ValueError(f"mesh shape {shape} must span all {len(devices)} ranks of "
                                 "the process group")
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axes, group)


def rows_of(batch: dict, index: int, parts: int) -> dict:
    """Rows ``[index·B/parts, (index+1)·B/parts)`` of every array in a batch
    dict; B must divide by ``parts``."""
    B = int(np.shape(next(iter(batch.values())))[0])
    if B % parts:
        raise ValueError(f"batch of {B} rows does not split over a data axis of {parts}")
    b = B // parts
    return {k: v[index * b:(index + 1) * b] for k, v in batch.items()}
