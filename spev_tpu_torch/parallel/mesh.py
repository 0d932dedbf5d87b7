"""Device meshes and the parameter sharding rules (counterpart of
``spev_tpu.parallel.mesh``).

A `Mesh` is an array of devices with named axes.
- **Over a process group** (``torch.distributed`` is initialised, as under
  ``python -m torch.distributed.run``): the positions are the group's
  ranks in order, one device each, with the last axis innermost; for
  JAX's ``("data", "model")`` mesh rank r sits at data index r // S and
  model index r % S.  The ``data`` axis splits the batch's rows
  (`rows_of`) and the trainers all-reduce their gradients over it.  A
  ``model`` axis above 1 is Megatron tensor parallelism of the FFT blocks
  (`spev_tpu_torch.parallel.tensor_parallel`): `shard_state_dict` cuts the
  reference state dict into a rank's shard, `gather_state_dict` joins the
  shards back.
- **In one process** (no group): the data axis spans local devices, as
  `Synthesizer(mesh=...)` uses it, one model replica per device.  A model
  axis needs a process group.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np
import torch

from spev_tpu_torch.errors import UserError


class Mesh:
    """``devices``: an object array of ``torch.device`` in the mesh's shape;
    ``axis_names``: one name per dimension; ``group``: the process group
    whose ranks are the positions in order, or None for a mesh inside one
    process.  ``model_group`` is this rank's group along the model axis
    (None without one), ``data_group`` its group along the data axis (the
    ranks with its model index; ``group`` itself without a model group)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None,
                 data_group=None, model_group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        self.model_group = model_group
        self.data_group = group if model_group is None else data_group

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_size(self) -> int:
        return self.shape.get("data", 1)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def _coord(self, axis: str) -> int:
        """This process's index along ``axis`` (0 inside one process)."""
        if self.group is None or axis not in self.axis_names:
            return 0
        import torch.distributed as dist

        coords = np.unravel_index(dist.get_rank(self.group), self.devices.shape)
        return int(coords[self.axis_names.index(axis)])

    @property
    def data_index(self) -> int:
        """This process's position on the data axis (0 inside one process)."""
        return self._coord("data")

    @property
    def model_index(self) -> int:
        """This process's position on the model axis (0 without one)."""
        return self._coord("model")

    @property
    def local_device(self) -> torch.device:
        """The device this process computes on."""
        if self.group is None:
            return self.devices.reshape(-1)[0]
        import torch.distributed as dist

        return self.devices.reshape(-1)[dist.get_rank(self.group)]


def _group_devices(device):
    """(group, each rank's device) when a process group is up, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from spev_tpu_torch.parallel.distributed import local_device

    # gloo carries CPU and CUDA tensors, so its ranks may share one card
    mine = local_device() if device is None or dist.get_backend() == "nccl" else device
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(mine))
    return dist.group.WORLD, [torch.device(n) for n in names]


def _axis_groups(shape, axis: int):
    """Every rank's group along ``axis``, created on every rank in one order
    (``new_group`` is collective); returns this rank's."""
    import torch.distributed as dist

    rows = np.moveaxis(np.arange(int(np.prod(shape))).reshape(shape), axis, -1)
    mine = None
    for ranks in rows.reshape(-1, shape[axis]).tolist():
        g = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return mine


def make_mesh(shape: Sequence[int] = (1,), axes: Sequence[str] = ("data",), devices=None,
              device=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.  With ``devices`` given,
    over those devices in one process.  Otherwise over the ranks of the
    process group when one is up (its size must equal the mesh's; each
    rank's device is its card under NCCL, else ``device``, by default the
    CPU: gloo carries CPU and CUDA tensors), else over the local CUDA
    devices.  Raises ValueError when there are too few devices, `UserError`
    for a ``model`` axis above 1 without a process group."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = int(np.prod(shape))
    group = None
    if devices is None:
        found = _group_devices(device)
        if found is not None:
            group, devices = found
            if n < len(devices):
                raise ValueError(f"mesh shape {shape} must span all {len(devices)} ranks of "
                                 "the process group")
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    model = dict(zip(axes, shape)).get("model", 1)
    if model > 1 and group is None:
        raise UserError(f"mesh {dict(zip(axes, shape))}: a 'model' axis runs over the ranks of a "
                        "process group; launch under python -m torch.distributed.run")
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    data_group = model_group = None
    if model > 1:
        # every rank creates every group, in the same order
        data_group = _axis_groups(shape, axes.index("data")) if "data" in axes else None
        model_group = _axis_groups(shape, axes.index("model"))
    return Mesh(arr.reshape(shape), axes, group, data_group, model_group)


def rows_of(batch: dict, index: int, parts: int) -> dict:
    """Rows ``[index·B/parts, (index+1)·B/parts)`` of every array in a batch
    dict; B must divide by ``parts``."""
    B = int(np.shape(next(iter(batch.values())))[0])
    if B % parts:
        raise ValueError(f"batch of {B} rows does not split over a data axis of {parts}")
    b = B // parts
    return {k: v[index * b:(index + 1) * b] for k, v in batch.items()}


# -- the 'model' axis: which leaves are cut, and how ------------------------------

# JAX's rules (``spev_tpu/parallel/mesh.py:_spec_for_param``) on the
# reference state-dict names of an FFT block: the dimension cut over the
# model axis, or "qkv" for the packed in-projection, (3H, H) / (3H,), cut
# head-aligned (whole heads of q, k and v on each rank).  Every other leaf,
# the biases of conv2 and out_proj included, is replicated; JAX's substring
# rules reach no leaf outside the FFT blocks in the base or the advanced
# model.
_FFT_LEAF = re.compile(r"(?:encoder|decoder)_blocks\.\d+\.(.+)$")
_RULES = {
    "conv1.weight": 0,  # column parallel: output channels
    "conv1.bias": 0,
    "conv2.weight": 1,  # row parallel: input channels
    "attention.in_proj_weight": "qkv",
    "attention.in_proj_bias": "qkv",
    "attention.out_proj.weight": 1,  # row parallel: the heads' channels
}


def shard_rule(name: str):
    """How the leaf ``name`` is cut over the model axis: a dimension,
    ``"qkv"``, or None when it is replicated."""
    m = _FFT_LEAF.match(name)
    return None if m is None else _RULES.get(m.group(1))


def _cut(t: torch.Tensor, rule, size: int, index: int) -> torch.Tensor:
    if rule == "qkv":
        return t.reshape(3, -1, *t.shape[1:]).chunk(size, 1)[index].reshape(-1, *t.shape[1:])
    return t.chunk(size, rule)[index].contiguous()


def _join(parts, rule) -> torch.Tensor:
    if rule == "qkv":
        tail = parts[0].shape[1:]
        return torch.cat([p.reshape(3, -1, *tail) for p in parts], 1).reshape(-1, *tail)
    return torch.cat(parts, rule)


def shard_state_dict(full_sd: dict, mesh: Mesh) -> dict:
    """This rank's shard of a state dict in the reference layout: each leaf
    that `shard_rule` cuts, cut into ``mesh.model_size`` pieces and piece
    ``mesh.model_index`` taken; the rest as they are."""
    size, index = mesh.model_size, mesh.model_index
    out = {}
    for name, t in full_sd.items():
        rule = shard_rule(name) if size > 1 else None
        out[name] = t if rule is None else _cut(t, rule, size, index)
    return out


def gather_state_dict(local_sd: dict, mesh: Mesh) -> dict:
    """The inverse of `shard_state_dict`: every cut leaf gathered over the
    model group (collective: every rank of the group calls it with the same
    names in the same order) and joined in the reference layout."""
    if mesh.model_size == 1:
        return dict(local_sd)
    import torch.distributed as dist

    out = {}
    for name, t in local_sd.items():
        rule = shard_rule(name)
        if rule is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
        out[name] = _join(parts, rule)
    return out
