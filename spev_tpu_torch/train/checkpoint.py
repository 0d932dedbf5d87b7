"""Checkpoints: the reference ``.pt`` schema and the JAX package's
``.spev`` format (counterpart of ``spev_tpu.train.checkpoint``).

``.pt`` (`save_checkpoint`, the port's trainer):

    {'model': state dict, 'optimizer': AdamW state dict or None,
     'vocab': [...], 'stats': {...}, 'step_num': int, 'epoch': int,
     'model_config': {...}}

``model_config`` holds the `ModelConfig` fields that shape the graph and
its training (``remat``, ``remat_policy``; the clamp contract, which is
constant, and the serving-time frame bucket are left out), so the
`Synthesizer` rebuilds the trained architecture.  A checkpoint without the
optimizer (``best``) serves inference; ``last`` keeps it for exact
resumption.  `utils.params.read_checkpoint` reads them back.

``.spev`` (`save_spev`, `load_spev`, `load_params`, `load_model_config`)
is flax's msgpack of ``{'model': <JAX parameter tree in state-dict form,
lists as {'0': ..} dicts>, 'optimizer': None | tree, 'meta': {'step_num',
'epoch', 'vocab', 'stats', 'model_config'}}``, read and written by
`spev_tpu_torch.utils.msgpack`.  The JAX package reads the port's files
and the port reads the JAX package's, optax state included (serving
ignores it).

The optimizer tree is the state of JAX's ``make_optimizer``,
``chain(clip_by_global_norm, adamw)``, in flax's state-dict form:
``{'0': {}, '1': {'0': {'count', 'mu', 'nu'}, '1': {}, '2': {'count'}}}``
— the clip's empty state, then adamw's ``scale_by_adam`` (``mu`` and
``nu`` are trees shaped like ``model``, ``count`` an int32 scalar), its
empty weight-decay state and its schedule's ``count``.  `optax_state` and
`adamw_state` map it to and from AdamW's per-parameter ``exp_avg``,
``exp_avg_sq`` and ``step``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.utils import msgpack
from spev_tpu_torch.utils.params import (fastspeech2_state_dict_from_tree,
                                        fastspeech2_tree_from_state_dict, read_checkpoint,
                                        unpack_checkpoint)


def model_config_dict(cfg: ModelConfig) -> dict:
    """Serializable subset of a `ModelConfig`: the nested clamp contract
    (constant) and the serving-time frame bucket are left out."""
    d = dataclasses.asdict(cfg)
    for k in ("clamps", "max_frames"):
        d.pop(k, None)
    return d


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], step: int, epoch: int,
                    vocab, stats: dict, model_cfg: ModelConfig) -> None:
    """Write atomically (a temporary file, then a rename), tensors on the CPU."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "vocab": list(vocab),
        "stats": {k: float(v) for k, v in (stats or {}).items()},
        "step_num": int(step),
        "epoch": int(epoch),
        "model_config": model_config_dict(model_cfg),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def adamw_chain_state(named_params: List[Tuple[str, torch.Tensor]],
                      optimizer: torch.optim.Optimizer, schedule_count: int,
                      to_tree: Callable[[dict], Any]) -> dict:
    """AdamW's state as the chain state of optax's ``adamw``, numpy leaves:
    ``{'0': {'count', 'mu', 'nu'}, '1': {}, '2': {'count'}}`` (module
    docstring), with ``mu``/``nu`` made trees of the weights' layout by
    ``to_tree`` (a state dict → tree function).  A parameter without state
    yet (no update applied) has zero moments; adam's ``count`` is AdamW's
    per-parameter step (every parameter steps together), the schedule's is
    ``schedule_count``."""
    mu, nu, count = {}, {}, 0
    for name, p in named_params:
        st = optimizer.state.get(p, {})
        if "exp_avg" in st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            count = int(st["step"])
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    return {"0": {"count": np.asarray(count, np.int32), "mu": to_tree(mu), "nu": to_tree(nu)},
            "1": {}, "2": {"count": np.asarray(schedule_count, np.int32)}}


def adamw_chain_from_state(chain: dict, names: List[str],
                           to_state_dict: Callable[[Any], dict]) -> Tuple[Dict[int, dict], int]:
    """The inverse of `adamw_chain_state`: from a stored chain state (state-
    dict form), AdamW's ``state`` section of ``Optimizer.load_state_dict`` for
    the parameters ``names`` in order, and the schedule's count.
    ``to_state_dict`` turns a ``mu``/``nu`` tree into a state dict.  Raises a
    `UserError` when the chain is not optax's ``adamw`` or lacks one of the
    parameters."""
    try:
        adam = chain["0"]
        mu = to_state_dict(relistify(adam["mu"]))
        nu = to_state_dict(relistify(adam["nu"]))
        step = float(np.asarray(adam["count"]))
        schedule_count = int(np.asarray(chain["2"]["count"]))
    except (KeyError, TypeError) as e:
        raise UserError(f"the optimizer state is not that of the JAX package's AdamW chain "
                        f"({e!r})") from None
    missing = [n for n in names if n not in mu]
    if missing:
        raise UserError(f"the optimizer state has no moments for {missing[:3]}")
    state = {i: {"step": torch.tensor(step), "exp_avg": torch.as_tensor(mu[n]),
                 "exp_avg_sq": torch.as_tensor(nu[n])} for i, n in enumerate(names)}
    return state, schedule_count


def optax_state(named_params: List[Tuple[str, torch.Tensor]],
                optimizer: torch.optim.Optimizer, schedule_count: int) -> dict:
    """AdamW's state as the optax chain state of JAX's ``make_optimizer``,
    ``chain(clip_by_global_norm, adamw)`` (module docstring)."""
    return {"0": {}, "1": adamw_chain_state(named_params, optimizer, schedule_count,
                                            fastspeech2_tree_from_state_dict)}


def adamw_state(tree: dict, names: List[str]) -> Dict[int, dict]:
    """The inverse of `optax_state`: AdamW's ``state`` section for the
    parameters ``names`` in order.  Raises a `UserError` when the tree is
    not that of ``make_optimizer`` or lacks one of the parameters."""
    try:
        chain = tree["1"]
    except (KeyError, TypeError) as e:
        raise UserError(f"the optimizer state is not that of the JAX package's AdamW chain "
                        f"({e!r})") from None
    return adamw_chain_from_state(chain, names, fastspeech2_state_dict_from_tree)[0]


def state_dict_form(tree):
    """flax's ``to_state_dict`` of a tree of dicts, lists and arrays: lists
    and tuples become ``{'0': ..}`` dicts, tensors numpy arrays."""
    if isinstance(tree, dict):
        return {str(k): state_dict_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict_form(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_spev(path: str, state_dict_or_tree: dict, *, vocab, stats: dict, step: int = 0,
              epoch: int = 0, model_config: Optional[dict] = None, optimizer=None) -> None:
    """Write a ``.spev`` as ``spev_tpu.train.checkpoint.save_checkpoint``
    does, atomically (a ``.tmp`` file, then a rename).

    state_dict_or_tree: the port's FastSpeech2 state dict (turned into the
    JAX tree by `fastspeech2_tree_from_state_dict`) or a JAX parameter tree.
    model_config: a `model_config_dict`-style field dict, or None.
    optimizer: a tree to store as the optimizer state, or None."""
    tree = state_dict_or_tree
    if "embedding.weight" in tree:
        tree = fastspeech2_tree_from_state_dict(tree)
    payload = {
        "model": state_dict_form(tree),
        "optimizer": state_dict_form(optimizer) if optimizer is not None else None,
        "meta": {
            "step_num": int(step),
            "epoch": int(epoch),
            "vocab": list(vocab) if vocab is not None else [],
            "stats": {k: float(v) for k, v in (stats or {}).items()},
            "model_config": dict(model_config) if model_config else None,
        },
    }
    write_msgpack(path, payload)


def write_msgpack(path: str, tree: dict) -> None:
    """flax's msgpack of a state-dict tree, written atomically (a ``.tmp``
    file, then a rename)."""
    blob = msgpack.serialize(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_spev(path: str) -> dict:
    """The raw ``.spev`` payload (``model`` and ``optimizer`` in state-dict
    form: lists appear as ``{'0': ..}`` dicts); arrays are read-only numpy
    arrays over the file's bytes."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        ckpt = msgpack.restore(data)
    except msgpack.MsgpackError as e:
        raise UserError(f"{path}: not a .spev checkpoint ({e})") from None
    if not isinstance(ckpt, dict) or "model" not in ckpt or "meta" not in ckpt:
        raise UserError(f"{path}: not a .spev checkpoint (no 'model' and 'meta')")
    return ckpt


def relistify(tree):
    """Invert the ``list → {'0': ..}`` conversion of the state-dict form, so
    a loaded tree has the structure of a freshly built one."""
    if isinstance(tree, dict):
        conv = {k: relistify(v) for k, v in tree.items()}
        if conv and all(k.isdigit() for k in conv):
            return [conv[str(i)] for i in range(len(conv))]
        return conv
    return tree


def load_params(path: str) -> Tuple[Any, list, dict]:
    """(JAX parameter tree with lists, vocab list, stats dict) of a ``.spev``."""
    ckpt = load_spev(path)
    meta = ckpt["meta"]
    return relistify(ckpt["model"]), list(meta["vocab"]), dict(meta["stats"])


def load_model_config(path: str) -> dict:
    """The stored `ModelConfig` field dict of a ``.spev`` ({} when it holds
    none, or for another format)."""
    if not path.endswith(".spev"):
        return {}
    return dict(load_spev(path)["meta"].get("model_config") or {})


def import_reference_checkpoint(path: str) -> Tuple[dict, list, dict, int, int]:
    """A reference ``.pt`` (or a ``.spev``) → (the JAX package's parameter
    tree with float32 numpy leaves, vocab list, stats dict, step, epoch)."""
    ckpt = read_checkpoint(path)
    sd, vocab, stats = unpack_checkpoint(ckpt)
    return (fastspeech2_tree_from_state_dict(sd), vocab, stats, int(ckpt.get("step_num", 0)),
            int(ckpt.get("epoch", 0)))


def export_reference_checkpoint(path: str, params: dict, vocab, stats: dict, step: int = 0,
                                epoch: int = 0) -> None:
    """Write a parameter tree in the JAX package's layout as a
    reference-schema ``.pt`` (``{'model', 'vocab', 'stats', 'step_num',
    'epoch'}``, no optimizer)."""
    torch.save({"model": fastspeech2_state_dict_from_tree(params), "vocab": list(vocab),
                "stats": {k: float(v) for k, v in dict(stats).items()}, "step_num": int(step),
                "epoch": int(epoch)}, path)
