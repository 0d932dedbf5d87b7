"""Acoustic-model trainer: train and eval steps, the NaN-skip policy,
warmup, validation and checkpoints (counterpart of
``spev_tpu.train.trainer``).

- **Clip**: global-norm clip in optax's form, ``g / ‖g‖ · max`` only when
  ``‖g‖ ≥ max`` (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6``
  and would give another result).
- **AdamW**: ``torch.optim.AdamW`` with betas (0.9, 0.98), eps 1e-9 and
  weight decay 0.01 on every parameter.  optax decays every leaf, so every
  parameter gets a gradient (zeros where autograd has none) before a step.
- **Warmup**: the n-th *applied* update runs at ``lr · min(n / warmup, 1)``.
- **NaN skip**: ``ok = isfinite(loss) & isfinite(‖g‖)``, read on the host
  once per step together with the step's metrics.  When it is false the
  parameters, the optimizer state and the step counter stay as they were,
  ``skipped`` is 1, and an epoch aborts after more than ``max_nan_batches``
  such steps (the reference's per-batch semantics).
- **Gradient accumulation** (``grad_accum > 1``): the batch is split into
  micro-batches; those with a non-finite loss are left out of the mean, and
  a window with none finite is skipped.
- **Two phases**: ``variance_weight`` is 0 during ``warmup_epochs``.
- **Advanced model** (``use_vad`` or ``n_speakers > 1``): a batch's
  ``speaker_ids`` and ``vad`` go through `models.advanced.apply_advanced`
  (the encoder bias), as JAX's ``_advanced_batch_kw`` routes them; the
  ``advanced.*`` parameters take part in AdamW and the clip like the rest.
- **Checkpoints**: ``<name>.spev`` as the JAX package's ``Trainer.save``
  writes it (the optimizer as optax's chain state,
  `train.checkpoint.optax_state`), so either package resumes the other's
  ``last.spev``; a model without ``advanced`` also gets ``<name>.pt``.
- **Spans** (`diag.profiling.span`, only while a profiler records):
  ``spev.train.forward`` and ``spev.train.backward`` in `loss_and_grads`
  (the backward's launches come from autograd's device thread),
  ``spev.train.update`` around `apply_gradients` with
  ``spev.train.host_read`` inside it, ``spev.train.to_device``.
- **Dropout** masks come from one ``torch.Generator`` on the training
  device seeded from ``TrainConfig.seed`` (and the rank; JAX's bits cannot
  be matched); the weights are drawn on the CPU from the same seed.
  Shuffling is `BucketBatcher`'s ``random.Random(seed + epoch)``.
- **Data parallelism**: when a ``torch.distributed`` process group is up,
  the trainer's mesh has a 'data' axis over all its ranks
  (`spev_tpu_torch.parallel`).  Every rank reads the same global batches
  and takes its rows of each.  Its loss uses the global batch's
  denominators (`train.loss.compute_losses`), so the losses and gradients
  are summed over the ranks in one flat all-reduce a step (autograd's
  ``torch.autograd.grad`` does not go through DDP's reducer); the clip, the
  NaN skip and the warmup then see the same numbers on every rank.
  Validation sums over the ranks too.  Only rank 0 writes checkpoints.
- **Tensor parallelism**: ``TrainConfig.mesh_shape``/``mesh_axes`` with a
  'model' entry S > 1 make the mesh ``(world // S, S)`` over
  ``("data", "model")``; each model group of S ranks shares the FFT blocks
  (`spev_tpu_torch.parallel.tensor_parallel`, the weights cut from the
  seeded full model by `parallel.mesh.shard_state_dict`) and takes the same
  rows.  The gradients are summed over the data group only.  The clip's
  sum of squares adds the sharded leaves over the model group and counts
  the replicated ones once; that sum, the loss and the metrics travel in
  one all-reduce over the model group from its first rank, so every rank
  takes the same skip decision.  AdamW's moments live in the shards'
  layout; `save` gathers the parameters and moments into the reference
  layout (rank 0 writes) and `restore` cuts them, so checkpoints move
  between tensor-parallel and one-process runs.

The model runs eagerly at ``TrainConfig.matmul_precision``
(`models.modules.matmul_precision`): ``'highest'`` and ``'high'`` in fp32
with TF32 off for matmuls and cuDNN convolutions, ``'mixed'`` (the default)
with the same forward and the backward products of the linear layers,
attention products and convolutions in TF32, ``'default'`` with every model
product in TF32.  Each gradient and eval pass enters the mode and restores
the process's settings afterwards; the eval pass is forward-only, so
``'mixed'`` runs it as ``'high'``.  The length regulator's forward and
backward are the CUDA kernels K1 and K1b on the card, exact in every mode.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Iterable, List, Optional

import numpy as np
import torch

from spev_tpu_torch.config import SpevConfig
from spev_tpu_torch.data.prefetch import prefetch
from spev_tpu_torch.diag.profiling import span, spanned
from spev_tpu_torch.diag.quality import duration_error_pct, mel_cepstral_distortion
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.models.advanced import apply_advanced
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.models.modules import matmul_precision
from spev_tpu_torch.parallel import distributed
from spev_tpu_torch.parallel.mesh import (gather_state_dict, make_mesh, shard_rule,
                                          shard_state_dict)
from spev_tpu_torch.train.checkpoint import (adamw_state, model_config_dict, optax_state,
                                             save_checkpoint, save_spev)
from spev_tpu_torch.train.loss import compute_losses
from spev_tpu_torch.utils.params import read_checkpoint
from spev_tpu_torch.utils.platform import resolve_device

_TRACKS = ("pitch", "energy", "breath", "rough", "bright")


def forward_losses(model: FastSpeech2, cfg: SpevConfig, batch: dict, variance_weight: float,
                   generator=None, group=None):
    """Teacher-forced forward at the batch's buckets (with the batch's
    ``speaker_ids`` and ``vad`` as the advanced model's encoder bias), then
    the losses (this rank's share of the global batch's under ``group``).
    Returns (outputs, (loss, metrics))."""
    kw = {f"target_{k}": batch[k] for k in _TRACKS}
    if cfg.model.use_nasality and "nasal" in batch:
        kw["target_nasal"] = batch["nasal"]
    out = apply_advanced(model, batch["ids"], batch["lens"], batch["mel"].shape[1],
                         speaker_ids=batch.get("speaker_ids"), vad=batch.get("vad"),
                         target_durations=batch["durs"], dropout_generator=generator, **kw)
    return out, compute_losses(out, batch, cfg.train, variance_weight, group)


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    with span("spev.train.backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def loss_and_grads(model: FastSpeech2, cfg: SpevConfig, batch: dict, variance_weight: float,
                   generator=None, group=None):
    """(loss, metrics, one gradient per ``model.parameters()``).  With
    ``grad_accum`` > 1 the mean over the micro-batches whose loss is
    finite; the loss is NaN when none is.  Under ``group`` these are this
    rank's shares (sum them over the group); a micro-batch counts when its
    loss summed over the group is finite."""
    params = list(model.parameters())
    accum = max(1, int(cfg.train.grad_accum))
    if accum == 1:
        with span("spev.train.forward"):
            _, (loss, metrics) = forward_losses(model, cfg, batch, variance_weight, generator,
                                                group)
        return loss, metrics, _grads(loss, params)
    mb = batch["ids"].shape[0] // accum
    gsum = [torch.zeros_like(p) for p in params]
    lsum = msum = None
    nok = torch.zeros((), device=batch["ids"].device)
    zero = torch.zeros((), device=batch["ids"].device)
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        with span("spev.train.forward"):
            _, (loss, metrics) = forward_losses(model, cfg, micro, variance_weight, generator,
                                                group)
        total = (loss.detach() if group is None
                 else distributed.all_reduce_flat([loss], group)[0])
        finite = torch.isfinite(total)
        gsum = [a + torch.where(finite, g, zero) for a, g in zip(gsum, _grads(loss, params))]
        keep = {k: torch.where(finite, v.detach(), zero) for k, v in metrics.items()}
        msum = keep if msum is None else {k: msum[k] + keep[k] for k in msum}
        lsum = keep["loss"] if lsum is None else lsum + keep["loss"]
        nok = nok + finite.to(torch.float32)
    denom = torch.clamp_min(nok, 1.0)
    loss = torch.where(nok > 0, lsum / denom, torch.full_like(lsum, float("nan")))
    return loss, {k: v / denom for k, v in msum.items()}, [g / denom for g in gsum]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Trainer:
    """Host-side training loop on one device, or on one rank of a 'data'
    mesh: epochs, NaN budget, validation, ``last``/``best`` checkpoints
    carrying vocab, stats, step, epoch and the model config."""

    def __init__(self, cfg: SpevConfig, vocab, stats: dict, ckpt_dir: str = "checkpoints/run",
                 log_dir: str = "logs/run", device="cuda"):
        """device: "cuda" (the default) raises when no GPU is present; pass
        "cpu" to train on the CPU.  When a process group is up, the trainer
        is one rank of a mesh over all its ranks (a 'data' axis, and a
        'model' axis when ``TrainConfig.mesh_shape`` names one) and trains
        on the rank's device: its card under NCCL, ``device`` under gloo."""
        self.device = resolve_device(device)
        mesh = self._mesh(cfg)
        if mesh.local_device.type != self.device.type:
            raise UserError(f"the process group's device is {mesh.local_device}, the "
                            f"trainer's {self.device}")
        self.device = mesh.local_device
        if cfg.train.batch_size % mesh.data_size:
            raise UserError(f"batch size {cfg.train.batch_size} does not divide by the data "
                            f"axis ({mesh.data_size})")
        self.mesh, self.group = mesh, mesh.data_group
        self.cfg = cfg
        self.vocab = list(getattr(vocab, "symbols", vocab))
        self.stats = stats
        self.ckpt_dir, self.log_dir = ckpt_dir, log_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        os.makedirs(log_dir, exist_ok=True)
        self.model = FastSpeech2.random_init(cfg.model, seed=cfg.train.seed)
        if mesh.model_size > 1:
            full = self.model.state_dict()
            self.model = FastSpeech2(cfg.model, model_group=mesh.model_group).eval()
            self.model.load_state_dict(shard_state_dict(full, mesh))
        self.model.to(self.device)
        self.params = list(self.model.parameters())
        self._sharded = [shard_rule(n) is not None for n, _ in self.model.named_parameters()]
        self.optimizer = self._new_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 1_000_003 * mesh.data_index)
        self.step = 0  # applied updates (the reference's step_num)
        self.epoch = 0
        self.nan_count = 0
        self.best_val = math.inf
        self.last_quality: dict = {}

    def _mesh(self, cfg: SpevConfig):
        """The mesh of ``cfg.train.mesh_shape``/``mesh_axes`` over the process
        group (over this device without one): ``(world // S, S)`` on
        ``("data", "model")`` for a model entry S > 1, else ``(world,)`` on
        ``("data",)``.  Raises `UserError` when S does not divide the world
        size or a data entry other than 1 disagrees (`FastSpeech2` checks
        that S cuts the heads and the FFN)."""
        tc = cfg.train
        if len(tc.mesh_shape) != len(tc.mesh_axes):
            raise UserError(f"TrainConfig.mesh_shape {tc.mesh_shape} and mesh_axes "
                            f"{tc.mesh_axes} differ in length")
        sizes = dict(zip(tc.mesh_axes, (int(n) for n in tc.mesh_shape)))
        size, world = sizes.get("model", 1), distributed.world_size()
        if world % size:
            raise UserError(f"a 'model' axis of {size} needs a process group whose size divides "
                            f"by it (this run has {world} process(es)); launch under "
                            "python -m torch.distributed.run")
        data, given = world // size, sizes.get("data", 1)
        # (1,) over ("data",), the default, is a data axis over the whole group
        if given != data and (size > 1 or given != 1):
            raise UserError(f"TrainConfig.mesh_shape {tc.mesh_shape} over {tc.mesh_axes}: the data "
                            f"axis is the process group's {world} rank(s) over a model axis of "
                            f"{size}, {data}")
        if not distributed.is_initialized():
            return make_mesh((1,), ("data",), devices=[self.device])
        if size > 1:
            return make_mesh((data, size), ("data", "model"), device=self.device)
        return make_mesh((data,), ("data",), device=self.device)

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh.data_index == 0 and self.mesh.model_index == 0

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (all of it on one device)."""
        if self.group is None:
            return batch
        return distributed.make_global_batch(self.mesh, batch)

    def _new_optimizer(self) -> torch.optim.AdamW:
        tc = self.cfg.train
        return torch.optim.AdamW(self.params, lr=tc.learning_rate, betas=tc.betas, eps=tc.eps,
                                 weight_decay=tc.weight_decay)

    @spanned("spev.train.to_device")
    def to_device(self, batch: dict) -> dict:
        """A numpy batch from `BucketBatcher` as tensors on the device."""
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}
        out["ids"] = out["ids"].long()
        if "speaker_ids" in out:
            out["speaker_ids"] = out["speaker_ids"].long()
        return out

    @spanned("spev.train.update")
    def apply_gradients(self, grads: List[torch.Tensor], loss: torch.Tensor,
                        metrics: dict) -> dict:
        """Clip, warm up and apply one AdamW update, unless the loss or the
        gradient norm is not finite.  One host read per call.  Returns the
        metrics as floats with ``grad_norm``, ``skipped`` and ``lr``."""
        tc = self.cfg.train
        packed = self._norm_and_values(grads, loss, metrics)
        gnorm = packed[1]
        with span("spev.train.host_read"):
            vals = packed.tolist()
        lr = tc.learning_rate * min((self.step + 1) / tc.warmup_steps, 1.0)
        ok = math.isfinite(vals[0]) and math.isfinite(vals[1])
        if ok:
            clip = vals[1] >= tc.grad_clip_norm
            for p, g in zip(self.params, grads):
                p.grad = g / gnorm * tc.grad_clip_norm if clip else g
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.step += 1
        for p in self.params:
            p.grad = None
        out = dict(zip(metrics, vals[2:]))
        out.update(grad_norm=vals[1], skipped=0.0 if ok else 1.0, lr=lr)
        return out

    def _norm_and_values(self, grads: List[torch.Tensor], loss: torch.Tensor,
                         metrics: dict) -> torch.Tensor:
        """[loss, global gradient norm, *metrics] on the device.  On a model
        axis the sharded leaves' squares are summed over the model group and
        the replicated ones counted once, and the loss and metrics come from
        the group's first rank, so every rank holds the same numbers."""
        values = [loss.detach()] + [v.detach() for v in metrics.values()]
        if self.mesh.model_size == 1:
            return torch.stack(values[:1] + [global_norm(grads)] + values[1:])
        zero = torch.zeros((), device=self.device)
        cut = sum((torch.sum(g * g) for g, s in zip(grads, self._sharded) if s), zero)
        rep = sum((torch.sum(g * g) for g, s in zip(grads, self._sharded) if not s), zero)
        first = 1.0 if self.mesh.model_index == 0 else 0.0
        packed = distributed.all_reduce_flat(
            [torch.stack([cut, rep * first] + [v * first for v in values])],
            self.mesh.model_group)[0]
        return torch.cat([packed[2:3], torch.sqrt(packed[:1] + packed[1:2]), packed[3:]])

    def gradients(self, batch: dict, variance_weight: float = 1.0):
        """(loss, metrics, gradients) of a device batch in train mode, at the
        config's matmul precision (dropout masks from the trainer's
        generator; set the config's dropout rates to 0 to turn it off).  On
        a data mesh these are this rank's shares; `global_gradients` sums
        them."""
        self.model.train()
        with matmul_precision(self.cfg.train.matmul_precision):
            return loss_and_grads(self.model, self.cfg, batch, variance_weight, self.generator,
                                  self.group)

    def global_gradients(self, batch: dict, variance_weight: float = 1.0):
        """`gradients` summed over the data mesh's ranks: one all-reduce of
        one flat buffer (the gradients, the loss and the metrics)."""
        loss, metrics, grads = self.gradients(batch, variance_weight)
        if self.group is None:
            return loss, metrics, grads
        packed = torch.stack([loss.detach()] + [v.detach() for v in metrics.values()])
        *grads, packed = distributed.all_reduce_flat(grads + [packed], self.group)
        return packed[0], dict(zip(metrics, packed[1:])), grads

    def train_step(self, batch: dict, variance_weight: float = 1.0) -> dict:
        """One update on a device batch (this rank's rows on a data mesh)."""
        loss, metrics, grads = self.global_gradients(batch, variance_weight)
        return self.apply_gradients(grads, loss, metrics)

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """The plain mel L1 and the pitch + energy MSE, plus the first
        sample's mel pair and the batch's duration predictions (device
        tensors), at the config's matmul precision.  On a data mesh
        ``batch`` is this rank's rows: the losses are summed and the
        duration predictions gathered over the ranks (the first sample is
        rank 0's)."""
        self.model.eval()
        with matmul_precision(self.cfg.train.matmul_precision):
            out, (_, m) = forward_losses(self.model, self.cfg, batch, 1.0, group=self.group)
        val = torch.stack([m["l_mel"], m["l_pitch"] + m["l_energy"]])
        log_dur = out["log_duration_pred"]
        if self.group is not None:
            import torch.distributed as dist

            val = distributed.all_reduce_flat([val], self.group)[0]
            parts = [torch.empty_like(log_dur) for _ in range(self.mesh.data_size)]
            dist.all_gather(parts, log_dur.contiguous(), group=self.group)
            log_dur = torch.cat(parts)
        return {"val_mel": val[0], "val_aux": val[1],
                "mel_pred_0": out["mel_pred"][0], "mel_target_0": batch["mel"][0],
                "mel_len_0": batch["mel_lens"][0], "log_dur_pred": log_dur}

    def train_epoch(self, batches: Iterable[dict]) -> dict:
        """One epoch over numpy batch dicts (loaded ``prefetch_batches``
        ahead).  Returns the last step's metrics and ``train_loss``, the mean
        over applied steps.  Raises RuntimeError when the NaN budget is
        exhausted."""
        tc = self.cfg.train
        vw = 0.0 if self.epoch < tc.warmup_epochs else 1.0
        total, n, last = 0.0, 0, {}
        for batch in prefetch(map(self.local_rows, batches), depth=tc.prefetch_batches):
            m = self.train_step(self.to_device(batch), vw)
            if m["skipped"] > 0.5:
                self.nan_count += 1
                if self.nan_count > tc.max_nan_batches:
                    raise RuntimeError(f"Too many NaN batches ({self.nan_count}). "
                                       "Stopping training.")
                continue
            total += m["loss"]
            n += 1
            last = m
        self.epoch += 1
        return {**last, "train_loss": total / max(n, 1)}

    def validate(self, batches: Iterable[dict], save_plot_epoch: Optional[int] = None) -> float:
        """Mean val mel L1 over the finite batches; the first batch's quality
        numbers go to ``last_quality``.  With ``save_plot_epoch`` the first
        batch's first row is saved as ``<log_dir>/val_{save_plot_epoch}.png``
        (target above prediction; rank 0; needs matplotlib)."""
        tot, n = 0.0, 0
        self.last_quality = {}
        for i, batch in enumerate(batches):
            m = self.eval_step(self.to_device(self.local_rows(batch)))
            v = float(m["val_mel"])
            if math.isfinite(v):
                tot += v
                n += 1
            if i == 0:
                m = {k: t.cpu().numpy() for k, t in m.items()}
                self.last_quality = self._first_batch_quality(m, batch)
                if save_plot_epoch is not None and self.is_main:
                    from spev_tpu_torch.diag.plots import save_comparison_plot

                    L = int(m["mel_len_0"])
                    save_comparison_plot(
                        m["mel_target_0"][:L].T, m["mel_pred_0"][:L].T,
                        os.path.join(self.log_dir, f"val_{save_plot_epoch}.png"))
        return tot / max(n, 1)

    @staticmethod
    def _first_batch_quality(m: dict, batch: dict) -> dict:
        """MCD of the first sample and the teacher-forced duration error of
        the batch's valid phonemes, against the reference's targets (MCD <
        6 dB, duration error < 10 %)."""
        L = int(m["mel_len_0"])
        out = {"val_mcd_db": mel_cepstral_distortion(m["mel_pred_0"][:L], m["mel_target_0"][:L])}
        pred = np.round(np.clip(np.exp(m["log_dur_pred"].astype(np.float32)) - 1.0, 0.0, 500.0))
        tgt = np.asarray(batch["durs"], np.float32)
        mask = tgt > 0
        if mask.any():
            out["val_dur_err_pct"] = duration_error_pct(pred[mask], tgt[mask])
        return out

    def _full_layout(self, include_opt: bool):
        """(model, optimizer or None) in the reference layout on the CPU: the
        shards and AdamW's moments gathered over the model group
        (collective)."""
        names = [n for n, _ in self.model.named_parameters()]
        model = FastSpeech2(self.cfg.model)
        model.load_state_dict(gather_state_dict(self.model.state_dict(), self.mesh))
        if not include_opt:
            return model, None
        opt = torch.optim.AdamW(model.parameters())
        saved = self.optimizer.state_dict()
        moments = {k: gather_state_dict({names[i]: st[k] for i, st in saved["state"].items()},
                                        self.mesh)
                   for k in ("exp_avg", "exp_avg_sq")}
        state = {i: {**st, **{k: moments[k][names[i]] for k in moments}}
                 for i, st in saved["state"].items()}
        opt.load_state_dict({"state": state, "param_groups": saved["param_groups"]})
        return model, opt

    def _shard_moments(self, state: dict) -> dict:
        """An AdamW ``state`` section in the reference layout cut into this
        rank's shards."""
        names = [n for n, _ in self.model.named_parameters()]
        return {i: {k: (shard_state_dict({names[int(i)]: v}, self.mesh)[names[int(i)]]
                        if k in ("exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
                for i, st in state.items()}

    def save(self, name: str = "last", include_opt: bool = True) -> str:
        """``<ckpt_dir>/<name>.spev`` (returned) and, for a model without
        ``advanced``, ``<name>.pt`` beside it; ``include_opt=False`` writes
        the inference checkpoint, without the optimizer.  Only rank 0
        writes; on a model axis every rank takes part in the gathers."""
        model, opt = (self._full_layout(include_opt) if self.mesh.model_size > 1
                      else (self.model, self.optimizer))
        named = list(model.named_parameters())
        path = os.path.join(self.ckpt_dir, f"{name}.spev")
        if not self.is_main:
            return path
        save_spev(path, dict(named), vocab=self.vocab, stats=self.stats,
                  step=self.step, epoch=self.epoch,
                  model_config=model_config_dict(self.cfg.model),
                  optimizer=optax_state(named, opt, self.step) if include_opt else None)
        if model.advanced is None:
            save_checkpoint(os.path.join(self.ckpt_dir, f"{name}.pt"), model,
                            opt if include_opt else None, self.step, self.epoch,
                            self.vocab, self.stats, self.cfg.model)
        return path

    def maybe_save_best(self, val_loss: float) -> bool:
        """``best`` without the optimizer on every improvement."""
        if math.isfinite(val_loss) and val_loss < self.best_val:
            self.best_val = val_loss
            self.save("best", include_opt=False)
            return True
        return False

    def restore(self, path: str) -> None:
        """Weights, step and epoch from a ``.spev`` (the port's or the JAX
        package's) or a ``.pt``.  ``last`` carries the optimizer, so
        training continues exactly; from a checkpoint without it (``best``)
        the optimizer restarts, with a warning, and the warmup continues
        from the saved step."""
        ckpt = read_checkpoint(path)
        self.model.load_state_dict(shard_state_dict(ckpt["model"], self.mesh))
        opt = ckpt.get("optimizer")
        if opt is None:
            warnings.warn(f"{path} has no optimizer state (an inference checkpoint such as "
                          "best): the optimizer restarts; resume from last for exact "
                          "continuation", stacklevel=2)
            self.optimizer = self._new_optimizer()
        else:
            if path.endswith(".spev"):
                names = [n for n, _ in self.model.named_parameters()]
                opt = {"state": adamw_state(opt, names),
                       "param_groups": self.optimizer.state_dict()["param_groups"]}
            if self.mesh.model_size > 1:
                opt = {**opt, "state": self._shard_moments(opt["state"])}
            self.optimizer.load_state_dict(opt)
        self.step = int(ckpt["step_num"])
        self.epoch = int(ckpt["epoch"])
