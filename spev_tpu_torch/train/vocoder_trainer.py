"""HiFi-GAN adversarial training and fine-tuning — counterpart of
``spev_tpu.train.vocoder_trainer``.

Losses of the HiFi-GAN paper, as the JAX package computes them:

    L_D = Σ_k mean((1 − D_k(y))²) + mean(D_k(ŷ)²)       one D pass on [y; ŷ]
    L_G = Σ_k mean((1 − D_k(ŷ))²) + 2·L_FM + 45·L_mel
    L_FM = Σ_k Σ_l mean|f_l(y) − f_l(ŷ)|      (real pass without gradients)
    L_mel = mean|logmel(y) − logmel(ŷ)|       (`ops.stft.log_mel_spectrogram`,
                                              plain and differentiable, fp32)

``|d|`` has derivative +1 at 0, as XLA's (`train.loss.xla_abs`).

- **Optimizers**: one ``torch.optim.AdamW`` per network, lr 2e-4, betas
  (0.8, 0.99), eps 1e-8, weight decay 0.01 on every parameter (optax's
  ``adamw``).  Before each applied update the group's lr is set to optax's
  ``exponential_decay(lr, 1000, 0.999)`` (not staircase) at that
  optimizer's own count of applied updates (`vocoder_lr`).
- **Steps** (`VocoderTrainStep`): ``d_step`` (the generator under
  ``no_grad``; the ``--disc_warmup`` path), ``g_step``, and the fused
  ``dg_step``: one generator forward, D updated on the detached fake, then
  G's loss against the *updated* D through the same forward.  The split
  step is ``d_step`` then ``g_step``.  G's gradients are taken with
  ``torch.autograd.grad`` over the generator's parameters only, so no D
  weight gradient is computed or kept in G's pass.
- **Skipping**: a non-finite loss skips that optimizer's update (moments
  and count unchanged), read on the host once per update; ``step``
  advances only when both updates were applied.
- **Precision**: ``"high"`` runs every product in fp32 (TF32 off);
  ``"default"`` lets cuDNN run the convolutions in TF32, the card's
  single-pass mode, while the mel L1's matmuls stay fp32, as the JAX
  package pins them to ``precision="highest"``.  The process's settings are
  restored after each step.  ``disc_dtype="bf16"`` runs the
  discriminators with bf16 weights and activations (fp32 master weights,
  losses accumulated in fp32).
- **Data parallelism** (``mesh=``, a 'data' axis over a process group):
  every rank gets the same global crop batch and takes its rows.  The
  losses are means over equal shards, so each update's gradients and loss
  are averaged over the ranks in one flat all-reduce (one for D, one for
  G) before the skip test and AdamW, which then agree on every rank.
- **Files**: `save_generator` writes a JAX-layout ``.spev`` generator;
  `save_state` / `load_state` write and read flax's msgpack of ``{gen_params,
  disc_params, gen_opt, disc_opt, step}`` with each ``*_opt`` optax
  ``adamw``'s chain state, so either package resumes the other's file.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.models.hifigan_disc import MPD_PERIODS, Discriminators
from spev_tpu_torch.models.modules import forward_tf32
from spev_tpu_torch.ops.stft import log_mel_spectrogram
from spev_tpu_torch.parallel.distributed import all_reduce_flat
from spev_tpu_torch.parallel.mesh import Mesh, rows_of
from spev_tpu_torch.train.checkpoint import (adamw_chain_from_state, adamw_chain_state,
                                             load_spev, save_spev, state_dict_form,
                                             write_msgpack)
from spev_tpu_torch.train.loss import xla_abs
from spev_tpu_torch.utils import msgpack
from spev_tpu_torch.utils.params import (discriminators_tree_from_state_dict,
                                        hifigan_tree_from_state_dict, state_dict_from_tree,
                                        tree_from_state_dict)
from spev_tpu_torch.utils.platform import resolve_device, tf32

DISC_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class VocoderTrainState:
    """Both networks, their optimizers, ``step`` (steps whose two updates
    were applied) and each optimizer's count of applied updates (the lr
    schedule's position; the two differ after a skip)."""

    generator: HiFiGANGenerator
    discriminators: Discriminators
    gen_opt: torch.optim.AdamW
    disc_opt: torch.optim.AdamW
    step: int = 0
    gen_count: int = 0
    disc_count: int = 0


def make_vocoder_optimizer(params, lr: float = 2e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.8, 0.99), eps=1e-8, weight_decay=0.01)


def vocoder_lr(lr: float, count: int, decay: float = 0.999, decay_every: int = 1000) -> float:
    """optax ``exponential_decay(lr, decay_every, decay)`` at ``count``."""
    return lr * decay ** (count / decay_every)


def init_vocoder_train_state(cfg: HiFiGANConfig, gen_state_dict: Optional[dict] = None,
                             periods: Optional[Sequence[int]] = None, n_scales: int = 3,
                             lr: float = 2e-4, seed: int = 0,
                             device="cuda") -> VocoderTrainState:
    """A fresh state: the generator from ``gen_state_dict`` (fine-tuning,
    the LJ_FT workflow) or `HiFiGANGenerator.random_init`, discriminators
    from `Discriminators.random_init`, both seeded from ``seed``.
    device: "cuda" (the default) raises without a GPU."""
    dev = resolve_device(device)
    gen = HiFiGANGenerator.random_init(cfg, seed=seed)
    if gen_state_dict is not None:
        gen.load_state_dict(gen_state_dict)
    disc = Discriminators.random_init(periods or MPD_PERIODS, n_scales, seed=seed + 1)
    gen.to(dev).train()
    disc.to(dev).train()
    return VocoderTrainState(gen, disc, make_vocoder_optimizer(gen.parameters(), lr),
                             make_vocoder_optimizer(disc.parameters(), lr))


PRECISIONS = ("high", "default")


def step_precision(precision: str):
    """The acoustic trainer's mapping of a mode (`models.modules`) applied to
    the GAN step's model products, which are all cuDNN convolutions:
    ``"high"`` runs them in fp32, ``"default"`` in TF32.  Its only cuBLAS
    products are the mel L1's, which stay fp32 as the JAX package pins them
    to ``precision="highest"``.  Restores the settings on exit."""
    return tf32(matmul=False, cudnn=forward_tf32(precision))


def _apply(opt: torch.optim.AdamW, params, grads, lr: float, count: int) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = vocoder_lr(lr, count)
    opt.step()
    for p in params:
        p.grad = None


class VocoderTrainStep:
    """``step(state, mel (B, F, n_mels), wav (B, F·hop))`` → (state,
    metrics), the state updated in place; metrics are floats ``d_loss``,
    ``g_loss``, ``g_adv``, ``g_fm``, ``g_mel`` and ``skipped``.  ``fused``
    selects `dg_step`, else `d_step` then `g_step`.  ``lr`` must be the one
    the state's optimizers were built with.  With ``mesh`` (a 'data' axis
    over a process group) each call takes this rank's rows of the global
    batch; B must divide by the axis."""

    def __init__(self, cfg: HiFiGANConfig, audio: AudioConfig = AudioConfig(),
                 fm_weight: float = 2.0, mel_weight: float = 45.0, lr: float = 2e-4,
                 fused: bool = False, disc_dtype: Optional[str] = None,
                 precision: str = "high", mesh: Optional[Mesh] = None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
        if disc_dtype is not None and disc_dtype not in DISC_DTYPES:
            raise ValueError(f"disc_dtype must be one of {sorted(DISC_DTYPES)} or None")
        if mesh is not None and mesh.data_size > 1 and mesh.group is None:
            raise UserError(f"a data axis of {mesh.data_size} needs a process group of as many "
                            "ranks (python -m torch.distributed.run)")
        self.mesh = mesh
        self.group = None if mesh is None else mesh.group
        self.cfg, self.audio = cfg, audio
        self.fm_weight, self.mel_weight, self.lr = fm_weight, mel_weight, lr
        self.fused = fused
        self.d_dtype = DISC_DTYPES.get(disc_dtype or "")
        self.precision = precision

    # -- losses --------------------------------------------------------------

    def _log_mel(self, y: torch.Tensor) -> torch.Tensor:
        a = self.audio
        return log_mel_spectrogram(y, sr=a.sample_rate, n_fft=a.n_fft, hop_length=a.hop_length,
                                   n_mels=a.n_mels, fmin=0.0, fmax=a.sample_rate / 2)

    def d_loss(self, disc: Discriminators, real: torch.Tensor,
               fake: torch.Tensor) -> torch.Tensor:
        """One D pass on ``[real; fake]`` (plain convs: no sample mixes
        with another, so it equals two passes)."""
        B = real.shape[0]
        loss = 0.0
        for logits, _ in disc(torch.cat([real, fake]), dtype=self.d_dtype):
            logits = logits.float()
            loss = loss + torch.mean((1.0 - logits[:B]) ** 2) + torch.mean(logits[B:] ** 2)
        return loss

    def g_loss_from_fake(self, fake: torch.Tensor, disc: Discriminators,
                         real: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """G's loss given the generator's output; the real passes (D and
        log-mel) carry no gradient."""
        with torch.no_grad():
            outs_r = disc(real, dtype=self.d_dtype)
            mel_r = self._log_mel(real)
        outs_f = disc(fake, dtype=self.d_dtype)
        adv = fm = 0.0
        for (_, fr), (lf, ff) in zip(outs_r, outs_f):
            adv = adv + torch.mean((1.0 - lf.float()) ** 2)
            for a, b in zip(fr, ff):
                # subtract at the compute dtype, accumulate in fp32
                fm = fm + torch.mean(xla_abs(a - b).float())
        mel_l1 = torch.mean(xla_abs(mel_r - self._log_mel(fake)))
        total = adv + self.fm_weight * fm + self.mel_weight * mel_l1
        return total, {"g_adv": adv, "g_fm": fm, "g_mel": mel_l1}

    # -- updates -------------------------------------------------------------

    def _rows(self, mel, wav):
        """This rank's rows of a global batch (all of it without a group)."""
        if self.group is None:
            return mel, wav
        local = rows_of({"mel": mel, "wav": wav}, self.mesh.data_index, self.mesh.data_size)
        return local["mel"], local["wav"]

    def _mean_over_ranks(self, grads, values: torch.Tensor):
        """Gradients and loss values averaged over the group's ranks."""
        if self.group is None:
            return grads, values
        *grads, values = all_reduce_flat(list(grads) + [values], self.group, op="mean")
        return grads, values

    def _update_d(self, state: VocoderTrainState, real, fake) -> Tuple[float, bool]:
        params = list(state.discriminators.parameters())
        loss = self.d_loss(state.discriminators, real, fake)
        grads, vals = self._mean_over_ranks(torch.autograd.grad(loss, params),
                                            loss.detach().reshape(1))
        val = vals.item()
        ok = math.isfinite(val)
        if ok:
            _apply(state.disc_opt, params, grads, self.lr, state.disc_count)
            state.disc_count += 1
        return val, ok

    def _update_g(self, state: VocoderTrainState, fake, real) -> Tuple[float, dict, bool]:
        params = list(state.generator.parameters())
        loss, aux = self.g_loss_from_fake(fake, state.discriminators, real)
        grads, vals = self._mean_over_ranks(
            torch.autograd.grad(loss, params),
            torch.stack([loss.detach()] + [v.detach() for v in aux.values()]))
        vals = vals.tolist()
        ok = math.isfinite(vals[0])
        if ok:
            _apply(state.gen_opt, params, grads, self.lr, state.gen_count)
            state.gen_count += 1
        return vals[0], dict(zip(aux, vals[1:])), ok

    def d_step(self, state: VocoderTrainState, mel, wav) -> Tuple[VocoderTrainState, float, bool]:
        """D's update alone; the generator runs under ``no_grad`` and comes
        through bit for bit."""
        return self._d_step(state, *self._rows(mel, wav))

    def _d_step(self, state, mel, wav):
        with step_precision(self.precision):
            with torch.no_grad():
                fake = state.generator(mel)
            d_loss, ok = self._update_d(state, wav, fake)
        return state, d_loss, ok

    def g_step(self, state: VocoderTrainState, mel, wav):
        """G's update against the current D → (state, g_loss, aux, ok)."""
        return self._g_step(state, *self._rows(mel, wav))

    def _g_step(self, state, mel, wav):
        with step_precision(self.precision):
            fake = state.generator(mel)
            g_loss, aux, ok = self._update_g(state, fake, wav)
        return state, g_loss, aux, ok

    def dg_step(self, state: VocoderTrainState, mel, wav) -> Tuple[VocoderTrainState, dict]:
        """One generator forward: D updates on the detached fake (its
        in-place update leaves G's graph intact: D's loss never saw it), then
        G's loss runs a fresh D forward with the updated weights."""
        return self._dg_step(state, *self._rows(mel, wav))

    def _dg_step(self, state, mel, wav):
        with step_precision(self.precision):
            fake = state.generator(mel)
            d_loss, d_ok = self._update_d(state, wav, fake.detach())
            g_loss, aux, g_ok = self._update_g(state, fake, wav)
        return self._finish(state, d_loss, g_loss, aux, d_ok and g_ok)

    def _finish(self, state, d_loss, g_loss, aux, ok):
        state.step += int(ok)
        return state, {"d_loss": d_loss, "g_loss": g_loss, "skipped": 0.0 if ok else 1.0, **aux}

    def __call__(self, state: VocoderTrainState, mel, wav) -> Tuple[VocoderTrainState, dict]:
        mel, wav = self._rows(mel, wav)
        if self.fused:
            return self._dg_step(state, mel, wav)
        state, d_loss, d_ok = self._d_step(state, mel, wav)
        state, g_loss, aux, g_ok = self._g_step(state, mel, wav)
        return self._finish(state, d_loss, g_loss, aux, d_ok and g_ok)


# the JAX package's name for the step factory
make_vocoder_train_step = VocoderTrainStep


# -- files ---------------------------------------------------------------------


def save_generator(path: str, state: VocoderTrainState, cfg: HiFiGANConfig) -> None:
    """The generator as a JAX-layout ``.spev`` (the JAX package's
    ``load_params`` and the port's `load_generator` read it)."""
    save_spev(path, hifigan_tree_from_state_dict(state.generator.state_dict()), vocab=None,
              stats=None, step=state.step,
              model_config={"hifigan": True, "resblock": cfg.resblock,
                            "upsample_rates": list(cfg.upsample_rates)})


def load_generator(path: str, cfg: HiFiGANConfig) -> HiFiGANGenerator:
    """A ``gen_*.spev`` (either package's) as a generator of ``cfg`` on the CPU."""
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(state_dict_from_tree(load_spev(path)["model"]))
    return gen.eval()


def _chain(module: torch.nn.Module, opt, count: int) -> dict:
    return adamw_chain_state(list(module.named_parameters()), opt, count, tree_from_state_dict)


def save_state(path: str, state: VocoderTrainState) -> None:
    """The whole GAN state (both networks, both optimizers, ``step``) as
    flax's msgpack of the JAX package's ``VocoderTrainState``."""
    tree = {
        "gen_params": hifigan_tree_from_state_dict(state.generator.state_dict()),
        "disc_params": discriminators_tree_from_state_dict(state.discriminators.state_dict()),
        "gen_opt": _chain(state.generator, state.gen_opt, state.gen_count),
        "disc_opt": _chain(state.discriminators, state.disc_opt, state.disc_count),
        "step": np.asarray(state.step, np.int32),
    }
    write_msgpack(path, state_dict_form(tree))


def load_state(path: str, template: VocoderTrainState) -> VocoderTrainState:
    """Restore a `save_state` file (the port's or the JAX package's) into
    ``template``, built with the same ``--config``/``--periods``/``--scales``;
    a mismatch raises a `UserError` naming the differing parameters."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        raw = msgpack.restore(data)
    except msgpack.MsgpackError as e:
        raise UserError(f"{path}: not a vocoder train state ({e})") from None
    keys = {"gen_params", "disc_params", "gen_opt", "disc_opt", "step"}
    if not isinstance(raw, dict) or set(raw) != keys:
        raise UserError(f"{path}: not a vocoder train state (keys "
                        f"{sorted(raw) if isinstance(raw, dict) else type(raw).__name__})")
    counts = []
    for net, opt, params, opt_key in (
            (template.generator, template.gen_opt, "gen_params", "gen_opt"),
            (template.discriminators, template.disc_opt, "disc_params", "disc_opt")):
        sd = state_dict_from_tree(raw[params])
        names = [n for n, _ in net.named_parameters()]
        diff = sorted(set(sd) ^ set(net.state_dict()))
        if diff:
            raise UserError(f"{path}: {params} does not match this configuration "
                            f"(differing parameters: {diff[:5]})")
        net.load_state_dict(sd)
        moments, count = adamw_chain_from_state(raw[opt_key], names, state_dict_from_tree)
        opt.load_state_dict({"state": moments,
                             "param_groups": opt.state_dict()["param_groups"]})
        counts.append(count)
    template.gen_count, template.disc_count = counts
    template.step = int(np.asarray(raw["step"]))
    return template
