"""The formant-corpus quality gate trained by both packages side by side on
the CPU: the JAX package's ``Trainer`` and the port's, from JAX's seeded
weights, on one feature cache.

`build_pair` generates the formant corpus (seed 0), builds its cache once
with the JAX package and opens it with both packages, so both batchers
give the same numpy batches; it builds both trainers as the gate does
(``tools/demo_common.py``; `spev_tpu_torch.diag.convergence.trainer_setup`)
with the dropout rates and the matmul precision given, and loads JAX's
initial parameters into the port's model.  `run_pair` trains both an epoch
at a time and reads each side's dashboard: train loss, val loss, val MCD
and duration error, plus the largest gaps between the two parameter sets.
`run_synced` follows JAX's trajectory and sets the port to JAX's state
before every step and validation, so each step is compared from one state;
`port_control` pairs the port with itself from weights one unit in the
last place apart.

`run_gate` is one side's gate as it stands (dropout on, the trainer's
default precision) at a given ``TrainConfig.seed``, on a cache built by
that side, for the seeded runs.  JAX's ``Trainer`` takes its seed as an
argument (it does not read ``TrainConfig.seed``), so both are set.

    python tests/_torch_gate_pair.py pair|synced|control [--epochs 45] [--n 120] [--out F]
    python tests/_torch_gate_pair.py seeds --side jax|port [--seeds 0,1,2,3,4] [--out F]

Each prints a JSON line an epoch (pair) or a run (seeds), and writes them
all to ``--out``.  Run from the repository root with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from spev_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from spev_tpu.config import SpevConfig as JaxSpevConfig  # noqa: E402
from spev_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from spev_tpu.data.batching import BucketBatcher as JaxBatcher  # noqa: E402
from spev_tpu.data.batching import train_val_split as jax_split  # noqa: E402
from spev_tpu.data.dataset import SpevDataset as JaxDataset  # noqa: E402
from spev_tpu.data.synthetic import generate_formant_corpus  # noqa: E402
from spev_tpu.parallel.mesh import replicated  # noqa: E402
from spev_tpu.text.vocab import Vocab as JaxVocab  # noqa: E402
from spev_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from spev_tpu_torch.data.dataset import SpevDataset  # noqa: E402
from spev_tpu_torch.diag import convergence as cv  # noqa: E402
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree  # noqa: E402

KEYS = ("loss", "val", "mcd", "durerr")


def _jax_setup(ds, epochs, work, *, seed=0, dropout=None, precision=None, hidden=96,
               **model_kw):
    """``tools/demo_common.py``'s trainer and batchers on a built JAX
    dataset; ``dropout`` sets both rates, ``precision`` the matmul mode,
    ``hidden`` the embed and hidden widths, ``model_kw`` other model
    fields."""
    vocab = JaxVocab(ds.vocab)
    if dropout is not None:
        model_kw.update(dropout=dropout, vp_dropout=dropout)
    train_kw = {} if precision is None else dict(matmul_precision=precision)
    cfg = JaxSpevConfig(
        model=JaxModelConfig(vocab_size=len(vocab), embed_dim=hidden, hidden_dim=hidden,
                             n_mels=80, max_phonemes=32, max_frames=256, vp_output_norm=False, **model_kw),
        train=JaxTrainConfig(batch_size=16, warmup_steps=50, epochs=epochs, warmup_epochs=2,
                             learning_rate=2e-3, seed=seed, **train_kw))
    tr_idx, va_idx = jax_split(len(ds), 0.1, seed=0)
    trainer = JaxTrainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(work, "jax_ck"),
                         log_dir=os.path.join(work, "jax_logs"), seed=seed)
    # the state placed as the step returns it, so that the first step's
    # compiled program serves the later ones (the values are unchanged)
    trainer.state = jax.device_put(trainer.state, replicated(trainer.mesh))
    kw = dict(batch_size=16, phoneme_buckets=(32,), frame_buckets=(256,))
    return SimpleNamespace(ds=ds, vocab=vocab, cfg=cfg, trainer=trainer, va_idx=va_idx,
                           bt=JaxBatcher(ds, vocab, indices=tr_idx, **kw),
                           bv=JaxBatcher(ds, vocab, indices=va_idx, **kw))


def _corpus(n_utterances, work):
    root, cache = os.path.join(work, "corpus"), os.path.join(work, "cache")
    tg = generate_formant_corpus(root, n_utterances=n_utterances, seed=0)
    return root, tg, cache


def jax_params_as_state_dict(trainer) -> dict:
    return fastspeech2_state_dict_from_tree(jax.tree.map(np.asarray, trainer.state.params))


def state_dict(trainer) -> dict:
    """Either package's trainer's parameters in the port's naming."""
    if hasattr(trainer, "model"):
        return trainer.model.state_dict()
    return jax_params_as_state_dict(trainer)


def build_pair(n_utterances=120, epochs=45, work=None, dropout=0.0, precision="highest",
               cache_by="jax", hidden=96, **model_kw):
    """Both trainers on one cache (built by ``cache_by``, "jax" or "port"),
    the port's from JAX's initial weights; ``hidden`` and ``model_kw``
    narrow both models.  Returns (jax_setup, port_setup)."""
    work = work or tempfile.mkdtemp(prefix="spev_pair_")
    root, tg, cache = _corpus(n_utterances, work)
    kw = dict(textgrid_dir=tg, cache_dir=cache, g2p_backend="rules", stats_sample=60)
    if cache_by == "port":
        SpevDataset(root, device="cpu", **kw)
    ref = _jax_setup(JaxDataset(root, **kw), epochs, work, dropout=dropout, precision=precision,
                     hidden=hidden, **model_kw)
    ds = SpevDataset(root, device="cpu", **kw)
    port = cv.trainer_setup(ds, epochs, work, "cpu", hidden=hidden, dropout=dropout,
                            vp_dropout=dropout, **model_kw)
    _set_precision(port, precision)
    port.trainer.model.load_state_dict(jax_params_as_state_dict(ref.trainer))
    return ref, port


def _free(name: str, p: torch.Tensor) -> torch.Tensor:
    """``p`` without the attention's key bias (the middle third of
    ``in_proj_bias``): the softmax ignores a shift of every key, so its
    gradient is rounding noise, which Adam's eps of 1e-9 turns into steps
    of +-lr in either package."""
    if name.endswith("attention.in_proj_bias"):
        h = p.shape[0] // 3
        return torch.cat([p[:h], p[2 * h:]])
    return p


def _set_precision(port, precision):
    """The port trainer's matmul mode (read at every step and validation)."""
    port.cfg = port.trainer.cfg = dataclasses.replace(
        port.cfg, train=dataclasses.replace(port.cfg.train, matmul_precision=precision))


def param_gaps(ref, port) -> dict:
    """For every parameter (the key biases left out, `_free`), the largest
    |port - ref| relative to its largest |ref| value."""
    theirs = state_dict(ref.trainer)
    gaps = {}
    for name, p in state_dict(port.trainer).items():
        a, b = _free(name, p), _free(name, theirs[name])
        gaps[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return gaps


def _row(trainer, m, val) -> dict:
    q = trainer.last_quality
    return {"loss": float(m["train_loss"]), "val": float(val),
            "mcd": float(q.get("val_mcd_db", math.nan)),
            "durerr": float(q.get("val_dur_err_pct", math.nan))}


def rel_gap(a: float, b: float) -> float:
    """|a - b| relative to |b| (0 when both are NaN)."""
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def run_pair(ref, port, epochs, on_epoch=None) -> list:
    """``epochs`` of both trainers, each epoch followed by each side's
    validation; one row an epoch: each side's readings, their relative
    gaps and the parameter gap."""
    rows = []
    for epoch in range(epochs):
        jb, pb = list(ref.bt.epoch(epoch)), list(port.bt.epoch(epoch))
        assert len(jb) == len(pb) and all(
            np.array_equal(a[k], b[k]) for a, b in zip(jb, pb) for k in a), epoch
        jm = ref.trainer.train_epoch(iter(jb))
        jv = ref.trainer.validate(ref.bv.epoch(0))
        pm = port.trainer.train_epoch(iter(pb))
        pv = port.trainer.validate(port.bv.epoch(0))
        j, p = _row(ref.trainer, jm, jv), _row(port.trainer, pm, pv)
        gaps = sorted(param_gaps(ref, port).items(), key=lambda kv: -kv[1])
        rows.append({"epoch": epoch, "jax": j, "port": p,
                     "gap": {k: rel_gap(p[k], j[k]) for k in KEYS},
                     "param_gap": dict(gaps[:3])})
        if on_epoch is not None:
            on_epoch(rows[-1])
    return rows


def port_control(port, work):
    """A second port trainer on ``port``'s batchers, its weights ``port``'s
    moved by one unit in the last place each, up or down at random (seed
    0; zeros stay zero): how far the port's own rounding carries in this
    recipe."""
    twin = cv.trainer_setup(port.ds, port.cfg.train.epochs, os.path.join(work, "twin"), "cpu",
                            hidden=port.cfg.model.hidden_dim, dropout=port.cfg.model.dropout, vp_dropout=port.cfg.model.vp_dropout)
    _set_precision(twin, port.cfg.train.matmul_precision)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p, q in zip(twin.trainer.model.parameters(), port.trainer.model.parameters()):
            up = torch.rand(q.shape, generator=g) < 0.5
            moved = torch.nextafter(q, torch.where(up, math.inf, -math.inf))
            p.copy_(torch.where(q == 0, q, moved))
    return twin


def sync_port(ref, port) -> None:
    """The port's parameters, AdamW moments and step set to JAX's."""
    from flax import serialization

    from spev_tpu_torch.train.checkpoint import adamw_state

    tr = port.trainer
    tr.model.load_state_dict(jax_params_as_state_dict(ref.trainer))
    opt = serialization.to_state_dict(jax.tree.map(np.asarray, ref.trainer.state.opt_state))
    names = [n for n, _ in tr.model.named_parameters()]
    tr.optimizer.load_state_dict({"state": adamw_state(opt, names),
                                  "param_groups": tr.optimizer.state_dict()["param_groups"]})
    tr.step = int(ref.trainer.state.step)


def run_synced(ref, port, epochs, on_epoch=None) -> list:
    """JAX's trajectory, with the port set to JAX's state (`sync_port`)
    before every step and every validation: each step's loss and the
    parameters after it, and each validation's readings, compared.  One row
    an epoch with the largest relative gaps of its steps and its
    validation."""
    rows = []
    jt, pt = ref.trainer, port.trainer
    for epoch in range(epochs):
        vw = 0.0 if jt.epoch < jt.cfg.train.warmup_epochs else 1.0
        loss_gap = step_gap = 0.0
        for batch in ref.bt.epoch(epoch):
            sync_port(ref, port)
            jt.state, jm = jt._get_step(vw, batch)(jt.state, batch, jax.random.PRNGKey(0))
            pm = pt.train_step(pt.to_device(batch), vw)
            loss_gap = max(loss_gap, rel_gap(pm["loss"], float(jm["loss"])))
            step_gap = max(step_gap, max(param_gaps(ref, port).values()))
        jt.epoch += 1
        pt.epoch += 1
        sync_port(ref, port)
        j = _row(jt, {"train_loss": math.nan}, jt.validate(ref.bv.epoch(0)))
        p = _row(pt, {"train_loss": math.nan}, pt.validate(port.bv.epoch(0)))
        rows.append({"epoch": epoch, "step_loss_gap": loss_gap, "step_param_gap": step_gap,
                     "jax": j, "port": p,
                     "gap": {k: rel_gap(p[k], j[k]) for k in ("val", "mcd", "durerr")}})
        if on_epoch is not None:
            on_epoch(rows[-1])
    return rows


def run_gate(side, seed, cache_work, epochs=45, n_utterances=120) -> dict:
    """One side's gate at ``TrainConfig.seed`` ``seed`` (dropout and
    precision as the gate has them) on the cache under ``cache_work``
    (built by that side on first use): `convergence.gate_summary`."""
    root, tg, cache = os.path.join(cache_work, "corpus"), None, os.path.join(cache_work, "cache")
    if not os.path.exists(os.path.join(cache, "metadata.json")):
        root, tg, cache = _corpus(n_utterances, cache_work)
    work = tempfile.mkdtemp(prefix=f"spev_gate_{side}{seed}_")
    if side == "jax":
        ds = JaxDataset(root, textgrid_dir=tg, cache_dir=cache, g2p_backend="rules",
                        stats_sample=60)
        s = _jax_setup(ds, epochs, work, seed=seed)
        saved = dict(os.environ)
        try:
            from tools.gate_calibration import freerun_frame_errors
        finally:
            os.environ.clear()
            os.environ.update(saved)
        hist = cv.run_dashboard(s, epochs)
        errs = freerun_frame_errors(s.trainer, s.ds, s.vocab, s.cfg, s.va_idx)
    else:
        ds = SpevDataset(root, textgrid_dir=tg, cache_dir=cache, g2p_backend="rules",
                         stats_sample=60, device="cpu")
        s = cv.trainer_setup(ds, epochs, work, "cpu", seed=seed)
        hist = cv.run_dashboard(s, epochs)
        errs = cv.freerun_frame_errors(s.trainer, s.ds, s.vocab, s.cfg, s.va_idx, device="cpu")
    summary = cv.gate_summary(hist, errs, epochs, 1.0)
    return {"side": side, "seed": seed, **summary,
            "failures": [f.split(":")[0] for f in cv.gate_failures(summary)],
            "mcd": [h["mcd"] for h in hist]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["pair", "synced", "control", "seeds"])
    ap.add_argument("--epochs", type=int, default=45)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--side", choices=["jax", "port"])
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--work", default=None)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    out = []

    def emit(row):
        out.append(row)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(out, f, indent=1)

    if a.what in ("pair", "synced", "control"):
        work = a.work or tempfile.mkdtemp(prefix="spev_pair_")
        ref, port = build_pair(a.n, a.epochs, work)
        if a.what == "pair":
            run_pair(ref, port, a.epochs, on_epoch=emit)
        elif a.what == "synced":
            run_synced(ref, port, a.epochs, on_epoch=emit)
        else:
            run_pair(port, port_control(port, work), a.epochs, on_epoch=emit)
    else:
        work = a.work or tempfile.mkdtemp(prefix=f"spev_seeds_{a.side}_")
        for seed in (int(s) for s in a.seeds.split(",")):
            emit(run_gate(a.side, seed, work, a.epochs, a.n))


if __name__ == "__main__":
    main()
