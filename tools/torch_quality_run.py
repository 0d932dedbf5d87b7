"""Full-width acoustic training on the offline formant corpus, scored on its
held-out split: the port's counterpart of ``tools/quality256_run.py``
(phases ``corpus``, ``train`` and ``eval``, with its recipe), on the card.

- ``corpus``: 480 formant utterances (`data.synthetic`, seed 0) and their
  feature cache, built on the device (kernel K2 for the log-mels).
- ``train``: the default acoustic model (hidden 256, 4+4 FFT blocks) with
  per-phoneme predictors (``vp_output_norm=False``), one phoneme bucket of
  32 and one frame bucket of 256, B=16, lr 1e-3, ``warmup_steps`` 500,
  ``warmup_epochs`` 2, a 90/10 split, validation every 5 epochs, ``best``
  on every improvement; fp32 (TF32 off), kernels K1 forward and K1b
  backward.
- ``eval``: teacher-forced `evaluate_checkpoint` of ``best.spev`` on the
  held-out utterances (MCD, duration error, F0 RMSE).

The JAX package's ``score`` phase needs a 60k-step GAN and is not here.
Each phase skips itself when its output exists under ``--work``.

    python tools/torch_quality_run.py corpus train eval [--work .scratch/q256] \\
        [--epochs 300] [--summary out.json] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_UTTS = 480
VAL_FRAC = 0.1
SEED = 0
BUCKETS = dict(phoneme_buckets=(32,), frame_buckets=(256,))


def build_dataset(work: str, device):
    from spev_tpu_torch.data.dataset import SpevDataset

    root = os.path.join(work, "corpus")
    return SpevDataset(root, textgrid_dir=os.path.join(root, "textgrids"),
                       cache_dir=os.path.join(work, "cache"), g2p_backend="rules",
                       stats_sample=120, device=device)


def phase_corpus(work: str, device) -> dict:
    if os.path.exists(os.path.join(work, "cache", "metadata.json")):
        print("[corpus] cache exists, skipping", flush=True)
        return {}
    from spev_tpu_torch.data.synthetic import generate_formant_corpus
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel

    t0 = time.time()
    generate_formant_corpus(os.path.join(work, "corpus"), n_utterances=N_UTTS, seed=SEED)
    t1 = time.time()
    k2 = fused_log_mel.launches
    build_dataset(work, device)
    out = {"corpus_s": t1 - t0, "cache_build_s": time.time() - t1,
           "k2_launches": fused_log_mel.launches - k2}
    print(f"[corpus] {N_UTTS} utterances in {out['corpus_s']:.1f} s, cache in "
          f"{out['cache_build_s']:.1f} s ({out['k2_launches']} K2 launches)", flush=True)
    return out


def make_cfg(vocab_size: int, epochs: int, lr: float, warmup_steps: int):
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig

    return SpevConfig(
        model=ModelConfig(vocab_size=vocab_size, max_frames=256, vp_output_norm=False),
        train=TrainConfig(batch_size=16, warmup_steps=warmup_steps, epochs=epochs,
                          warmup_epochs=2, learning_rate=lr, val_fraction=VAL_FRAC))


def phase_train(work: str, epochs: int, lr: float, warmup_steps: int, device) -> dict:
    done = os.path.join(work, "train_done.json")
    if os.path.exists(done):
        print("[train] already done, skipping", flush=True)
        with open(done) as f:
            return json.load(f)
    import torch

    from spev_tpu_torch.data.batching import BucketBatcher, train_val_split
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    ds = build_dataset(work, device)
    vocab = Vocab(ds.vocab)
    cfg = make_cfg(len(vocab), epochs, lr, warmup_steps)
    tr_idx, va_idx = train_val_split(len(ds), VAL_FRAC, seed=SEED)
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(work, "ck"),
                      log_dir=os.path.join(work, "logs"), device=device)
    bt = BucketBatcher(ds, vocab, batch_size=16, indices=tr_idx, **BUCKETS)
    bv = BucketBatcher(ds, vocab, batch_size=16, indices=va_idx, **BUCKETS)
    launches0 = (lr_fused.launches, lr_fused_bwd.launches)
    t0, rows, train_s = time.time(), [], 0.0
    with open(os.path.join(work, "train_log.jsonl"), "a") as log:
        for epoch in range(epochs):
            te = time.time()
            m = trainer.train_epoch(bt.epoch(epoch))
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            train_s += time.time() - te
            if epoch % 5 == 0 or epoch == epochs - 1:
                val = trainer.validate(bv.epoch(0))
                trainer.maybe_save_best(val)
                q = trainer.last_quality
                row = {"epoch": epoch, "loss": float(m["train_loss"]), "val": float(val),
                       "mcd": float(q.get("val_mcd_db", float("nan"))),
                       "durerr": float(q.get("val_dur_err_pct", float("nan"))),
                       "step": trainer.step, "wall_s": time.time() - t0}
                rows.append(row)
                log.write(json.dumps(row) + "\n")
                log.flush()
                print(row, flush=True)
            if epoch and epoch % 100 == 0:
                trainer.save("last")
    trainer.save("last")
    out = {"epochs": epochs, "steps": trainer.step, "train_wall_s": time.time() - t0,
           "mean_step_ms": 1000.0 * train_s / max(trainer.step, 1),
           "k1_launches": lr_fused.launches - launches0[0],
           "k1b_launches": lr_fused_bwd.launches - launches0[1],
           "first": rows[0], "last": rows[-1], "best_val": trainer.best_val}
    with open(done, "w") as f:
        json.dump(out, f)
    print(f"[train] {out['steps']} steps in {out['train_wall_s']:.1f} s "
          f"({out['mean_step_ms']:.2f} ms a step)", flush=True)
    return out


def phase_eval(work: str, device) -> dict:
    path = os.path.join(work, "eval_tf.json")
    if not os.path.exists(path):
        from spev_tpu_torch.data.batching import train_val_split
        from spev_tpu_torch.infer.evaluate import evaluate_checkpoint

        ds = build_dataset(work, device)
        _, va_idx = train_val_split(len(ds), VAL_FRAC, seed=SEED)
        res = evaluate_checkpoint(os.path.join(work, "ck", "best.spev"), ds, indices=va_idx,
                                  batch_size=16, device=device, **BUCKETS)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    with open(path) as f:
        agg = json.load(f)["aggregate"]
    print("[eval] aggregate:", json.dumps(agg), flush=True)
    return agg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_quality_run.py")
    ap.add_argument("phases", nargs="+", choices=["corpus", "train", "eval"])
    ap.add_argument("--work", default=".scratch/q256",
                    help="corpus, cache, checkpoints and logs (relative to the working directory)")
    ap.add_argument("--epochs", type=int, default=300,
                    help="the JAX package's documented run took 300")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup_steps", type=int, default=500)
    ap.add_argument("--summary", default=None, help="write the phases' results here as JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from spev_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.work, exist_ok=True)
    summary = {"device": str(dev)}
    if dev.type == "cuda":
        import torch

        summary["card"] = torch.cuda.get_device_name(dev)
    for ph in args.phases:
        if ph == "corpus":
            summary["corpus"] = phase_corpus(args.work, dev)
        elif ph == "train":
            summary["train"] = phase_train(args.work, args.epochs, args.lr,
                                           args.warmup_steps, dev)
        else:
            summary["eval"] = phase_eval(args.work, dev)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)), exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
