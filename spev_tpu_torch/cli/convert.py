"""Checkpoint conversion: reference ``.pt`` ↔ ``.spev`` (the JAX package's
format), counterpart of ``spev_tpu.cli.convert``.

    python -m spev_tpu_torch.cli.convert to-spev best.pt   best.spev
    python -m spev_tpu_torch.cli.convert to-pt   best.spev best.pt
    python -m spev_tpu_torch.cli.convert info    best.pt
    python -m spev_tpu_torch.cli.convert cache   cache_stable/ cache_spev/
    python -m spev_tpu_torch.cli.convert cache   proper_cache_strict.pt cache_spev/

``to-spev`` keeps the model weights, vocab, stats, step and epoch (and the
model config when the ``.pt`` carries one).  ``to-pt`` writes the reference
schema ``{'model', 'vocab', 'stats', 'step_num', 'epoch'}`` with the
reference key set: the ``nasal_*`` and ``advanced.*`` groups, which that
schema has no place for, are left out and named on stderr.  ``cache``
imports the reference's feature cache (a ``u_*.pt`` directory or a
monolithic ``.pt``) into the npz cache the trainers read
(`data.cache_import`).

It only reads and writes files, on the CPU, so it takes no ``--device``.
Errors caused by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import os
import sys

from spev_tpu_torch.errors import UserError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("to-spev", "to-pt"):
        c = sub.add_parser(name)
        c.add_argument("src")
        c.add_argument("dst")
    i = sub.add_parser("info")
    i.add_argument("src")
    c = sub.add_parser("cache")
    c.add_argument("src", help="reference cache dir (u_*.pt + metadata.json) or monolithic .pt")
    c.add_argument("dst", help="output cache dir")
    return p


def _run(args) -> None:
    import torch

    from spev_tpu_torch.train.checkpoint import save_spev
    from spev_tpu_torch.utils.params import read_checkpoint, unpack_checkpoint

    if args.cmd == "cache":
        from spev_tpu_torch.data.cache_import import (import_monolithic_cache,
                                                      import_reference_cache)

        if os.path.isdir(args.src):
            meta = import_reference_cache(args.src, args.dst)
        else:
            meta = import_monolithic_cache(args.src, args.dst)
        print(f"imported {len(meta['files'])} utterances into {args.dst} "
              f"(vocab {len(meta['vocab'])})")
        return
    ckpt = read_checkpoint(args.src)
    sd, vocab, stats = unpack_checkpoint(ckpt)
    step, epoch = int(ckpt.get("step_num", 0)), int(ckpt.get("epoch", 0))
    if args.cmd == "to-spev":
        save_spev(args.dst, sd, vocab=vocab, stats=stats, step=step, epoch=epoch,
                  model_config=ckpt.get("model_config"))
        print(f"wrote {args.dst} (vocab {len(vocab)}, step {step}, epoch {epoch})")
    elif args.cmd == "to-pt":
        extra = ("nasal_", "advanced.")
        dropped = sorted({k.split(".")[0] for k in sd if k.startswith(extra)})
        if dropped:
            print(f"to-pt: the reference schema has no place for {', '.join(dropped)}; "
                  "left out", file=sys.stderr)
        model = {k: v for k, v in sd.items() if not k.startswith(extra)}
        torch.save({"model": model, "vocab": list(vocab), "stats": dict(stats),
                    "step_num": step, "epoch": epoch}, args.dst)
        print(f"wrote {args.dst}")
    else:
        n_params = sum(int(v.numel()) for v in sd.values())
        print(f"format: {'spev' if args.src.endswith('.spev') else 'torch .pt'}")
        print(f"parameters: {n_params:,}")
        print(f"vocab: {len(vocab)} symbols")
        print(f"stats: {stats}")
        print(f"step: {step}  epoch: {epoch}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        _run(args)
    except (UserError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
