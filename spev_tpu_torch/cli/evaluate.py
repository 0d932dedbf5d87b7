"""Checkpoint quality over a corpus, on the card (or the CPU):

    python -m spev_tpu_torch.cli.evaluate --checkpoint best.spev --data_dir corpus \
        [--textgrid_dir DIR] [--cache_dir cache_spev] [--split val|train|all] \
        [--val_frac 0.05] [--seed 0] [--batch_size 8] [--vocoder DIR|gen.spev] \
        [--json out.json] [--device cuda]

Counterpart of ``spev-eval`` (``spev_tpu.cli.evaluate``): the same flags,
plus ``--device``.  It scores `infer.evaluate.evaluate_checkpoint` against
the reference's targets (MCD < 6 dB, duration error < 10 %, F0 RMSE < 20
Hz).  ``--split val`` is the trainer's 95/5 split with the same seed, so a
model is scored on utterances its training never saw.  The feature cache is
read when ``--cache_dir`` holds one, else built from ``--data_dir`` on the
device.  Errors caused by the input exit with status 2 and one ``error:``
line.
"""

from __future__ import annotations

import argparse
import json
import sys

from spev_tpu_torch.cli.common import add_cache_flags, cli_guard
from spev_tpu_torch.errors import UserError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.evaluate")
    p.add_argument("--checkpoint", required=True, help=".spev or .pt")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--textgrid_dir", default=None)
    p.add_argument("--split", default="val", choices=["val", "train", "all"])
    p.add_argument("--val_frac", type=float, default=0.05,
                   help="the trainer's split fraction (reference 95/5)")
    p.add_argument("--seed", type=int, default=0, help="split seed")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--g2p", default="auto")
    p.add_argument("--multi_speaker", action="store_true",
                   help="speaker labels from file-name prefixes, so a multi-speaker "
                        "checkpoint is scored with its speaker conditioning")
    p.add_argument("--vocoder", default=None,
                   help="also score the serving condition: vocode each teacher-forced mel "
                        "and score its re-extracted log-mel.  An upstream HiFi-GAN "
                        "directory (config.json + g_*) or a gen_*.spev (with --gen_config)")
    p.add_argument("--gen_config", default="v3", choices=["v1", "v3"],
                   help="generator architecture of a gen_*.spev --vocoder")
    p.add_argument("--json", default=None, help="also write the full result here")
    p.add_argument("--device", default="cuda")
    add_cache_flags(p)
    return p


def _vocoder(path: str, gen_config: str, device):
    from spev_tpu_torch.infer.vocoder import Vocoder

    if not path.endswith(".spev"):
        return Vocoder(path, device=device)
    from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from spev_tpu_torch.train.checkpoint import load_params
    from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree

    tree, _, _ = load_params(path)
    cfg = HiFiGANConfig() if gen_config == "v1" else HiFiGANConfig.v3()
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(hifigan_state_dict_from_tree(tree, cfg))
    return Vocoder(generator=gen, device=device)


@cli_guard
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from spev_tpu_torch.data.batching import train_val_split
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.infer.evaluate import evaluate_checkpoint

    ds = SpevDataset(args.data_dir, textgrid_dir=args.textgrid_dir, cache_dir=args.cache_dir,
                     g2p_backend=args.g2p, force_rebuild=args.force_rebuild,
                     multi_speaker=args.multi_speaker, device=args.device)
    if args.split == "all":
        indices = None
    else:
        tr, va = train_val_split(len(ds), args.val_frac, seed=args.seed)
        indices = va if args.split == "val" else tr
        if not indices:
            raise UserError(f"the {args.split} split is empty "
                            f"({len(ds)} utterances, val_frac {args.val_frac})")
    vocoder = _vocoder(args.vocoder, args.gen_config, args.device) if args.vocoder else None

    res = evaluate_checkpoint(args.checkpoint, ds, indices=indices, batch_size=args.batch_size,
                              vocoder=vocoder, device=args.device)
    a = res["aggregate"]
    print(f"evaluated {a['n_utterances']} utterances "
          f"({args.split} split of {len(ds)}; {a['n_skipped']} over-bucket)")
    print(f"  MCD:            {a['mcd_db_mean']:.2f} dB mean / {a['mcd_db_median']:.2f} dB "
          f"median [reference target < 6.0 dB: "
          f"{'PASS' if a['meets_mcd_target_6db'] else 'not met'}]")
    print(f"  duration error: {a['dur_err_pct_mean']:.2f}% mean / "
          f"{a['dur_err_pct_median']:.2f}% median [reference target < 10%: "
          f"{'PASS' if a['meets_dur_err_target_10pct'] else 'not met'}]")
    if "f0_rmse_hz_mean" in a:
        print(f"  F0 RMSE:        {a['f0_rmse_hz_mean']:.2f} Hz mean / "
              f"{a['f0_rmse_hz_median']:.2f} Hz median [reference target < 20 Hz: "
              f"{'PASS' if a['meets_f0_target_20hz'] else 'not met'}]")
    if "vocoded_mcd_db_mean" in a:
        print(f"  vocoded MCD:    {a['vocoded_mcd_db_mean']:.2f} dB mean / "
              f"{a['vocoded_mcd_db_median']:.2f} dB median [serving condition; target "
              f"< 6.0 dB: {'PASS' if a['meets_vocoded_mcd_target_6db'] else 'not met'}]")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"full per-utterance result -> {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
