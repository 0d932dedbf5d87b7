"""Dataset acquisition CLI (counterpart of ``spev_tpu.cli.download``).

    python -m spev_tpu_torch.cli.download prep --dataset esd|jenny --in_dir D --out_dir P
    python -m spev_tpu_torch.cli.download download --dataset single-speaker|multi-speaker|both \\
        [--work_dir data/raw] [--out_dir data/training_data] [--limit N]

``prep`` converts a local ESD or Jenny tree into wav/txt pairs.
``download`` processes LJSpeech (``<work_dir>/LJSpeech-1.1``) and
LibriTTS-R (``<work_dir>/LibriTTS_R``) into pairs; it fetches and extracts
an archive only when that root is missing (and extracts without fetching
when the archive is already in ``work_dir``).  Neither needs a device.
"""

from __future__ import annotations

import argparse
import os
import sys

from spev_tpu_torch.cli.common import cli_guard


@cli_guard
def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="spev-download")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("download", help="download + process public datasets")
    d.add_argument("--dataset", choices=["single-speaker", "multi-speaker", "both"],
                   default="single-speaker")
    d.add_argument("--out_dir", default="data/training_data")
    d.add_argument("--work_dir", default="data/raw")
    d.add_argument("--limit", type=int, default=None)

    e = sub.add_parser("prep", help="convert a local dataset to wav/txt pairs")
    e.add_argument("--dataset", choices=["esd", "jenny"], required=True)
    e.add_argument("--in_dir", required=True)
    e.add_argument("--out_dir", required=True)
    e.add_argument("--limit", type=int, default=None)

    args = p.parse_args(argv)
    from spev_tpu_torch.data import downloaders as dl

    if args.cmd == "prep":
        fn = dl.prep_esd if args.dataset == "esd" else dl.prep_jenny
        n = fn(args.in_dir, args.out_dir, limit=args.limit)
        print(f"prepared {n} utterances into {args.out_dir}")
        return

    if args.dataset in ("single-speaker", "both"):
        root = os.path.join(args.work_dir, "LJSpeech-1.1")
        if not os.path.exists(root):
            dl.download_and_extract(dl.LJSPEECH_URL, args.work_dir)
        n = dl.process_single_speaker(root, args.out_dir, limit=args.limit)
        print(f"LJSpeech: {n} utterances")
    if args.dataset in ("multi-speaker", "both"):
        root = os.path.join(args.work_dir, "LibriTTS_R")
        if not os.path.exists(root):
            dl.download_and_extract(dl.LIBRITTS_R_URL, args.work_dir)
        n = dl.process_multi_speaker(root, args.out_dir, limit=args.limit)
        print(f"LibriTTS-R: {n} utterances")


if __name__ == "__main__":
    sys.exit(main())
