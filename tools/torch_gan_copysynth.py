"""Copy-synthesis evaluation of a HiFi-GAN generator trained by
``cli.vocoder``: the port's counterpart of ``tools/gan_copysynth.py``, with
its arguments (`spev_tpu_torch.diag.vocoder_evidence.copy_synthesis`).  It
vocodes each wav's own mel (no acoustic model in the loop) and reports the
round trip's MCD beside the Griffin-Lim fallback's.

    python -m spev_tpu_torch.cli.vocoder --data_dir corpus --name run --config v3 \\
        --steps 2000 --batch_size 16
    python tools/torch_gan_copysynth.py checkpoints/run/gen_00002000.spev \\
        wav1.wav [wav2.wav ...] [--config v3] [--out_dir D] [--skip_gl] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(checkpoint: str, wavs, config: str = "v3", out_dir: str = None,
         skip_gl: bool = False, device="cuda") -> dict:
    from spev_tpu_torch.diag.vocoder_evidence import copy_synthesis

    return copy_synthesis(checkpoint, wavs, config=config, out_dir=out_dir, skip_gl=skip_gl,
                          device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help="gen_*.spev from cli.vocoder")
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--config", default="v3", choices=["v1", "v3"])
    ap.add_argument("--out_dir", default=None, help="write *_copysynth_gan.wav here")
    ap.add_argument("--skip_gl", action="store_true",
                    help="skip the Griffin-Lim comparison column")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.checkpoint, a.wavs, a.config, a.out_dir, a.skip_gl, a.device)
