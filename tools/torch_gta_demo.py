"""GTA fine-tuning evidence on the card: does training the vocoder on the
acoustic model's own teacher-forced mels close the acoustic-to-vocoder
mismatch?  The port's counterpart of ``tools/gta_demo.py``, with its
arguments, phases and JSON (`spev_tpu_torch.diag.vocoder_evidence`):

  baseline  a generator trained on ground-truth mels (``--baseline_gen``)
  control   baseline + ``--steps`` more steps on ground-truth mels
  gta       baseline + ``--steps`` more steps on teacher-forced predicted mels

each scored on the held-out utterances by vocoding the acoustic model's
predicted mel (the serving condition) and the ground-truth mel (copy
synthesis).  The arms train on the train split only.

    python tools/torch_gta_demo.py --baseline_gen checkpoints/run/gen_*.spev \\
        [--steps 2000] [--epochs 150] [--work .scratch/gta_demo] \\
        [--out .scratch/demo/gta_metrics.json] [--wav_dir D] [--resume_state S] \\
        [--disc_warmup N] [--phase all|train|finetune|eval] [--device cuda]

Each phase skips itself when its output exists under ``--work``
(``acoustic.spev``, each arm's ``gen_*.spev``), so a run resumes.  Unlike
the JAX tool, which trains the acoustic model on virtual CPU devices in a
subprocess, every phase runs here on ``--device``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(baseline_gen: str, config: str = "v3", steps: int = 2000, epochs: int = 150,
         batch_size: int = 16, segment_frames: int = 32, work: str = ".scratch/gta_demo",
         out: str = ".scratch/demo/gta_metrics.json", wav_dir: str = None,
         resume_state: str = None, disc_warmup: int = 0, phase: str = "all",
         device="cuda"):
    """Run ``phase`` (and what it needs).  Returns the evaluation's JSON
    (None before the eval phase)."""
    from spev_tpu_torch.diag import vocoder_evidence as ve

    os.makedirs(work, exist_ok=True)
    if not os.path.exists(os.path.join(work, "acoustic.spev")):
        ve.train_gta_acoustic(work, epochs, device=device)
    else:
        print("phase train: exists, skipping")
    if phase == "train":
        return None
    baseline = os.path.abspath(baseline_gen)
    rs = os.path.abspath(resume_state) if resume_state else None
    gens = {}
    for arm, gta in ve.ARMS:
        if phase in ("all", "finetune"):
            gens[arm] = ve.run_finetune(work, baseline, steps, gta, config, batch_size,
                                        segment_frames, disc_warmup=disc_warmup,
                                        resume_state=rs, device=device)
        else:
            gens[arm] = os.path.join(work, "checkpoints", ve.arm_name(gta, rs),
                                     f"gen_{steps:08d}.spev")
    if phase == "finetune":
        return None
    return ve.evaluate_arms(work, baseline, gens, out, config, wav_dir=wav_dir, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline_gen", required=True,
                    help="gen_*.spev trained on ground-truth mels")
    ap.add_argument("--config", default="v3", choices=["v1", "v3"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--segment_frames", type=int, default=32)
    ap.add_argument("--work", default=".scratch/gta_demo")
    ap.add_argument("--out", default=".scratch/demo/gta_metrics.json")
    ap.add_argument("--wav_dir", default=None,
                    help="also write val{j}_predmel_{arm}.wav here")
    ap.add_argument("--resume_state", default=None,
                    help="state_latest.spev matching --baseline_gen: both arms resume the "
                         "whole GAN state instead of a generator-only start with fresh "
                         "discriminators")
    ap.add_argument("--disc_warmup", type=int, default=0,
                    help="generator-only start: train only the discriminators for N steps "
                         "(ignored with --resume_state)")
    ap.add_argument("--phase", default="all", choices=["all", "train", "finetune", "eval"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.baseline_gen, a.config, a.steps, a.epochs, a.batch_size, a.segment_frames, a.work,
         a.out, a.wav_dir, a.resume_state, a.disc_warmup, a.phase, a.device)
