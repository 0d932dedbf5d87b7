"""The GAN-vocoder evidence at the JAX package's recipe, on one card, end to
end: a V3 generator trained on ground-truth mels, its copy synthesis, and
the GTA demo from it (`spev_tpu_torch.diag.vocoder_evidence`; the JAX
package's figures are in its ``docs/QUALITY.md``).

1. The 120-utterance formant corpus (seed 0) and ``cli.vocoder --config v3
   --batch_size 16 --segment_frames 32 --steps STEPS`` on it, a generator
   saved every ``--save_every`` steps (``logs/v3_gan/metrics.jsonl`` times
   the loop); meanwhile, in a second process on the same card,
   ``tools/torch_gta_demo.py --phase train`` trains the formant acoustic
   model for ``--epochs``.
2. ``tools/torch_gan_copysynth.py``'s copy synthesis of the demo's three
   held-out utterances (the setup's first three) with each generator of
   ``--score_at``, both columns.
3. ``tools/torch_gta_demo.py``'s two arms of ``--arm_steps`` from the last
   generator (fresh discriminators, the train split only) and its
   evaluation of the held-out utterances.

    python tools/torch_gan_evidence.py [--work .scratch/gan] [--steps 8000] \\
        [--save_every 2000] [--score_at 2000,8000] [--arm_steps 2000] [--epochs 150] \\
        [--out .scratch/gan_evidence.json] [--device cuda]

Prints each tool's lines, then one JSON line (also written to ``--out``):
the loop's ms a step per logged interval, the copy-synthesis results per
scored step, the GTA demo's JSON, and each stage's seconds.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def loop_ms(log_dir: str) -> list:
    """ms a step between consecutive records of ``<log_dir>/metrics.jsonl``."""
    from spev_tpu_torch.diag.metrics import read_metrics

    recs = read_metrics(log_dir)
    return [{"steps": [a["step"], b["step"]],
             "ms": 1e3 * (b["time"] - a["time"]) / (b["step"] - a["step"])}
            for a, b in zip(recs, recs[1:])]


def demo_wavs(gwork: str) -> list:
    """The corpus wavs of the GTA setup's first three held-out utterances."""
    from spev_tpu_torch.diag.vocoder_evidence import utterance_wavs

    with open(os.path.join(gwork, "meta.json")) as f:
        va = json.load(f)["va_idx"]
    with open(os.path.join(gwork, "setup", "cache", "metadata.json")) as f:
        files = json.load(f)["files"]
    return utterance_wavs(os.path.join(gwork, "corpus"), files, va[:3])


def main(work=".scratch/gan", steps=8000, save_every=2000, score_at=(2000, 8000),
         arm_steps=2000, epochs=150, out=".scratch/gan_evidence.json", device="cuda"):
    from spev_tpu_torch.cli import vocoder as voc_cli
    from spev_tpu_torch.data.synthetic import generate_formant_corpus
    from spev_tpu_torch.diag.vocoder_evidence import copy_synthesis
    from tools import torch_gta_demo

    work = os.path.abspath(work)
    gwork = os.path.join(work, "gta")
    os.makedirs(work, exist_ok=True)
    gen = os.path.join(work, "checkpoints", "v3_gan", f"gen_{steps:08d}.spev")
    t0 = time.perf_counter()
    train = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "torch_gta_demo.py"), "--baseline_gen", gen,
         "--phase", "train", "--epochs", str(epochs), "--work", gwork, "--device", device],
        cwd=REPO)
    try:
        corpus = os.path.join(work, "corpus")
        generate_formant_corpus(corpus, n_utterances=120, seed=0)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            rc = voc_cli.main(["--data_dir", corpus, "--name", "v3_gan", "--config", "v3",
                               "--batch_size", "16", "--segment_frames", "32", "--steps",
                               str(steps), "--save_every", str(save_every), "--log_every", "200",
                               "--device", device])
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError(f"cli.vocoder exited with {rc}")
        t_voc = time.perf_counter() - t0
    finally:
        if train.wait() != 0:
            raise RuntimeError(f"the acoustic training exited with {train.returncode}")
    t_train = time.perf_counter() - t0
    wavs = demo_wavs(gwork)
    copy = {}
    for s in score_at:
        path = os.path.join(work, "checkpoints", "v3_gan", f"gen_{s:08d}.spev")
        copy[s] = copy_synthesis(path, wavs, config="v3", device=device)
    t_copy = time.perf_counter() - t0
    demo = torch_gta_demo.main(gen, steps=arm_steps, work=gwork,
                               out=os.path.join(gwork, "gta_metrics.json"), device=device)
    res = {"loop_ms": loop_ms(os.path.join(work, "logs", "v3_gan")),
           "demo_wavs": [os.path.basename(w) for w in wavs], "copy_synthesis": copy,
           "gta_demo": demo,
           "seconds": {"vocoder": t_voc, "with_acoustic": t_train, "copy_synthesis": t_copy,
                       "total": time.perf_counter() - t0}}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=".scratch/gan")
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--save_every", type=int, default=2000)
    ap.add_argument("--score_at", default="2000,8000")
    ap.add_argument("--arm_steps", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--out", default=".scratch/gan_evidence.json")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.work, a.steps, a.save_every, tuple(int(s) for s in a.score_at.split(",")),
         a.arm_steps, a.epochs, a.out, a.device)
