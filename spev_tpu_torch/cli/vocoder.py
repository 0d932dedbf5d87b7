"""Vocoder (HiFi-GAN) training and fine-tuning — counterpart of
``spev_tpu.cli.vocoder``, with its flags, names and defaults.

    python -m spev_tpu_torch.cli.vocoder --data_dir wavs/ --name voc_run \\
        [--finetune_from DIR|gen_*.spev] [--config v1|v3|tiny] [--steps 10000] \\
        [--batch_size 8] [--segment_frames 32] [--resume_state state_latest.spev] \\
        [--gta_checkpoint best.spev --cache_dir C] [--device cpu]

Trains on random fixed-length crops: (log-mel, waveform) pairs, the
full-utterance log-mel computed once per file by `FeatureExtractor.mel`
(kernel K2 on the card), or with ``--gta_checkpoint`` the acoustic model's
teacher-forced mels (`infer.gta`, kernel K1).  Writes
``checkpoints/<name>/gen_{step:08d}.spev`` and ``state_latest.spev`` (the
whole GAN state, for ``--resume_state``) every ``--save_every`` steps and at
the end, and ``logs/<name>/metrics.jsonl``.

On the card: ``--step_impl fused_folded`` (the default) runs the fused step
(one generator forward a step) on the ordinary cuDNN generator: the JAX
package's polyphase fold is a layout for the TPU's matrix unit, which it
takes only on a TPU.  ``split_unfolded`` runs ``d_step`` then ``g_step``.
``--precision default`` runs cuDNN's convolutions in TF32 (the card's
single-pass mode; the mel L1 stays fp32), ``high`` every product in fp32.

Data-parallel over N cards (``--batch_size`` must divide by N):

    python -m torch.distributed.run --nproc_per_node N -m spev_tpu_torch.cli.vocoder \
        --data_dir wavs/ --mesh N ...

Every rank draws the same crops and trains on its rows; the gradients are
averaged over the ranks, and rank 0 alone logs and saves.  ``--mesh`` must
equal the launch's process count.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import re

import numpy as np

from spev_tpu_torch.cli.common import add_cache_flags, cli_guard
from spev_tpu_torch.errors import UserError


def make_crop_batcher(wavs, audio, segment_frames: int, batch_size: int,
                      cache_files: int = 1000, gta_by_path=None, data_dir: str = "",
                      seed: int = 0, device="cuda"):
    """Random fixed-length (mel, waveform) crop batches for GAN training.

    Returns a zero-argument callable giving ``(mel (B, F, n_mels), wav
    (B, F·hop))`` numpy batches.  Each file's full-utterance log-mel is
    computed once (K2 on ``device``), then cropped on hop boundaries; files
    shorter than one crop skip extraction.  At most ``cache_files`` files
    stay loaded (FIFO eviction).  Crop starts come from
    ``random.Random(seed)``, as in the JAX package, so both draw the same
    crops.  With ``gta_by_path`` ({wav path: (T, n_mels)}) the crops take
    those teacher-forced mels instead."""
    from spev_tpu_torch.data.dataset import FeatureExtractor
    from spev_tpu_torch.utils.native import read_wav
    from spev_tpu_torch.utils.wavio import resample_linear

    hop = audio.hop_length
    seg = segment_frames * hop
    fx = None
    rng = random.Random(seed)
    audio_cache = {}
    too_short: set = set()

    def load(path):
        nonlocal fx
        if path not in audio_cache:
            y, sr = read_wav(path)
            if sr != audio.sample_rate:
                y = resample_linear(y, sr, audio.sample_rate)
            mel = None
            if len(y) >= seg + hop:
                if gta_by_path is not None:
                    mel = gta_by_path[path]  # (T, n_mels), teacher-forced
                else:
                    if fx is None:
                        fx = FeatureExtractor(audio, device)
                    mel = np.ascontiguousarray(fx.mel(y).T, np.float32)  # (T, n_mels)
            if len(audio_cache) >= cache_files:
                audio_cache.pop(next(iter(audio_cache)))  # FIFO eviction
            audio_cache[path] = (y, mel)
        return audio_cache[path]

    def batch():
        wav_crops, mel_crops = [], []
        while len(wav_crops) < batch_size:
            path = rng.choice(wavs)
            if path not in too_short:
                y, mel_full = load(path)
                if mel_full is not None:
                    start = rng.randrange(0, len(y) - seg) // hop * hop
                    mel = mel_full[start // hop :][:segment_frames]
                    if mel.shape[0] >= segment_frames:
                        wav_crops.append(y[start : start + seg])
                        mel_crops.append(mel)
                        continue
                too_short.add(path)
            if len(too_short) == len(wavs):
                raise UserError(
                    f"no wav under {data_dir} is long enough for one {seg + hop}-sample "
                    "training segment; lower --segment_frames or provide longer audio")
        return np.stack(mel_crops), np.stack(wav_crops)

    return batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spev-vocoder-train")
    p.add_argument("--data_dir", required=True, help="directory of wav files")
    p.add_argument("--name", default="vocoder_run")
    p.add_argument("--config", default="v1", choices=["v1", "v3", "tiny"],
                   help="generator size (tiny = smoke-test scale)")
    p.add_argument("--finetune_from", default=None,
                   help="upstream HiFi-GAN dir (config.json + g_*) OR a gen_*.spev saved by "
                        "this trainer (generator-only warm start; pair with the matching "
                        "--config)")
    p.add_argument("--resume_state", default=None,
                   help="state_latest.spev from a previous run (either package's): restores "
                        "generator + discriminators + optimizer states + step for exact "
                        "resume (pair with the same --config/--periods/--scales)")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--segment_frames", type=int, default=32, help="mel frames per training crop")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--disc_warmup", type=int, default=0,
                   help="train the discriminators ONLY (generator frozen) for the first N "
                        "steps: use when warm-starting from a generator-only checkpoint")
    p.add_argument("--periods", type=str, default="2,3,5,7,11",
                   help="MPD periods (fewer = faster steps)")
    p.add_argument("--scales", type=int, default=3, help="MSD scales")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--precision", default="default", choices=["high", "default"],
                   help="'default': cuDNN convolutions in TF32 (the card's single-pass "
                        "mode; fp32 parameters, optimizer and mel L1 either way); 'high': "
                        "every product in fp32")
    p.add_argument("--mel_weight", type=float, default=45.0,
                   help="weight of the mel-L1 term in L_G (upstream 45)")
    p.add_argument("--fm_weight", type=float, default=2.0,
                   help="weight of the feature-matching term in L_G (upstream 2)")
    p.add_argument("--disc_dtype", default=None, choices=["bf16"],
                   help="run the discriminators with bf16 weights+activations (fp32 loss "
                        "accumulation; master params stay fp32)")
    p.add_argument("--step_impl", default="fused_folded",
                   choices=["fused_folded", "split_unfolded"],
                   help="'fused_folded' (the default): one generator forward a step (the "
                        "fused step; on the card the generator runs unfolded); "
                        "'split_unfolded': d_step then g_step")
    p.add_argument("--mesh", type=int, default=1,
                   help="data-parallel devices: the ranks of a python -m torch.distributed.run "
                        "launch (--nproc_per_node N)")
    p.add_argument("--cache_files", type=int, default=1000,
                   help="max files held in the in-RAM wav+mel cache (FIFO eviction)")
    p.add_argument("--gta_checkpoint", default=None,
                   help="acoustic checkpoint (.spev/.pt): condition on its teacher-forced "
                        "predicted mels instead of gt mels (the LJ_FT workflow); --data_dir "
                        "must then be a training corpus ({id}.wav + {id}.txt [+ TextGrids])")
    p.add_argument("--textgrid_dir", default=None,
                   help="MFA TextGrids for the GTA corpus (optional)")
    add_cache_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda' by default; 'cpu' to train on the CPU)")
    return p


def generator_config(name: str):
    from spev_tpu_torch.models.hifigan import HiFiGANConfig

    if name == "v1":
        return HiFiGANConfig()
    if name == "v3":
        return HiFiGANConfig.v3()
    return HiFiGANConfig(resblock="2", upsample_rates=(8, 8, 4),
                         upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=16,
                         resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))


@cli_guard
def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.disc_warmup >= args.steps:
        raise UserError(f"--disc_warmup {args.disc_warmup} must be < --steps {args.steps} "
                        "(warmup steps never save a generator)")

    import torch

    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.data.prefetch import prefetch
    from spev_tpu_torch.diag.metrics import log_metrics
    from spev_tpu_torch.models.hifigan import HiFiGANGenerator
    from spev_tpu_torch.parallel import distributed
    from spev_tpu_torch.parallel.mesh import make_mesh
    from spev_tpu_torch.train.vocoder_trainer import (init_vocoder_train_state, load_generator,
                                                      load_state, make_vocoder_train_step,
                                                      save_generator, save_state)
    from spev_tpu_torch.utils.platform import resolve_device

    mesh = None
    if distributed.initialize(device=args.device) or args.mesh > 1:
        world = distributed.world_size()
        if world != args.mesh:
            raise UserError(
                f"--mesh {args.mesh} needs a process group of {args.mesh} ranks, this run has "
                f"{world}: launch with python -m torch.distributed.run --nproc_per_node "
                f"{args.mesh} -m spev_tpu_torch.cli.vocoder ... --mesh {args.mesh}")
        if args.batch_size % args.mesh:
            raise UserError(f"--batch_size {args.batch_size} not divisible by --mesh {args.mesh}")
        mesh = make_mesh((args.mesh,), ("data",))
        print(f"data-parallel over {args.mesh} devices")
    dev = mesh.local_device if mesh is not None else resolve_device(args.device)
    main_rank = distributed.rank() == 0
    audio = AudioConfig()
    seg = args.segment_frames * audio.hop_length
    cfg = generator_config(args.config)
    gen_sd = None
    if args.finetune_from:
        if args.finetune_from.endswith(".spev"):
            gen_sd = load_generator(args.finetune_from, cfg).state_dict()
        else:
            gen = HiFiGANGenerator.from_pretrained(args.finetune_from)
            cfg, gen_sd = gen.cfg, gen.state_dict()
        print(f"fine-tuning from {args.finetune_from}")

    wavs = sorted(glob.glob(os.path.join(args.data_dir, "**", "*.wav"), recursive=True))
    if not wavs:
        raise FileNotFoundError(f"no wavs under {args.data_dir}")
    print(f"{len(wavs)} wavs; segment {seg} samples ({args.segment_frames} frames)")

    gta_by_path = None
    if args.gta_checkpoint:
        from spev_tpu_torch.data.dataset import SpevDataset
        from spev_tpu_torch.infer.gta import compute_gta_mels

        if not main_rank:
            distributed.barrier()  # rank 0 builds a missing cache first
        ds = SpevDataset(args.data_dir, textgrid_dir=args.textgrid_dir,
                         cache_dir=args.cache_dir,
                         force_rebuild=main_rank and args.force_rebuild, device=dev)
        if main_rank:
            distributed.barrier()
        gta = compute_gta_mels(args.gta_checkpoint, ds, device=dev)
        gta_by_path = {}
        for i, m in gta.items():
            # ds.files[i] is 'u_{w:05d}.npz', w indexing the dataset's sorted
            # recursive wav glob (the same glob as `wavs` above)
            w = int(re.match(r"u_(\d+)\.npz$", os.path.basename(ds.files[i])).group(1))
            gta_by_path[wavs[w]] = np.ascontiguousarray(m)
        wavs = [p for p in wavs if p in gta_by_path]
        if not wavs:
            raise UserError("GTA produced no usable utterances (all exceed the frame buckets?)")
        print(f"GTA conditioning from {args.gta_checkpoint}: {len(wavs)} utterances")

    make_batch = make_crop_batcher(wavs, audio, args.segment_frames, args.batch_size,
                                   cache_files=args.cache_files, gta_by_path=gta_by_path,
                                   data_dir=args.data_dir, device=dev)

    def batches():
        for _ in range(args.steps):
            mel, wav = make_batch()
            yield (torch.from_numpy(mel).to(dev, non_blocking=True),
                   torch.from_numpy(wav).to(dev, non_blocking=True))

    periods = tuple(int(x) for x in args.periods.split(",") if x.strip())
    state = init_vocoder_train_state(cfg, gen_state_dict=gen_sd, periods=periods,
                                     n_scales=args.scales, lr=args.lr, device=dev)
    if args.resume_state:
        state = load_state(args.resume_state, state)
        print(f"resumed full GAN state from {args.resume_state} (step {state.step})")
    step = make_vocoder_train_step(cfg, audio, fm_weight=args.fm_weight,
                                   mel_weight=args.mel_weight, lr=args.lr,
                                   fused=args.step_impl == "fused_folded",
                                   disc_dtype=args.disc_dtype, precision=args.precision,
                                   mesh=mesh)
    ckpt_dir = os.path.join("checkpoints", args.name)
    log_dir = os.path.join("logs", args.name)
    os.makedirs(ckpt_dir, exist_ok=True)

    # crops and their mels are made ahead of the GAN step (data/prefetch.py)
    for i, (mel, wav) in enumerate(prefetch(batches(), depth=2)):
        if i < args.disc_warmup:
            state, d_loss, _ok = step.d_step(state, mel, wav)
            if main_rank and (i + 1) % args.log_every == 0:
                print(f"step {i + 1} [disc warmup]: d={d_loss:.3f}")
            continue
        state, m = step(state, mel, wav)
        if not main_rank:
            continue
        if (i + 1) % args.log_every == 0:
            print(f"step {i + 1}: d={m['d_loss']:.3f} g={m['g_loss']:.3f} "
                  f"mel={m['g_mel']:.3f} skipped={int(m['skipped'])}")
            log_metrics(log_dir, i + 1, m)
        if (i + 1) % args.save_every == 0 or i + 1 == args.steps:
            path = os.path.join(ckpt_dir, f"gen_{i + 1:08d}.spev")
            save_generator(path, state, cfg)
            # one rolling full-state file: both networks and both optimizers
            save_state(os.path.join(ckpt_dir, "state_latest.spev"), state)
            print(f"saved {path} (+ state_latest.spev)")


if __name__ == "__main__":
    raise SystemExit(main())
