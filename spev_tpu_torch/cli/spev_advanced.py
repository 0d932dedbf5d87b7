"""Advanced training and synthesis on the card (or the CPU): voice-quality
controls, VAD emotion, speaker, age, lung capacity and word emphasis.

    python -m spev_tpu_torch.cli.spev_advanced --mode train --data_dir WAVS \
        [--multi_speaker] [--emotion_labels] [--reference_predictors] \
        [--name spev_advanced --epochs 150 ...] [--device cuda]
    python -m spev_tpu_torch.cli.spev_advanced --mode infer \
        --checkpoint best.spev [--hifigan_dir DIR] --text "Hello." \
        [--breathiness 0.3 --roughness 0.2 --nasality 0.4] \
        [--valence -0.5 --arousal 0.6 --dominance -0.3] [--speaker 2] \
        [--age 60] [--lung_capacity 0.3] [--word_emphasis "1,1.5,1"] \
        [--device cuda] --output out.wav

Counterpart of ``spev-advanced`` (``spev_tpu.cli.spev_advanced``): the same
parser, plus ``--device``.  ``--mode train`` trains the advanced model
(VAD projection, nasality channel, per-phoneme predictors unless
``--reference_predictors``; a speaker table sized from the corpus with
``--multi_speaker``, VAD targets from the file names' emotions with
``--emotion_labels``) through `spev_tpu_torch.cli.common.run_training` and
writes ``checkpoints/<name>/{last,best}.spev``.  ``--mode infer`` writes
the waveform and ``<output>_mel.png`` (skipped without matplotlib).  The
checkpoint is a ``.spev`` (either package's) or a ``.pt``.  Errors caused
by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import sys

from spev_tpu_torch.cli.common import add_cache_flags, cli_guard, run_training, write_output


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.spev_advanced")
    p.add_argument("--mode", type=str, default="infer", choices=["train", "infer"])
    # training
    p.add_argument("--data_dir", type=str, default="data/training_data")
    p.add_argument("--textgrid_dir", type=str, default="data/textgrid_data")
    p.add_argument("--name", type=str, default="spev_advanced")
    add_cache_flags(p)
    p.add_argument("--save_every", type=int, default=10,
                   help="epochs between resumable `last` checkpoints (the final epoch "
                        "always saves; `best` saves on every improvement)")
    p.add_argument("--resume", type=str, help="checkpoint to continue from")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--multi_speaker", action="store_true",
                   help="speaker labels from file-name prefixes ({speaker}_*.wav) and a "
                        "speaker embedding; synthesize with --speaker")
    p.add_argument("--emotion_labels", action="store_true",
                   help="emotion labels from file-name suffixes (*_{emotion}.wav) as VAD "
                        "targets of the VAD embedding")
    p.add_argument("--reference_predictors", action="store_true",
                   help="keep the reference's LayerNorm(1) constant-output variance "
                        "predictors; by default they are per-phoneme")
    # inference
    p.add_argument("--checkpoint", type=str, default="checkpoints/spev_advanced/best.spev",
                   help=".spev or .pt checkpoint")
    p.add_argument("--hifigan_dir", type=str, default="hifi-gan")
    p.add_argument("--text", type=str, default="Hello from advanced SPEV.")
    p.add_argument("--output", type=str, default="advanced_output.wav")
    # voice quality
    p.add_argument("--breathiness", type=float, default=0.0, help="0-1 aspiration noise")
    p.add_argument("--roughness", type=float, default=0.0, help="0-1 vocal fry")
    p.add_argument("--nasality", type=float, default=0.0, help="0-1 nasal resonance")
    # VAD emotion
    p.add_argument("--valence", type=float, default=0.0, help="-1..1")
    p.add_argument("--arousal", type=float, default=0.0, help="-1..1")
    p.add_argument("--dominance", type=float, default=0.0, help="-1..1")
    # physiology
    p.add_argument("--speaker", type=int, default=None,
                   help="speaker id (multi-speaker checkpoints)")
    p.add_argument("--age", type=float, default=25.0)
    p.add_argument("--lung_capacity", type=float, default=1.0, help="0-1")
    # expression
    p.add_argument("--word_emphasis", type=str, default="",
                   help="comma-separated per-word scales, e.g. '1.0,1.5,1.0'")
    p.add_argument("--pitch_scale", type=float, default=1.0)
    p.add_argument("--duration_scale", type=float, default=1.0)
    p.add_argument("--energy_scale", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def synthesize_advanced(args):
    """(waveform, mel) of one request through
    `spev_tpu_torch.infer.advanced_api.synthesize_advanced_controls`."""
    from spev_tpu_torch.infer.advanced_api import synthesize_advanced_controls
    from spev_tpu_torch.infer.synthesis import Synthesizer

    synth = Synthesizer(args.checkpoint, hifigan_dir=args.hifigan_dir, device=args.device)
    return synthesize_advanced_controls(
        synth,
        args.text,
        breathiness=args.breathiness,
        roughness=args.roughness,
        nasality=args.nasality,
        valence=args.valence,
        arousal=args.arousal,
        dominance=args.dominance,
        age=args.age,
        lung_capacity=args.lung_capacity,
        word_emphasis=args.word_emphasis,
        speaker=args.speaker,
        pitch_scale=args.pitch_scale,
        duration_scale=args.duration_scale,
        energy_scale=args.energy_scale,
    )


@cli_guard
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "train":
        # VAD conditioning and the learned nasality channel; per-phoneme
        # predictors unless asked (a constant one would cut VAD and emphasis
        # off from prosody)
        overrides = {"use_vad": True, "use_nasality": True}
        if not args.reference_predictors:
            overrides["vp_output_norm"] = False
        run_training(args, model_overrides=overrides)
    else:
        wav, mel = synthesize_advanced(args)
        write_output(wav, args.output, mel)
    return 0


def train_main(argv=None) -> int:
    """``spev-advanced-train``."""
    return main(["--mode", "train"] + list(argv or []))


def infer_main(argv=None) -> int:
    """``spev-advanced-infer``."""
    return main(["--mode", "infer"] + list(argv or []))


if __name__ == "__main__":
    sys.exit(main())
