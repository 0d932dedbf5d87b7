"""Building the system under test from a configuration file and the seed:
the port's `Synthesizer` (with its HiFi-GAN `Vocoder`) and its `Trainer`,
loaded with the benchmark's seeded weights, at the precision the file
states."""

from __future__ import annotations

import dataclasses

import torch

from ttsbench.lib.weights import fs2_weights, generator_weights
from ttsbench.reference import g2p_rules


def model_config(config: dict, vocab_size: int):
    from spev_tpu_torch.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config["acoustic"].items() if k in names},
                       vocab_size=vocab_size)


def set_serving_precision(config: dict) -> None:
    """The serving precision the configuration states, set explicitly."""
    prec = config["precision"]["serve"]
    torch.backends.cudnn.allow_tf32 = bool(prec["cudnn_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["matmul_tf32"])


def synthesizer(config: dict, seed: int, device):
    """(synth, fs2 weights, generator weights, vocab symbols)."""
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.infer.vocoder import Vocoder
    from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    symbols = g2p_rules.vocab()
    fs2 = fs2_weights(config["acoustic"], len(symbols), config["weights"], seed, device)
    gen_sd = generator_weights(config["vocoder"], seed, device)
    set_serving_precision(config)
    synth = Synthesizer((fs2, symbols, {}), hifigan_dir=None,
                        model_cfg=model_config(config, len(symbols)),
                        g2p_backend=config["g2p_backend"], device=device)
    v = config["vocoder"]
    hcfg = HiFiGANConfig(resblock=v["resblock"], upsample_rates=tuple(v["upsample_rates"]),
                         upsample_kernel_sizes=tuple(v["upsample_kernel_sizes"]),
                         upsample_initial_channel=v["upsample_initial_channel"],
                         resblock_kernel_sizes=tuple(v["resblock_kernel_sizes"]),
                         resblock_dilation_sizes=tuple(tuple(d) for d in
                                                       v["resblock_dilation_sizes"]),
                         num_mels=v["num_mels"])
    with torch.device(device):
        gen = HiFiGANGenerator(hcfg)
    gen.load_state_dict(gen_sd)
    synth.vocoder = Vocoder(generator=gen, audio=synth.audio, device=device)
    return synth, fs2, gen_sd, symbols


def trainer(config: dict, seed: int, device, workdir: str):
    """(trainer, the seeded weights, vocab symbols): the port's `Trainer` at
    the configuration's `TrainConfig`, its weights replaced by the seeded
    ones before any step."""
    from spev_tpu_torch.config import SpevConfig, TrainConfig
    from spev_tpu_torch.train.trainer import Trainer

    symbols = g2p_rules.vocab()
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    train = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config["train"].items()
             if k in names}
    cfg = SpevConfig(model=model_config(config, len(symbols)), train=TrainConfig(**train))
    tr = Trainer(cfg, symbols, {}, ckpt_dir=f"{workdir}/ckpt", log_dir=f"{workdir}/log",
                 device=device)
    weights = fs2_weights(config["acoustic"], len(symbols), config["weights"], seed, device)
    tr.model.load_state_dict(weights)
    return tr, weights, symbols
