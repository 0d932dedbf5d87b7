"""The counts in ``ttsbench/counts/`` equal a sum over the products the
port's modules run (PyTorch's own FLOP counter over the linears, batched
products and convolutions), at a small width, and the kernels' byte counts
equal the sizes of the tensors they read and write."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS
from ttsbench.counts import bytes as nbytes
from ttsbench.counts import flops

ACOUSTIC = dict(embed_dim=32, hidden_dim=32, n_heads=2, n_encoder_layers=2, n_decoder_layers=3,
                ffn_kernel_size=9, ffn_expansion=4, vp_layers=2, vp_kernel_size=3, n_mels=80)


def _hcfg(h: HiFiGANConfig) -> dict:
    return {k: getattr(h, k) for k in ("resblock", "upsample_rates", "upsample_kernel_sizes",
                                       "upsample_initial_channel", "resblock_kernel_sizes",
                                       "resblock_dilation_sizes", "num_mels")}


@pytest.mark.parametrize("n,frames", [(7, 21), (13, 40)])
def test_fastspeech2_flops_equal_the_modules_products(n, frames):
    model = FastSpeech2.random_init(ModelConfig(vocab_size=20, **ACOUSTIC), seed=0)
    ids, lens = torch.randint(1, 20, (1, n)), torch.tensor([n])
    durs = torch.full((1, n), float(frames // n))
    durs[0, -1] += frames - int(durs.sum())
    tracks = {f"target_{k}": torch.zeros(1, n) for k in ("pitch", "energy", "breath", "rough",
                                                        "bright")}
    with FlopCounterMode(display=False) as fc:
        model(ids, lens, frames, target_durations=durs, **tracks)
    assert fc.get_total_flops() == flops.fastspeech2(ACOUSTIC, n, frames)
    assert flops.train_step(ACOUSTIC, n, frames) == 3 * flops.fastspeech2(ACOUSTIC, n, frames)


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_generator_flops_equal_the_modules_products(version):
    h = HiFiGANConfig() if version == "v1" else HiFiGANConfig.v3()
    h = dataclasses.replace(h, upsample_initial_channel=32)
    gen = HiFiGANGenerator(h)
    with FlopCounterMode(display=False) as fc:
        gen(torch.zeros(1, 6, 80))
    assert fc.get_total_flops() == flops.generator(_hcfg(h), 6)


def test_length_regulator_bytes_are_the_tensors_read_and_written():
    B, T, H, M = 3, 11, 32, 40
    x, f = torch.zeros(B, T, H), torch.zeros(B, T, N_TRACKS)
    ends = torch.zeros(B, T, dtype=torch.int32)
    out_x, out_f = torch.zeros(B, M, H), torch.zeros(B, M, N_TRACKS)

    def size(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    assert nbytes.k1(B, T, H, N_TRACKS, M) == size(ends, x, f, out_x, out_f)
    valid = 57
    assert nbytes.k1b(B, T, H, N_TRACKS, valid) == (size(ends, x, f)
                                                    + valid * (H + N_TRACKS) * 4)
