"""The plain reference agrees with the port on the CPU at a small size: the
frozen G2P copy, the weights' names and shapes, one utterance's synthesis,
and (through a whole tiny training run) the train step."""

import json
import os

import numpy as np
import pytest
import torch

from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.text.g2p import G2P
from ttsbench.lib import program
from ttsbench.lib.runner import execute
from ttsbench.lib.weights import fs2_weights, generator_weights
from ttsbench.reference import g2p_rules
from ttsbench.reference.models import fs2_shapes, generator_shapes
from ttsbench.reference.synthesis import gaps, synthesize
from ttsbench.tests.tiny import tiny_cell
from ttsbench.traffic.texts import WORDS_FILE, TextGenerator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_frozen_g2p_equals_the_ports_rules_g2p():
    port = G2P("rules")
    with open(WORDS_FILE) as f:
        words = f.read().split()
    texts = words + TextGenerator(3, 14.0).texts(50) + ["It is 42 o'clock, said the 3 men."]
    for t in texts:
        assert g2p_rules.phonemes(t) == port.phonemes(t), t
        assert set(g2p_rules.phonemes(t)) <= set(g2p_rules.vocab())


@pytest.mark.parametrize("name", ["fs2-hifigan-v1", "fs2-hifigan-v3"])
def test_weight_names_and_shapes_are_the_ports(name):
    config = _config(name)
    symbols = g2p_rules.vocab()
    port = FastSpeech2(program.model_config(config, len(symbols))).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == fs2_shapes(config["acoustic"],
                                                                      len(symbols))
    v = config["vocoder"]
    h = HiFiGANConfig(v["resblock"], tuple(v["upsample_rates"]), tuple(v["upsample_kernel_sizes"]),
                      v["upsample_initial_channel"], tuple(v["resblock_kernel_sizes"]),
                      tuple(tuple(d) for d in v["resblock_dilation_sizes"]), v["num_mels"])
    gen = HiFiGANGenerator(h).state_dict()
    assert {k: tuple(t.shape) for k, t in gen.items()} == generator_shapes(v)


def test_seeded_weights_repeat_and_follow_the_recipe():
    config = tiny_cell("v1-batch").config
    a = fs2_weights(config["acoustic"], 44, config["weights"], 2 ** 31 + 3, "cpu")
    b = fs2_weights(config["acoustic"], 44, config["weights"], 2 ** 31 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["duration_predictor.output_norm.bias"]) == pytest.approx(np.log(7.0))
    assert torch.all(a["embedding.weight"][0] == 0)
    g = generator_weights(config["vocoder"], 5, "cpu")
    w = g["resblocks.0.convs1.0.weight"]
    assert float(w.std()) == pytest.approx(1 / np.sqrt(w[0].numel()), rel=0.1)


def test_reference_synthesis_agrees_with_the_port():
    cell = tiny_cell("v1-batch")
    config = cell.config
    synth, fs2, gen, symbols = program.synthesizer(config, 17, "cpu")
    texts = TextGenerator(17, 14.0, (0.5, 2.0)).texts(5)
    rows = synth.synthesize_many(texts, batch_size=4)
    refs = [synthesize(t, fs2, config["acoustic"], gen, config["vocoder"], symbols, "cpu")
            for t in texts]
    g = gaps(rows, refs)
    assert g["length_mismatches"] == 0 and g["mel_gap"] < 1e-4 and g["wav_gap"] < 1e-4, g


@pytest.mark.parametrize("name", ["v1-batch", "v3-batch", "fs2-train", "v1-open"])
def test_a_tiny_run_is_correct(name):
    r = execute(name, 2 ** 31 + 77, 1.0, False, "cpu", cell=tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}
