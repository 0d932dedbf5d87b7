"""The port's spans (`diag.profiling.span`) and the batcher's queue-wait
counter, on the CPU with tiny models.

- With no profiler recording, `span` returns one shared no-op and never
  reaches ``record_function``.
- Under a profiler that records every thread: `synthesize_many` emits the
  synthesis, FastSpeech 2 and vocoder spans, nested as the layers call each
  other; a `CoalescingBatcher` emits the batcher's spans on its worker's
  thread; a `Trainer` step fed through `prefetch` emits the training spans.
- `stats()` counts every submitted request, with a queue wait of zero or
  more seconds.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.data.prefetch import prefetch
from spev_tpu_torch.diag import profiling
from spev_tpu_torch.diag.profiling import span
from spev_tpu_torch.infer.batching import CoalescingBatcher
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.text.lexicon import LEXICON
from spev_tpu_torch.text.vocab import Vocab
from spev_tpu_torch.train.trainer import Trainer

from test_torch_train import V, port_cfg, synth_batch

SMALL = dict(embed_dim=32, hidden_dim=32, n_mels=80, n_encoder_layers=1, n_decoder_layers=1)
HCFG = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=80)
TEXTS = ["hi there", "we need to find a new way home", "bye"]
SYNTH_SPANS = ("spev.synth.many", "spev.synth.g2p", "spev.synth.prepare",
               "spev.synth.acoustic", "spev.fs2.encoder", "spev.fs2.variance",
               "spev.fs2.decoder", "spev.vocoder", "spev.synth.fetch")
# child -> the span it runs in
SYNTH_PARENT = {"spev.synth.g2p": "spev.synth.many", "spev.synth.prepare": "spev.synth.many",
                "spev.synth.acoustic": "spev.synth.many", "spev.vocoder": "spev.synth.many",
                "spev.synth.fetch": "spev.synth.many", "spev.fs2.encoder": "spev.synth.acoustic",
                "spev.fs2.variance": "spev.synth.acoustic",
                "spev.fs2.decoder": "spev.synth.acoustic"}


@pytest.fixture(scope="module")
def synth():
    vocab = Vocab.build(set("".join(LEXICON.values())))
    model = FastSpeech2.random_init(ModelConfig(vocab_size=len(vocab), **SMALL))
    sd = model.state_dict()
    sd["duration_predictor.output_norm.bias"].fill_(float(np.log(7.0)))  # 6 frames a phoneme
    s = Synthesizer((sd, vocab.symbols, {}), model_cfg=ModelConfig(**SMALL), device="cpu",
                    g2p_backend="rules", phoneme_buckets=(64,), frame_buckets=(128, 256, 512))
    s.vocoder = Vocoder(generator=HiFiGANGenerator(HiFiGANConfig(**HCFG)), device="cpu")
    return s


def _spans(fn) -> list:
    """(name, thread, start ns, end ns) of every ``spev.*`` range that
    ``fn()`` opened, under a profiler recording every thread."""
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        fn()
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("spev.")]


def _nested(rows: list, parents: dict) -> None:
    """Every child span lies inside a span of its parent's name on its own
    thread."""
    for name, tid, a, b in rows:
        if name in parents:
            assert any(n == parents[name] and t == tid and pa <= a and b <= pb
                       for n, t, pa, pb in rows), name


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = span("spev.a"), span("spev.b")
    assert first is second
    with first:
        pass
    assert profiling.spanned("spev.c")(lambda x: x + 1)(1) == 2


def test_synthesize_many_emits_its_spans_nested(synth):
    rows = _spans(lambda: synth.synthesize_many(TEXTS, batch_size=2))
    names = {r[0] for r in rows}
    assert set(SYNTH_SPANS) <= names, set(SYNTH_SPANS) - names
    assert len({r[1] for r in rows}) == 1  # all on the caller's thread
    _nested(rows, SYNTH_PARENT)
    calls = [r[0] for r in rows]
    assert calls.count("spev.synth.many") == 1 and calls.count("spev.synth.g2p") == 1
    assert calls.count("spev.synth.acoustic") == calls.count("spev.fs2.decoder") == 2


def test_batcher_spans_on_its_worker_and_its_counter(synth):
    batcher = CoalescingBatcher(synth, max_batch=4, window_ms=100.0)
    errors = []

    def client(text):
        try:
            batcher.submit(text, timeout=120)
        except Exception as e:  # noqa: BLE001 - handed to the test
            errors.append(e)

    def drive():
        with span("spev.test.main"):
            threads = [threading.Thread(target=client, args=(t,)) for t in TEXTS]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)

    rows = _spans(drive)
    assert errors == []
    main = {tid for name, tid, _, _ in rows if name == "spev.test.main"}
    worker = {tid for name, tid, _, _ in rows if name.startswith("spev.batcher.")}
    names = {r[0] for r in rows}
    assert {"spev.batcher.collect", "spev.batcher.run", "spev.batcher.prepare"} <= names
    assert len(main) == len(worker) == 1 and main != worker
    assert {tid for name, tid, _, _ in rows if name == "spev.synth.many"} == worker
    _nested(rows, {"spev.batcher.prepare": "spev.batcher.run",
                   "spev.synth.many": "spev.batcher.run"})
    # two requests in turn: the worker's wait for the second opens and
    # closes while the profiler records
    rows = _spans(lambda: (client(TEXTS[0]), client(TEXTS[2])))
    assert errors == []
    assert [r[1] for r in rows if r[0] == "spev.batcher.wait"][:1] == list(worker)
    stats = batcher.stats()
    assert stats["requests"] == len(TEXTS) + 2 == sum(int(k) * v
                                                       for k, v in stats["sizes"].items())
    assert stats["queue_wait_s"] >= 0.0


def test_train_step_through_prefetch_emits_the_training_spans(tmp_path):
    torch.manual_seed(0)
    tr = Trainer(port_cfg(), [f"p{i}" for i in range(V)], {}, ckpt_dir=str(tmp_path / "ckpt"),
                 log_dir=str(tmp_path / "log"), device="cpu")
    feed = prefetch(iter([synth_batch(np.random.default_rng(3))]), depth=1)

    def step():
        tr.train_step(tr.to_device(next(feed)))

    rows = _spans(step)
    names = {r[0] for r in rows}
    expected = {"spev.train.data_wait", "spev.train.to_device", "spev.train.forward",
                "spev.train.backward", "spev.train.update", "spev.train.host_read",
                "spev.fs2.encoder", "spev.fs2.variance", "spev.fs2.decoder"}
    assert expected <= names, expected - names
    _nested(rows, {"spev.train.host_read": "spev.train.update",
                   "spev.fs2.encoder": "spev.train.forward",
                   "spev.fs2.decoder": "spev.train.forward"})
    assert tr.step == 1
