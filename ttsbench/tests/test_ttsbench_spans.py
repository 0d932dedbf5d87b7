"""The program's spans in a traced window (`lib/spans.py`) and the probe that
reads them (`span_probe.py`), on the CPU.

- Hand-made events pin the attribution rules: a launch goes to the innermost
  span open on its thread, a launch from a thread with none to the innermost
  span most recently opened on any thread, and each idle instant to the span
  open then on the thread that launched the last operation; idle seconds add
  up to the window's.
- A real trace holding the benchmark's ranges and the program's gives every
  `trace.reduce` key the value it has with the program's ranges dropped, and
  each span's self time is at most its host time.
- The probe, on a tiny open-loop and a tiny training cell, reads the
  batcher's spans and counter and the training spans.
"""

import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ttsbench.lib import spans
from ttsbench.lib.runner import execute
from ttsbench.lib.trace import WINDOW, reduce
from ttsbench.tests.tiny import tiny_cell

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
SEED = 2 ** 31 + 9191


class _Event:
    def __init__(self, name, tid, a, b, device=CPU, annotation=False, corr=0):
        self._v = (name, tid, a, b, device, annotation, corr)

    def name(self):
        return self._v[0]

    def start_thread_id(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]


def _range(name, tid, a, b):
    return _Event(name, tid, a, b, annotation=True)


def _op(a, b, corr, tid, t_launch):
    return [_Event("kernel", 0, a, b, device=CUDA, corr=corr),
            _Event("cudaLaunchKernel", tid, t_launch, t_launch + 1, corr=corr)]


def _made_up():
    """Thread 1 holds spev.a [100, 600) with spev.b [200, 300) inside; thread
    2 (autograd's, say) holds none.  Four operations: one launched in a, one
    in b, one from thread 2 while a is open, one with no span open."""
    ev = [_range(WINDOW, 1, 0, 1000), _range("spev.a", 1, 100, 600),
          _range("spev.b", 1, 200, 300), _range("bench.call", 1, 50, 900)]
    ev += _op(150, 250, 1, 1, 120) + _op(320, 400, 2, 1, 250)
    ev += _op(450, 500, 3, 2, 420) + _op(700, 800, 4, 1, 650)
    return ev


def test_attribution_rules_on_made_up_events():
    r = spans.reduce_spans(_made_up())
    ns = 1e-9
    assert r["window_s"] == pytest.approx(1000 * ns) and r["busy_s"] == pytest.approx(330 * ns)
    assert r["span_host_s"] == pytest.approx({"spev.a": 500 * ns, "spev.b": 100 * ns})
    assert r["span_self_s"] == pytest.approx({"spev.a": 400 * ns, "spev.b": 100 * ns})
    assert r["span_calls"] == {"spev.a": 1, "spev.b": 1}
    assert r["span_device_s"] == pytest.approx({"spev.a": 150 * ns, "spev.b": 80 * ns})
    assert r["adopted_device_s"] == pytest.approx(50 * ns)
    assert r["owned_device_s"] == pytest.approx(230 * ns)
    # [0,150) nothing open at its start: the next launcher's, nothing then a;
    # [250,300) b then a to 320; [400,450) a; [500,700) thread 2 launched
    # last and holds no span: thread 1's a, then nothing; [800,1000) nothing
    assert r["span_idle_s"] == pytest.approx({spans.OUTSIDE: 400 * ns, "spev.b": 50 * ns,
                                              "spev.a": 220 * ns})
    assert sum(r["span_idle_s"].values()) == pytest.approx(r["window_s"] - r["busy_s"])
    assert [n for n, _ in spans.largest(r["span_idle_s"], 2)] == [spans.OUTSIDE, "spev.a"]


def test_a_child_that_outlasts_its_parent_is_cut_at_its_end():
    segs = spans._timeline([(0, 10, "p"), (4, 12, "c")])
    assert [(a, b, n) for a, b, n, _ in segs] == [(0, 4, "p"), (4, 10, "c")]


def _window(events):
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: events)))
    return types.SimpleNamespace(prof=prof)


def test_the_program_spans_leave_every_reduce_key_as_it_was():
    def work(n):
        with spans_open("spev.layer"):
            with spans_open("spev.inner"):
                torch.ones(n).cumsum(0)
            torch.ones(n).sum()

    def spans_open(name):
        return record_function(name)

    def worker():
        with record_function("bench.worker"):
            work(2000)

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=spans.every_thread_config()) as prof:
        with record_function(WINDOW):
            with record_function("bench.call"):
                t = threading.Thread(target=worker)
                t.start()
                work(1000)
                t.join()
    events = list(prof.profiler.kineto_results.events())
    kept = [e for e in events if not e.name().startswith(spans.PREFIX)]
    assert len(kept) < len(events)
    names = {"bench.call", "bench.worker"}
    assert reduce(_window(events), names) == reduce(_window(kept), names)

    r = spans.reduce_spans(events)
    assert r["span_calls"] == {"spev.layer": 2, "spev.inner": 2}
    for name, host in r["span_host_s"].items():
        assert 0 <= r["span_self_s"][name] <= host
    assert r["span_self_s"]["spev.inner"] == pytest.approx(r["span_host_s"]["spev.inner"])
    assert sum(r["span_idle_s"].values()) == pytest.approx(r["window_s"], rel=1e-6)


def test_readers_find_nothing_without_the_spans_or_the_counter():
    parent = {"max_batch": 4, "batches": 1, "sizes": {"2": 1}}
    for ctx in ({}, {"trace": {}, "audio_s": 5.0, "steps": 3},
                {"batcher_stats": (parent, parent)}):
        assert all(fn(ctx) is None for fn in spans.READERS.values())
    before = dict(parent, requests=2, queue_wait_s=0.5)
    after = dict(parent, requests=6, queue_wait_s=0.9)
    assert spans.queue_wait_ms({"batcher_stats": (before, after)}) == pytest.approx(100.0)
    sp = {"window_s": 2.0, "span_host_s": {spans.BATCHER_WAIT: 1.0},
          "span_idle_s": {spans.BATCHER_WAIT: 0.6, spans.OUTSIDE: 0.1, "spev.batcher.run": 0.2,
                          "spev.synth.many": 0.1}}
    assert spans.queued_idle({"spans": sp}) == pytest.approx(15.0)


@pytest.fixture
def probe(monkeypatch):
    from ttsbench import span_probe

    return span_probe, span_probe.instrument(monkeypatch.setattr)


def test_the_probe_reads_the_batcher_on_its_worker(probe):
    span_probe, seen = probe
    r = span_probe.probed(execute("v1-open", SEED, 1.0, True, "cpu",
                                  cell=tiny_cell("v1-open")), seen)
    assert r["correct"] is True, r["checks"]
    sp = r["spans"]
    assert {"spev.batcher.run", "spev.batcher.prepare", "spev.synth.many",
            "spev.synth.acoustic", "spev.vocoder"} <= set(sp["span_host_s"])
    before, after = sp["batcher_stats"]
    assert after["requests"] > before["requests"]
    assert r["span_metrics"]["queue_wait_ms.open"] >= 0.0
    assert r["traced_end_to_end"]["latency_p95_ms"] > 0.0
    # the benchmark's own ranges on the worker are recorded now too
    assert seen["ctx"]["trace"]["host_calls"]["Synthesizer.synthesize_many"] >= 1


def test_the_probe_reads_the_training_spans(probe):
    span_probe, seen = probe
    r = span_probe.probed(execute("fs2-train", SEED, 1.0, True, "cpu",
                                  cell=tiny_cell("fs2-train")), seen)
    assert r["correct"] is True, r["checks"]
    assert {"spev.train.data_wait", "spev.train.to_device", "spev.train.forward",
            "spev.train.backward", "spev.train.update", "spev.train.host_read"} <= set(
        r["spans"]["span_host_s"])
    assert r["span_metrics"]["data_wait_ms_per_step.train"] >= 0.0
    assert "backward_device_ms_per_step.train" not in r["span_metrics"]  # no device here
