"""Request coalescing for the HTTP endpoint.  Counterpart of
``spev_tpu.infer.batching``.

`CoalescingBatcher` puts concurrent requests into one device batch:

- callers block in `submit(text, **controls)`;
- one worker thread takes the first queued request, waits up to
  ``window_ms`` for more (at most ``max_batch``), and runs them through
  `Synthesizer.synthesize_many` with one scale and quality value per
  request, so mixed controls share one batch;
- each waiter gets its (waveform, mel) or the error; when a batch fails,
  each of its requests is retried alone, so one bad request fails alone;
- `stats()` counts the batches by size, the requests taken and the seconds
  they queued (from `submit` to the close of their batch's window).

Under a profiler the worker's spans are ``spev.batcher.wait`` (blocked for
a first request), ``spev.batcher.collect`` (the window for more) and
``spev.batcher.run`` (the batch, retries included) with
``spev.batcher.prepare`` (padding and controls) inside it.  The client
threads that block in `submit` carry none.

The worker shares the Synthesizer with the handler threads (streaming and
advanced requests).  The model is only read, every entry point runs under
``torch.inference_mode()``, and every launch goes to the thread's current
stream, which no thread changes: the card runs the work in the order it was
queued.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Optional

import numpy as np

from spev_tpu_torch.diag.profiling import span, spanned

_SCALE_KEYS = ("duration_scale", "pitch_scale", "energy_scale")
_QUALITY_KEYS = ("breathiness", "roughness", "brightness")
_DEFAULTS = {"duration_scale": 1.0, "pitch_scale": 1.0, "energy_scale": 1.0,
             "breathiness": 0.1, "roughness": 0.05, "brightness": 0.0}


class _Pending:
    __slots__ = ("text", "controls", "event", "result", "error", "t_submit")

    def __init__(self, text: str, controls: dict):
        self.text = text
        self.controls = controls
        self.t_submit = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class CoalescingBatcher:
    """Batch concurrent synthesis requests onto the device.

    Args:
      synth: a `Synthesizer`.
      max_batch: largest coalesced batch.
      window_ms: how long the worker waits after the first queued request
        for more; 0 still takes whatever is already queued.
    """

    def __init__(self, synth, max_batch: int = 16, window_ms: float = 5.0):
        self.synth = synth
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._sizes: collections.Counter = collections.Counter()
        self._requests = 0
        self._queue_wait_s = 0.0
        self._sizes_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True, name="spev-batcher")
        self._worker.start()

    def submit(self, text: str, timeout: Optional[float] = None, **controls):
        """Block until the request's (waveform, mel) is ready."""
        item = _Pending(text, controls)
        self._q.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("synthesis request timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def stats(self) -> dict:
        """The batches the worker formed and the requests it took:
        ``{"max_batch", "batches", "sizes": {requests in a batch: count},
        "requests", "queue_wait_s"}``, the last the seconds summed over the
        requests from `submit` to the close of the batch that took them."""
        with self._sizes_lock:
            sizes = dict(sorted(self._sizes.items()))
            requests, waited = self._requests, self._queue_wait_s
        return {"max_batch": self.max_batch, "batches": sum(sizes.values()),
                "sizes": {str(k): v for k, v in sizes.items()},
                "requests": requests, "queue_wait_s": waited}

    # -- worker ------------------------------------------------------------

    def _collect(self) -> list:
        with span("spev.batcher.wait"):
            first = self._q.get()  # block for the first request
        batch = [first]
        with span("spev.batcher.collect"):
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    batch.append(self._q.get(timeout=max(remaining, 0.0)))
                except queue.Empty:
                    break
        taken = time.monotonic()
        with self._sizes_lock:
            self._sizes[len(batch)] += 1
            self._requests += len(batch)
            self._queue_wait_s += sum(taken - p.t_submit for p in batch)
        return batch

    def _run_batch(self, batch: list) -> None:
        # pad to the next power of two (capped at max_batch) so the device
        # sees log2(max_batch)+1 batch sizes; the filler rows repeat the
        # shortest request, unless even its phonemes overflow the largest
        # bucket (then the rows would take the serial span path)
        with span("spev.batcher.prepare"):
            n = len(batch)
            tmpl = min(range(n), key=lambda j: len(batch[j].text))
            padded = 1
            while padded < n:
                padded *= 2
            padded = min(padded, self.max_batch)
            try:
                tmpl_phonemes = len(self.synth.g2p.phonemes(batch[tmpl].text))
            except Exception:
                tmpl_phonemes = len(batch[tmpl].text)  # G2P failure: the retry path reports it
            if tmpl_phonemes > self.synth.phoneme_buckets[-1]:
                padded = n
            texts = [p.text for p in batch] + [batch[tmpl].text] * (padded - n)
            merged: dict = {}
            for key in _SCALE_KEYS + _QUALITY_KEYS:
                vals = [p.controls.get(key, _DEFAULTS[key]) for p in batch]
                vals += [vals[tmpl]] * (padded - n)
                merged[key] = np.asarray(vals, np.float32)
        results = self.synth.synthesize_many(texts, batch_size=self.max_batch, **merged)
        for p, r in zip(batch, results[:n]):
            p.result = r

    def _loop(self) -> None:
        while True:
            self._serve(self._collect())

    @spanned("spev.batcher.run")
    def _serve(self, batch: list) -> None:
        try:
            self._run_batch(batch)
        except Exception:
            # retry each request alone so one bad request (a G2P
            # failure, say) does not fail its batchmates
            for p in batch:
                try:
                    self._run_batch([p])
                except Exception as e:
                    p.error = e
        finally:
            for p in batch:
                p.event.set()
