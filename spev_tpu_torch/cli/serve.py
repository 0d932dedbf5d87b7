"""HTTP synthesis server on the card (or the CPU).  Counterpart of
``spev_tpu.cli.serve``; a stdlib ``http.server`` endpoint over one
`Synthesizer`:

    python -m spev_tpu_torch.cli.serve --checkpoint best.spev \
        [--hifigan_dir DIR] [--host 127.0.0.1] [--port 8571] [--device cuda]

    POST /synthesize   {"text": "...", "breathiness": 0.2, "roughness": 0.0,
                        "brightness": 0.0, "pitch_scale": 1.0,
                        "duration_scale": 1.0, "energy_scale": 1.0,
                        "emotion": "exhausted" (optional; sets the knobs
                        the fields then override)}
        → audio/wav.  Advanced fields ("nasality", "valence", "arousal",
        "dominance", "age", "lung_capacity", "word_emphasis" as
        "1.0,1.5,...", "speaker") route the request through
        `infer.advanced_api.synthesize_advanced_controls`.
    POST /synthesize_stream   the same body without advanced fields →
        audio/wav with streaming-size RIFF sizes (0xFFFFFFFF), PCM written
        clause by clause as each is synthesized; the closed connection ends
        the stream.
    GET  /healthz      → {"status": "ok", "vocoder": "hifigan"|"griffin-lim",
                          "vocab", "device", "response_cache": {size, max,
                          hits, misses}, "batcher": {max_batch, batches,
                          sizes}, "launches": {kernel: count}}

Concurrent /synthesize requests are coalesced into one device batch
(`infer.batching.CoalescingBatcher`, ``--max_batch``/``--batch_window_ms``).
Identical /synthesize requests (text and controls) are served from an LRU
response cache without the device (``--response_cache``); synthesis is
deterministic per request, so the cached body is the same bytes.  Streaming
requests are never cached.

The device work runs on two long-lived threads: the batcher's worker
(coalesced /synthesize) and one device thread that runs the rest in arrival
order (each streamed clause, advanced requests, /synthesize without a
batcher), while the handler threads only parse, wait and write.  PyTorch
keeps cuDNN's execution plans per thread, so work on a fresh handler thread
would plan every convolution again; two streams still interleave clause by
clause.  Both threads share the Synthesizer: every entry point runs under
``torch.inference_mode()`` and launches on the thread's current stream.
On the card the CUDA kernels are built before the server listens, so the
first requests do not wait on ``nvcc``.  ``launches`` counts the port's
kernel launches in this process (``<wrapper>.launches``).
"""

from __future__ import annotations

import argparse
import collections
import functools
import io
import json
import struct
import sys
import threading
import types
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from spev_tpu_torch.cli.common import cli_guard
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.ops.cuda import kernel_launches

_BASIC = ("breathiness", "roughness", "brightness", "pitch_scale", "duration_scale",
          "energy_scale")
_ADVANCED_FLOATS = ("nasality", "valence", "arousal", "dominance", "age", "lung_capacity")


def _wav_bytes(audio: np.ndarray, sr: int = 22050) -> bytes:
    buf = io.BytesIO()
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _wav_stream_header(sr: int = 22050) -> bytes:
    """RIFF/WAVE header with 0xFFFFFFFF chunk sizes: players read the data
    chunk until the connection closes."""
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


def _pcm16(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1, 1) * 32767.0).astype("<i2").tobytes()


def make_handler(synth, lock: "threading.Lock | None" = None, batcher=None,
                 response_cache: int = 0):
    """The request handler class.  ``lock`` is accepted for the JAX
    package's signature and guards nothing."""
    del lock
    from spev_tpu_torch.agents.prosody import ProsodyPolicy

    policy = ProsodyPolicy()
    device_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="spev-device")

    def on_device(fn, *args, **kwargs):
        return device_thread.submit(fn, *args, **kwargs).result()

    # what stream_text calls, with each clause synthesized on the device thread
    stream_synth = types.SimpleNamespace(synthesize=functools.partial(on_device,
                                                                      synth.synthesize))
    cache: "collections.OrderedDict[str, bytes]" = collections.OrderedDict()
    cache_lock = threading.Lock()
    cache_stats = {"hits": 0, "misses": 0}

    def cache_get(key: str):
        if response_cache <= 0:
            return None
        with cache_lock:
            body = cache.get(key)
            if body is not None:
                cache.move_to_end(key)
                cache_stats["hits"] += 1
            else:
                cache_stats["misses"] += 1
            return body

    def cache_put(key: str, body: bytes):
        if response_cache <= 0:
            return
        with cache_lock:
            cache[key] = body
            cache.move_to_end(key)
            while len(cache) > response_cache:
                cache.popitem(last=False)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._json(404, {"error": "unknown path"})
                return
            health = {
                "status": "ok",
                "vocoder": "hifigan" if synth.vocoder.is_neural else "griffin-lim",
                "vocab": len(synth.vocab),
                "device": str(synth.device),
            }
            if response_cache > 0:
                with cache_lock:
                    health["response_cache"] = {"size": len(cache), "max": response_cache,
                                                **cache_stats}
            if batcher is not None:
                health["batcher"] = batcher.stats()
            health["launches"] = kernel_launches()
            self._json(200, health)

        def _parse_request(self):
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            text = req.get("text", "")
            kw = {}
            if "emotion" in req:
                # ProsodyPolicy.get_knobs falls back to neutral; over HTTP a
                # typo must be the client's error
                if req["emotion"] not in policy.styles:
                    raise UserError(f"unknown emotion {req['emotion']!r}; choose from "
                                    f"{sorted(policy.styles)}")
                knobs = policy.get_knobs(req["emotion"])
                kw = {k: knobs[k] for k in ("breathiness", "roughness", "brightness",
                                            "pitch_scale", "duration_scale")}
            for k in _BASIC:
                if k in req:
                    kw[k] = float(req[k])
            adv = {k: float(req[k]) for k in _ADVANCED_FLOATS if k in req}
            if "word_emphasis" in req:
                adv["word_emphasis"] = str(req["word_emphasis"])
            if "speaker" in req:
                adv["speaker"] = int(req["speaker"])
            return text, kw, adv

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_stream"):
                self._json(404, {"error": "unknown path"})
                return
            streaming_started = False
            try:
                text, kw, adv = self._parse_request()
                if not text.strip():
                    self._json(400, {"error": "missing 'text'"})
                    return
                if adv and self.path == "/synthesize_stream":
                    self._json(400, {"error": "advanced fields are not supported on the "
                                              "streaming endpoint; use /synthesize"})
                    return
                if self.path == "/synthesize":
                    key = json.dumps({"text": text, **kw, **adv}, sort_keys=True)
                    body = cache_get(key)
                    if body is None:
                        if adv:
                            from spev_tpu_torch.infer.advanced_api import (
                                synthesize_advanced_controls)

                            wav, _ = on_device(synthesize_advanced_controls, synth, text,
                                               **kw, **adv)
                        elif batcher is not None:
                            wav, _ = batcher.submit(text, **kw)
                        else:
                            wav, _ = on_device(synth.synthesize, text, **kw)
                        body = _wav_bytes(wav, synth.audio.sample_rate)
                        cache_put(key, body)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # streaming: the header now, PCM per clause; no Content-Length
                from spev_tpu_torch.infer import streaming

                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.end_headers()
                streaming_started = True
                self.wfile.write(_wav_stream_header(synth.audio.sample_rate))
                self.wfile.flush()
                for clause_wav in streaming.stream_text(stream_synth, text, **kw):
                    self.wfile.write(_pcm16(clause_wav))
                    self.wfile.flush()
            except Exception as e:  # a serving endpoint reports and goes on
                if streaming_started:
                    # the 200 and the audio header are on the wire: an error
                    # body would play as PCM, so truncate the stream
                    self.log_message("stream aborted: %s: %s", type(e).__name__, e)
                    self.close_connection = True
                    return
                status = 400 if isinstance(e, (UserError, ValueError, KeyError)) else 500
                try:
                    self._json(status, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass  # the socket is gone; nothing to report

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}", flush=True)

    return Handler


class _Server(ThreadingHTTPServer):
    # a burst of concurrent requests is what the batcher coalesces: the
    # stdlib's listen backlog of 5 would drop the rest of a burst's
    # connections until the client retries a second later
    request_queue_size = 256


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.serve")
    p.add_argument("--checkpoint", required=True, help=".spev or .pt checkpoint")
    p.add_argument("--hifigan_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--g2p", default="auto")
    p.add_argument("--max_batch", type=int, default=16,
                   help="coalesce up to this many concurrent /synthesize requests into one "
                        "device batch (0 disables)")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="how long to wait after the first queued request for a batch to form")
    p.add_argument("--response_cache", type=int, default=256,
                   help="LRU-cache this many /synthesize responses keyed by (text, controls); "
                        "identical requests skip the device (0 disables)")
    p.add_argument("--device", default="cuda")
    return p


@cli_guard
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.utils.platform import resolve_device

    if resolve_device(args.device).type == "cuda":
        from spev_tpu_torch.ops.cuda.build import build_all

        build_all()
    synth = Synthesizer(args.checkpoint, hifigan_dir=args.hifigan_dir, g2p_backend=args.g2p,
                        device=args.device)
    batcher = None
    if args.max_batch > 0:
        from spev_tpu_torch.infer.batching import CoalescingBatcher

        batcher = CoalescingBatcher(synth, max_batch=args.max_batch,
                                    window_ms=args.batch_window_ms)
    server = _Server((args.host, args.port),
                     make_handler(synth, batcher=batcher, response_cache=args.response_cache))
    print(f"spev-serve listening on http://{args.host}:{args.port} "
          f"(device: {synth.device}, vocoder: "
          f"{'hifigan' if synth.vocoder.is_neural else 'griffin-lim'}, "
          f"batching: {args.max_batch if batcher else 'off'})", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
