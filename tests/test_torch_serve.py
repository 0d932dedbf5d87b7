"""The port's HTTP server on the CPU, mirroring the JAX package's
``tests/test_serve.py`` (health check, WAV and streaming bodies, advanced
fields, error paths, the response cache, a soak of mixed requests), plus:
the streaming header and `_wav_bytes` byte-equal to JAX's, and a
/synthesize body's PCM within 1 LSB of JAX's server on the same numpy
weights (a hidden-32 FastSpeech2 and a tiny HiFi-GAN), with and without the
coalescing batcher."""

import contextlib
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spev_tpu.cli import serve as jax_serve
from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.infer.synthesis import Synthesizer as JaxSynth
from spev_tpu.infer.vocoder import Vocoder as JaxVocoder
from spev_tpu.models.fastspeech2 import init_fastspeech2
from spev_tpu.models.hifigan import HiFiGANConfig as JaxHCfg
from spev_tpu.models.hifigan import HiFiGANGenerator as JaxGen
from spev_tpu.models.hifigan import init_hifigan
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.checkpoint import save_checkpoint
from spev_tpu_torch.cli import serve
from spev_tpu_torch.config import ModelConfig
from spev_tpu_torch.infer.batching import CoalescingBatcher
from spev_tpu_torch.infer.synthesis import Synthesizer
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.utils.params import hifigan_state_dict_from_tree

SMALL = dict(embed_dim=32, hidden_dim=32, n_mels=80)
BUCKETS = dict(g2p_backend="rules", phoneme_buckets=(64,), frame_buckets=(256,))
HCFG = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), num_mels=80)


def _checkpoint(path, mel_gain=1.0):
    """A JAX-written .spev (hidden 32), as the JAX package's server tests
    make it; ``mel_gain`` scales the mel head."""
    vocab = JaxVocab.build([chr(c) for c in range(ord("a"), ord("p"))] + [" "])
    cfg = JaxModelConfig(vocab_size=len(vocab), **SMALL)
    params = init_fastspeech2(jax.random.PRNGKey(0), cfg)
    params["duration_predictor"]["output_norm"]["bias"] = jnp.asarray([1.2])
    params["mel_linear"]["weight"] = params["mel_linear"]["weight"] * mel_gain
    save_checkpoint(path, params, vocab=vocab.symbols, stats={})
    return cfg


@contextlib.contextmanager
def _serving(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def _post(base, path, payload, timeout=300):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _health(base):
    with urllib.request.urlopen(base + "/healthz") as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "m.spev")
    _checkpoint(path)
    return path


def _synth(ckpt):
    return Synthesizer(ckpt, hifigan_dir=None, model_cfg=ModelConfig(**SMALL), device="cpu",
                       **BUCKETS)


@pytest.fixture(scope="module")
def server(ckpt):
    with _serving(serve.make_handler(_synth(ckpt), threading.Lock())) as base:
        yield base


def test_healthz(server, ckpt):
    data = _health(server)
    assert data["status"] == "ok" and data["vocoder"] == "griffin-lim"
    assert data["device"] == "cpu" and data["vocab"] == len(_synth(ckpt).vocab)
    assert "response_cache" not in data and "batcher" not in data
    assert set(data["launches"]) == {"lr_fused", "lr_fused_bwd", "fused_log_mel", "overlap_add"}


def test_synthesize_returns_wav(server):
    status, headers, body = _post(server, "/synthesize", {"text": "hello", "emotion": "excited"})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 22050 and w.getnframes() > 0


def test_synthesize_stream_returns_streaming_wav(server, ckpt):
    text = "hello there, good day. another clause here."
    status, headers, body = _post(server, "/synthesize_stream", {"text": text})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert headers.get("Content-Length") is None  # open-ended stream
    assert body[:44] == jax_serve._wav_stream_header(22050) == serve._wav_stream_header(22050)
    pcm = np.frombuffer(body[44:], dtype="<i2")
    # one clause after another, each the Synthesizer's own waveform
    from spev_tpu_torch.infer.streaming import split_clauses

    synth = _synth(ckpt)
    expected = b"".join(serve._pcm16(synth.synthesize(c)[0]) for c in split_clauses(text))
    assert pcm.size > 0 and body[44:] == expected


def test_synthesize_advanced_fields(server):
    """Advanced fields (age, VAD, word_emphasis) route through the advanced
    API and still return a playable WAV."""
    status, headers, body = _post(server, "/synthesize", {
        "text": "hello friend", "age": 60, "valence": 0.5, "lung_capacity": 0.7,
        "word_emphasis": "1.0,1.5", "nasality": 0.2, "arousal": -0.2, "dominance": 0.1})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert w.getnframes() > 0


def test_stream_error_truncates_not_corrupts(server, monkeypatch):
    """A failure after the stream header is on the wire truncates the
    stream; no HTTP error body is appended as PCM."""
    import spev_tpu_torch.infer.streaming as streaming_mod

    def boom_stream(synth, text, **kw):
        yield np.zeros(256, np.float32)
        raise RuntimeError("mid-stream failure")

    monkeypatch.setattr(streaming_mod, "stream_text", boom_stream)
    _, _, body = _post(server, "/synthesize_stream", {"text": "will fail mid stream"})
    assert body[:4] == b"RIFF"
    assert b"HTTP/1.0 500" not in body and b"error" not in body
    assert len(body) == 44 + 256 * 2  # header + exactly one clause of PCM


def test_concurrent_streams_interleave(server, monkeypatch):
    """Stream A yields a clause, then waits until stream B has been
    delivered: both finish, so streams do not queue behind each other."""
    import spev_tpu_torch.infer.streaming as streaming_mod

    b_done = threading.Event()
    chunk = np.full(256, 0.25, np.float32)

    def fake_stream(synth, text, **kw):
        yield chunk
        if "SLOW" in text:
            if not b_done.wait(timeout=60):
                raise RuntimeError("stream B made no progress while A streamed")
            yield chunk

    monkeypatch.setattr(streaming_mod, "stream_text", fake_stream)
    bodies = {}

    def client(name, text):
        bodies[name] = _post(server, "/synthesize_stream", {"text": text}, timeout=120)[2]
        if name == "B":
            b_done.set()

    ta = threading.Thread(target=client, args=("A", "SLOW first stream"))
    tb = threading.Thread(target=client, args=("B", "fast second stream"))
    ta.start()
    time.sleep(0.3)  # A is mid-stream before B arrives
    tb.start()
    ta.join(timeout=120)
    tb.join(timeout=120)
    assert len(bodies["B"]) == 44 + 256 * 2
    assert len(bodies["A"]) == 44 + 2 * 256 * 2


@pytest.mark.parametrize("path,payload,code", [
    ("/synthesize_stream", {"text": "hi", "age": 70}, 400),  # advanced fields
    ("/synthesize_stream", {"text": "hi", "speaker": 1}, 400),
    ("/synthesize", {}, 400),  # missing text
    ("/synthesize", {"text": "   "}, 400),
    ("/synthesize", {"text": "hi", "pitch_scale": "fast"}, 400),  # ValueError
    ("/nope", {"text": "hi"}, 404),
])
def test_bad_requests(server, path, payload, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, path, payload)
    assert e.value.code == code
    assert "error" in json.loads(e.value.read())


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404


def test_unknown_emotion_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/synthesize", {"text": "x", "emotion": "joyful-typo"})
    assert e.value.code == 400
    assert "unknown emotion" in e.value.read().decode()


def test_internal_error_is_500(server, monkeypatch):
    import spev_tpu_torch.infer.advanced_api as adv_mod

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(adv_mod, "synthesize_advanced_controls", boom)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/synthesize", {"text": "hello", "age": 30})
    assert e.value.code == 500 and "RuntimeError" in e.value.read().decode()


def test_response_cache_serves_identical_bytes_and_counts_hits(ckpt):
    """A repeated /synthesize returns the cached body and /healthz counts
    the hit; a different request is a miss (a server of its own, so the
    cache starts empty)."""
    with _serving(serve.make_handler(_synth(ckpt), response_cache=8)) as base:
        b1 = _post(base, "/synthesize", {"text": "hello", "pitch_scale": 1.1})[2]
        b2 = _post(base, "/synthesize", {"text": "hello", "pitch_scale": 1.1})[2]
        assert b1 == b2
        b3 = _post(base, "/synthesize", {"text": "hello hello hello", "pitch_scale": 1.1})[2]
        assert b3 != b1
        assert _health(base)["response_cache"] == {"size": 2, "max": 8, "hits": 1, "misses": 2}


def test_concurrency_soak_mixed_requests(ckpt):
    """Twelve threads fire plain, streaming and repeated requests at one
    server: every response is a 200 WAV, and identical (text, controls)
    give the same bytes fresh or cached."""
    texts = ["alpha one", "bravo two", "charlie three", "delta four"]
    N = 12
    results: list = [None] * N
    errors: list = []
    with _serving(serve.make_handler(_synth(ckpt), threading.Lock(), response_cache=16)) as base:
        def post(i):
            kind, text = i % 3, texts[i % len(texts)]
            try:
                if kind == 2:
                    status, _, body = _post(base, "/synthesize_stream", {"text": text})
                else:
                    status, _, body = _post(base, "/synthesize", {"text": text,
                                                                  "pitch_scale": 1.0})
                assert status == 200
                results[i] = (kind, text, body)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    assert not errors, errors
    by_key: dict = {}
    for kind, text, body in results:
        if kind == 2:
            pcm = body[44:]
        else:
            with wave.open(io.BytesIO(body)) as w:
                assert w.getnframes() > 0 and w.getnchannels() == 1
            by_key.setdefault(text, body)
            assert by_key[text] == body
            pcm = body[44:]
        assert len(pcm) > 0
    assert len(by_key) == len(texts)


def test_wav_bytes_equal_jax():
    rng = np.random.default_rng(0)
    audio = np.concatenate([rng.uniform(-1.2, 1.2, 5000),
                            [1.0, -1.0, 0.99999, -0.99999, 1.5, -1.5, 0.0, 1e-9, -1e-9]])
    for arr in (audio.astype(np.float32), audio):
        assert serve._wav_bytes(arr) == jax_serve._wav_bytes(arr)
        assert serve._wav_bytes(arr, 16000) == jax_serve._wav_bytes(arr, 16000)
        assert serve._pcm16(arr) == jax_serve._pcm16(arr)


def test_synthesize_pcm_matches_jax_server(tmp_path):
    """The same request to the JAX package's server and the port's (plain
    and coalescing) on the same weights with a tiny HiFi-GAN: equal sample
    counts, PCM within 1 LSB."""
    path = str(tmp_path / "m.spev")
    jcfg = _checkpoint(path, mel_gain=30.0)
    hparams = jax.tree.map(lambda a: np.asarray(a) * 10.0,
                           init_hifigan(jax.random.PRNGKey(1), JaxHCfg(**HCFG)))
    js = JaxSynth(path, hifigan_dir=None, model_cfg=jcfg, **BUCKETS)
    js.vocoder = JaxVocoder(generator=JaxGen(JaxHCfg(**HCFG), jax.tree.map(jnp.asarray, hparams)))
    ts = _synth(path)
    gen = HiFiGANGenerator(HiFiGANConfig(**HCFG))
    gen.load_state_dict(hifigan_state_dict_from_tree(hparams, gen.cfg))
    ts.vocoder = Vocoder(generator=gen, device="cpu")
    reqs = [{"text": "hello there", "pitch_scale": 1.2},
            {"text": "good day friend", "breathiness": 0.4, "duration_scale": 1.3},
            {"text": "bye now", "emotion": "angry"}]

    def fire(base, concurrent):
        out = [None] * len(reqs)

        def one(i):
            out[i] = _post(base, "/synthesize", reqs[i])[2]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
            if not concurrent:
                t.join()
        for t in threads:
            t.join(timeout=600)
        return out

    with _serving(jax_serve.make_handler(js)) as base:
        jbodies = fire(base, concurrent=False)
    with _serving(serve.make_handler(ts)) as base:
        tbodies = fire(base, concurrent=False)
    batcher = CoalescingBatcher(ts, max_batch=4, window_ms=200.0)
    with _serving(serve.make_handler(ts, batcher=batcher)) as base:
        cbodies = fire(base, concurrent=True)
        assert _health(base)["batcher"]["sizes"] == {"3": 1}
    for j, t, c in zip(jbodies, tbodies, cbodies):
        assert t[:44] == j[:44] and c[:44] == j[:44]  # same header, so same length
        pj, pt, pc = (np.frombuffer(b[44:], "<i2").astype(np.int32) for b in (j, t, c))
        assert np.abs(pj).mean() > 100  # a waveform far from silence
        assert np.abs(pt - pj).max() <= 1 and np.abs(pc - pj).max() <= 1


def test_device_work_runs_on_one_thread(ckpt, monkeypatch):
    """Streamed clauses, advanced requests and plain requests without a
    batcher all synthesize on the handler's one device thread."""
    synth = _synth(ckpt)
    names = []
    synthesize_ids = synth.synthesize_ids

    def record(*a, **k):
        names.append(threading.current_thread().name)
        return synthesize_ids(*a, **k)

    monkeypatch.setattr(synth, "synthesize_ids", record)
    with _serving(serve.make_handler(synth)) as base:
        calls = [("/synthesize_stream", {"text": "hello there, good day. another clause."}),
                 ("/synthesize_stream", {"text": "one more, and then another one here."}),
                 ("/synthesize", {"text": "plain request"}),
                 ("/synthesize", {"text": "advanced request", "age": 50})]
        threads = [threading.Thread(target=_post, args=(base, *c)) for c in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    from spev_tpu_torch.infer.streaming import split_clauses

    expected = sum(len(split_clauses(p["text"])) for _, p in calls[:2]) + 2
    assert len(names) == expected and {n.split("_")[0] for n in names} == {"spev-device"}
    assert len(set(names)) == 1


def test_main_defaults_to_the_card_and_guards_user_errors(ckpt, tmp_path, monkeypatch):
    import torch

    assert serve.build_parser().parse_args(["--checkpoint", ckpt]).device == "cuda"
    assert serve.main(["--checkpoint", str(tmp_path / "missing.spev"), "--device", "cpu"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--checkpoint", ckpt])
    assert serve._Server.request_queue_size >= 16  # a burst of 16 connections is accepted
