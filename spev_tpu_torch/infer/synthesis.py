"""End-to-end synthesis: text → phoneme ids → FastSpeech2 → HiFi-GAN or
Griffin-Lim → waveform.  Counterpart of ``spev_tpu.infer.synthesis``.

- `Synthesizer` loads the checkpoint once and serves requests on its device
  (the card by default).  Phoneme counts are padded to static buckets and
  the frame axis to frame buckets; the acoustic pass starts at a bucket
  estimated from a frames-per-phoneme figure and is re-run one bucket up
  when the length regulator saturated.  The vocoder then runs at the
  smallest bucket that holds the utterance; HiFi-GAN masks by ``mel_len``,
  so bucket padding is invisible.
- Text longer than the largest phoneme bucket is synthesized span by span.
- `synthesize_many` batches texts by phoneme bucket (HiFi-GAN) with
  adaptive per-group frame buckets; Griffin-Lim stays per request.  With
  ``two_phase=True`` each group goes through `synthesize_batch_two_phase`:
  the acoustic pass batched at the largest frame bucket, one host read of
  the frame counts, then the vocoder per group of rows at a right-sized
  frame count.
- With ``mesh`` (`spev_tpu_torch.parallel.make_mesh` over local devices),
  `synthesize_batch` and so `synthesize_many` split each batch's rows over
  the mesh's data axis: one acoustic model and one vocoder replica per
  device, the rows gathered back in order on the first device.
- `infer_tts` is the reference's one-shot function.

PyTorch runs eagerly: there is no graph cache.  The public entry points run
under ``torch.inference_mode()`` (thread-local, so each serving thread
enters it itself).  Checkpoints are a
``(params, vocab, stats)`` tuple (params a JAX-package parameter tree or the
port's state dict), a reference ``.pt`` file or a ``.spev`` file (the JAX
package's format).  A model with the advanced extras (VAD projection,
speaker table) takes ``speaker_id`` and ``vad`` per request.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spev_tpu_torch.config import AudioConfig, ModelConfig
from spev_tpu_torch.diag.profiling import span, spanned
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.infer.vocoder import Vocoder
from spev_tpu_torch.models.advanced import apply_advanced
from spev_tpu_torch.models.fastspeech2 import FastSpeech2
from spev_tpu_torch.parallel.mesh import Mesh, rows_of
from spev_tpu_torch.text.g2p import G2P
from spev_tpu_torch.text.vocab import Vocab, pad_to_bucket, pick_bucket
from spev_tpu_torch.utils.params import (fastspeech2_state_dict_from_tree, read_checkpoint,
                                         unpack_checkpoint)
from spev_tpu_torch.utils.platform import resolve_device

DEFAULT_PHONEME_BUCKETS = (64, 128, 256)
DEFAULT_FRAME_BUCKETS = (256, 512, 1024, 2048)


def pcm16_host(wav: np.ndarray) -> np.ndarray:
    """float waveform → int16 PCM (clip to [-1, 1], scale by 32767,
    truncate toward zero)."""
    return (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)


def _pcm16_device(wav: torch.Tensor) -> torch.Tensor:
    """The same conversion on the device, so only int16 crosses to the host."""
    return (wav.to(torch.float32).clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


def _fetch(*tensors):
    with span("spev.synth.fetch"):
        return [t.cpu().numpy() for t in tensors]


class Synthesizer:
    """TTS serving stack on one device."""

    def __init__(
        self,
        checkpoint,
        hifigan_dir: Optional[str] = None,
        audio: AudioConfig = AudioConfig(),
        model_cfg: Optional[ModelConfig] = None,
        g2p_backend: str = "auto",
        phoneme_buckets: Sequence[int] = DEFAULT_PHONEME_BUCKETS,
        frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        """checkpoint: a ``.pt`` or ``.spev`` path or a ``(params, vocab,
        stats)`` tuple.  model_cfg: the architecture; when None, the
        ``model_config`` the file carries (the port's trainer and the JAX
        package write it), else the default `ModelConfig`; vocab_size comes
        from the vocab.
        device: "cuda" (the default) raises when no GPU is present; pass
        "cpu" to run on the CPU.
        mesh: a mesh over local devices with a 'data' axis; batched serving
        (`synthesize_batch`, `synthesize_many`) then splits each batch over
        it, whose size must divide by the axis.  The model lives on the
        mesh's first device (``device`` is not used) and a replica on each
        other one, placed here."""
        if mesh is not None and mesh.group is not None:
            raise UserError("Synthesizer(mesh=...) splits batches over local devices; a mesh "
                            "over a process group serves nothing")
        self.mesh = mesh
        self._devices = (None if mesh is None
                         else list(mesh.devices.reshape(mesh.data_size, -1)[:, 0]))
        self.device = self._devices[0] if mesh is not None else resolve_device(device)
        stored = None
        if isinstance(checkpoint, tuple):
            params, vocab, stats = checkpoint
            sd = (params if "embedding.weight" in params
                  else fastspeech2_state_dict_from_tree(params))
        else:
            ckpt = read_checkpoint(checkpoint)
            sd, vocab, stats = unpack_checkpoint(ckpt)
            stored = ckpt.get("model_config")
        if model_cfg is None:
            model_cfg = ModelConfig.from_dict(stored) if stored else ModelConfig()
        self.vocab = Vocab(vocab)
        self.stats = stats
        self.audio = audio
        self.model_cfg = dataclasses.replace(model_cfg, vocab_size=len(self.vocab))
        self.model = FastSpeech2(self.model_cfg)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        self.model.to(self.device).eval()
        # one acoustic replica per further data position of the mesh; the
        # vocoder's are made on first use (the vocoder may be swapped)
        self._replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                         for d in (self._devices or [])[1:]]
        self._voc_replicas: Optional[tuple] = None
        self.g2p = G2P(g2p_backend)
        self.vocoder = Vocoder(hifigan_dir, audio=audio, device=self.device)
        self.phoneme_buckets = tuple(sorted(phoneme_buckets))
        self.frame_buckets = tuple(sorted(frame_buckets))
        # guards the frames-per-phoneme read-modify-write across threads
        self._fpp_lock = threading.Lock()
        # frames-per-phoneme estimate for adaptive frame buckets: seeded from
        # the checkpoint's dataset stats when present, then tracked from
        # observed requests
        try:
            self._fpp = float((stats or {}).get("frames_per_phoneme", 10.0))
        except (TypeError, AttributeError):
            self._fpp = 10.0

    @property
    def has_advanced(self) -> bool:
        """Whether the model carries the advanced extras (``advanced.*``)."""
        return self.model.advanced is not None

    # -- device passes -------------------------------------------------------

    def _tensor(self, v, dtype=torch.float32):
        return None if v is None else torch.as_tensor(np.asarray(v), dtype=dtype,
                                                      device=self.device)

    def _control(self, value, B: int):
        """A d/p/e control: a scalar (whole batch) or one value per request,
        broadcast as (B, 1) against (B, P) predictions."""
        arr = np.asarray(value, np.float32)
        if arr.ndim == 0:
            return float(arr)
        if arr.shape != (B,):
            raise UserError(f"per-request control must be a scalar or a length-{B} "
                            f"vector; got shape {arr.shape}")
        return self._tensor(arr).reshape(B, 1)

    @torch.inference_mode()
    @spanned("spev.synth.acoustic")
    def _acoustic(self, M: int, ids, lengths, breath, rough, bright, d, p, e, nasal=None,
                  speaker_ids=None, vad=None, model=None):
        """FastSpeech2 (``model``, by default the served one) at frame bucket
        M (with the speaker / VAD encoder bias of `apply_advanced` when
        either is given), then the pre-vocoder hygiene: NaN → -5 and clip to
        [-10, 2].  Returns (mel (B, M, n_mels), mel_len)."""
        kw = dict(target_breath=breath, target_rough=rough, target_bright=bright,
                  d_control=d, p_control=p, e_control=e)
        if nasal is not None:
            kw["target_nasal"] = nasal
        out = apply_advanced(model or self.model, ids, lengths, M, speaker_ids=speaker_ids,
                             vad=vad, **kw)
        mel = torch.nan_to_num(out["mel_pred"], nan=-5.0).clamp(-10.0, 2.0)
        return mel, out["mel_len"]

    # -- public API ------------------------------------------------------------

    def phonemes_to_ids(self, phones) -> np.ndarray:
        return self.vocab.encode(phones, fallback=1)

    @torch.inference_mode()
    def synthesize_batch_two_phase(
        self,
        ids_batch: np.ndarray,
        lengths: np.ndarray,
        breath: Optional[np.ndarray] = None,
        rough: Optional[np.ndarray] = None,
        bright: Optional[np.ndarray] = None,
        duration_scale=1.0,
        pitch_scale=1.0,
        energy_scale=1.0,
        frame_bucket: Optional[int] = None,
        quantum: int = 256,
    ):
        """Batched synthesis with a right-sized vocoder (HiFi-GAN only).

        Phase 1 runs the acoustic model batched at the frame bucket (the
        largest by default); the host reads ``mel_len`` once; phase 2
        groups the rows by ``ceil(L/quantum)·quantum`` frames and vocodes
        each group at that length, its batch padded to a power of two by
        repeating its last row.  The rows are gathered on the device (frame
        slice, mel floor past ``mel_len``), so only the (B,) lengths cross
        to the host before the outputs.  Returns a list of (wav, mel) rows."""
        if not self.vocoder.is_neural:
            raise ValueError("two-phase batching requires a HiFi-GAN vocoder")
        B, _ = np.shape(ids_batch)
        M = frame_bucket or self.frame_buckets[-1]
        mel, mel_len = self._acoustic(
            M, self._tensor(ids_batch, torch.long), self._tensor(lengths, torch.int32),
            self._tensor(breath), self._tensor(rough), self._tensor(bright),
            self._control(duration_scale, B), self._control(pitch_scale, B),
            self._control(energy_scale, B),
        )
        lens = mel_len.cpu().numpy()  # the batch's one host read (B ints)
        groups: dict = {}
        for b, L in enumerate(lens):
            Mv = min(int(np.ceil(max(int(L), 1) / quantum)) * quantum, M)
            groups.setdefault(Mv, []).append(b)
        floor = torch.tensor(self.audio.mel_clip_min, device=mel.device)
        wav_groups = []
        for Mv, rows in sorted(groups.items()):
            Bp = 1 << (len(rows) - 1).bit_length()  # power-of-two batches bound the shapes
            idx = torch.as_tensor(rows + [rows[-1]] * (Bp - len(rows)), device=mel.device)
            g_len = mel_len.index_select(0, idx)
            g_mel = mel.index_select(0, idx)[:, :Mv]
            frames = torch.arange(Mv, device=mel.device)
            g_mel = torch.where((frames[None, :] < g_len[:, None])[..., None], g_mel, floor)
            wav_groups.append((rows, self.vocoder.run(g_mel, g_len)))
        hop = self.vocoder.generator.cfg.hop_recovery
        mel_np = mel.cpu().numpy()
        results: list = [None] * B
        for rows, wav_dev in wav_groups:
            wav = wav_dev.cpu().numpy()
            for pos, b in enumerate(rows):
                L = int(lens[b])
                results[b] = (wav[pos, : L * hop], mel_np[b, :L])
        return results

    def synthesize_batch(
        self,
        ids_batch: np.ndarray,
        lengths: np.ndarray,
        breath: Optional[np.ndarray] = None,
        rough: Optional[np.ndarray] = None,
        bright: Optional[np.ndarray] = None,
        duration_scale=1.0,
        pitch_scale=1.0,
        energy_scale=1.0,
        frame_bucket: Optional[int] = None,
    ):
        """Batched synthesis at one frame bucket (HiFi-GAN only): ids (B, P)
        → (wav (B, M·hop), mel (B, M, n_mels), mel_len (B,)) as device
        tensors; slice each row with mel_len on the host.  The scales are a
        scalar or one value per request."""
        if not self.vocoder.is_neural:
            raise ValueError("synthesize_batch requires a HiFi-GAN vocoder")
        B, _ = np.shape(ids_batch)
        M = frame_bucket or self.frame_buckets[-1]
        with span("spev.synth.prepare"):
            args = (self._tensor(ids_batch, torch.long), self._tensor(lengths, torch.int32),
                    self._tensor(breath), self._tensor(rough), self._tensor(bright),
                    self._control(duration_scale, B), self._control(pitch_scale, B),
                    self._control(energy_scale, B))
        if self.mesh is not None and self.mesh.data_size > 1:
            return self._synthesize_batch_mesh(M, args)
        mel, mel_len = self._acoustic(M, *args)
        return self.vocoder.run(mel, mel_len), mel, mel_len

    @torch.inference_mode()
    def _synthesize_batch_mesh(self, M: int, args: tuple):
        """`synthesize_batch` split by rows over the mesh's data axis: each
        device runs its replicas on its rows of every per-row argument (the
        work is queued on every device before any result is gathered), then
        the outputs are concatenated in row order on the first device."""
        N = self.mesh.data_size
        per_row = {i: a for i, a in enumerate(args) if torch.is_tensor(a)}
        gens = self._vocoder_replicas()
        outs = []
        for k, dev in enumerate(self._devices):
            part = rows_of(per_row, k, N)
            shard = [part[i].to(dev) if i in part else a for i, a in enumerate(args)]
            mel, mel_len = self._acoustic(M, *shard, model=self._replicas[k])
            outs.append((gens[k](mel, mel_len), mel, mel_len))
        return tuple(torch.cat([o[j].to(self.device) for o in outs]) for j in range(3))

    def _vocoder_replicas(self) -> list:
        """The HiFi-GAN generator and one copy on each further data position
        of the mesh, made once per generator."""
        gen = self.vocoder.generator
        if self._voc_replicas is None or self._voc_replicas[0] is not gen:
            self._voc_replicas = (gen, [gen] + [copy.deepcopy(gen).to(d).eval()
                                                for d in self._devices[1:]])
        return self._voc_replicas[1]

    @torch.inference_mode()
    def synthesize_ids(
        self,
        ids: np.ndarray,
        breath: Optional[np.ndarray] = None,
        rough: Optional[np.ndarray] = None,
        bright: Optional[np.ndarray] = None,
        duration_scale=1.0,
        pitch_scale=1.0,
        energy_scale=1.0,
        frame_bucket: Optional[int] = None,
        nasal: Optional[np.ndarray] = None,
        speaker_id: Optional[int] = None,
        vad: Optional[Sequence[float]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ids (n_ph,) → (waveform, log-mel (L, n_mels)).

        The scales may be scalars or per-phoneme (n_ph,) vectors (the word
        emphasis path).  speaker_id and vad (valence, arousal, dominance)
        engage the advanced model's learned conditioning.  Ids longer
        than the largest phoneme bucket are synthesized in bucket-sized spans
        (every per-phoneme track sliced alike) and concatenated; span k+1 is
        dispatched before span k is fetched."""
        n_ph = len(ids)
        p_max = self.phoneme_buckets[-1]
        kw = dict(breath=breath, rough=rough, bright=bright, nasal=nasal,
                  duration_scale=duration_scale, pitch_scale=pitch_scale,
                  energy_scale=energy_scale)
        cond = dict(frame_bucket=frame_bucket, speaker_id=speaker_id, vad=vad)
        if n_ph <= p_max:
            return self._ids_finish(self._ids_dispatch(ids, **cond, **kw))

        def cut(v, sl):
            return v if v is None or np.ndim(v) == 0 else np.asarray(v)[sl]

        pending, wavs, mels = None, [], []
        for s in range(0, n_ph, p_max):
            sl = slice(s, min(s + p_max, n_ph))
            pend = self._ids_dispatch(ids[sl], **cond,
                                      **{k: cut(v, sl) for k, v in kw.items()})
            if pending is not None:
                w, m = self._ids_finish(pending)
                wavs.append(w)
                mels.append(m)
            pending = pend
        w, m = self._ids_finish(pending)
        wavs.append(w)
        mels.append(m)
        return np.concatenate(wavs), np.concatenate(mels, axis=0)

    def _update_fpp(self, obs: float, escalated: bool) -> None:
        """Track the frames-per-phoneme estimate from an observed worst-row
        ratio: on escalation jump straight to it (+10%), so a mismatched
        checkpoint pays the saturate→escalate double synthesis at most once;
        otherwise relax by an EMA.  Locked: concurrent threads must not lose
        an upward jump."""
        with self._fpp_lock:
            if escalated:
                self._fpp = max(self._fpp, obs * 1.1, 1.0)
            else:
                self._fpp = max(0.7 * self._fpp + 0.3 * obs * 1.1, 1.0)

    def _ids_dispatch(self, ids, breath=None, rough=None, bright=None, duration_scale=1.0,
                      pitch_scale=1.0, energy_scale=1.0, frame_bucket=None, nasal=None,
                      speaker_id=None, vad=None) -> dict:
        """Stage 1 of a single-utterance request: pad the inputs and run the
        acoustic pass at the estimated frame bucket (the device works
        asynchronously until `_ids_finish` reads the frame count)."""
        n_ph = len(ids)
        P = pick_bucket(n_ph, self.phoneme_buckets)
        n_spk = self.model_cfg.n_speakers
        if speaker_id is not None and n_spk > 1 and not 0 <= int(speaker_id) < n_spk:
            raise UserError(f"speaker {speaker_id} is out of range for a checkpoint with "
                            f"{n_spk} speakers")

        def ctl(v):
            if v is None:
                return None
            arr = np.zeros((1, P), np.float32)
            arr[0, :n_ph] = v
            return self._tensor(arr)

        def scale(v):
            # a vector pads to the bucket with zeros (zero duration there)
            if np.ndim(v) == 0:
                return float(v)
            arr = np.zeros((1, P), np.float32)
            arr[0, :n_ph] = np.asarray(v, np.float32)[:n_ph]
            return self._tensor(arr)

        args = (
            self._tensor(pad_to_bucket(ids, P, self.vocab.pad_id)[None], torch.long),
            self._tensor([n_ph], torch.int32),
            ctl(breath), ctl(rough), ctl(bright),
            scale(duration_scale), scale(pitch_scale), scale(energy_scale),
            ctl(nasal) if self.model_cfg.use_nasality else None,
            None if speaker_id is None else self._tensor([speaker_id], torch.long),
            None if vad is None else self._tensor([list(vad)]),
        )
        # buckets from the frames-per-phoneme estimate upward: short requests
        # never pay for the largest bucket, long spans skip the small ones
        if frame_bucket:
            buckets = [frame_bucket]
        else:
            d_sc = float(np.max(duration_scale))
            est = int(np.ceil(n_ph * self._fpp * max(d_sc, 0.1))) + 16
            start = pick_bucket(min(est, self.frame_buckets[-1]), self.frame_buckets)
            buckets = [b for b in self.frame_buckets if b >= start]
        mel, mel_len = self._acoustic(buckets[0], *args)
        return {"args": args, "n_ph": n_ph, "buckets": buckets, "frame_bucket": frame_bucket,
                "d_scale": float(np.max(duration_scale)), "mel": mel, "mel_len": mel_len}

    def _ids_finish(self, pend: dict) -> Tuple[np.ndarray, np.ndarray]:
        """Stage 2: read the frame count, escalate on saturation, calibrate
        the estimate, vocode at the right-sized bucket, fetch."""
        args, n_ph, buckets = pend["args"], pend["n_ph"], pend["buckets"]
        mel, mel_len = pend["mel"], pend["mel_len"]
        for k, M_ac in enumerate(buckets):
            if k > 0:
                mel, mel_len = self._acoustic(M_ac, *args)
            L = int(mel_len[0])  # the request's one host sync
            if L < M_ac or M_ac == buckets[-1]:
                break
        if pend["frame_bucket"] is None and L < M_ac:
            obs = L / max(n_ph, 1) / max(pend["d_scale"], 0.1)
            self._update_fpp(obs, escalated=M_ac > buckets[0])
        M_voc = pick_bucket(L, self.frame_buckets)
        # re-bucket the mel for the vocoder, padded with the mel floor
        frames = torch.arange(M_voc, device=mel.device)
        mel_v = torch.where((frames[None, :] < mel_len[:, None])[..., None], mel[:, :M_voc],
                            torch.tensor(self.audio.mel_clip_min, device=mel.device))
        hop = (self.vocoder.generator.cfg.hop_recovery if self.vocoder.is_neural
               else self.audio.hop_length)
        wav = self.vocoder.run(mel_v, mel_len)
        wav_s, mel_s = _fetch(wav[0, : L * hop], mel[0, :L])
        return wav_s, mel_s

    @torch.inference_mode()
    @spanned("spev.synth.many")
    def synthesize_many(
        self,
        texts: Sequence[str],
        batch_size: int = 16,
        frame_bucket: Optional[int] = None,
        two_phase: bool = False,
        want_mel: bool = True,
        pcm16: bool = False,
        **controls,
    ):
        """Batched synthesis over many texts: phonemized, sorted by length,
        grouped by phoneme bucket and run through `synthesize_batch`
        (HiFi-GAN); Griffin-Lim stays per request.  Returns (waveform, mel)
        rows in input order.

        With ``frame_bucket`` None each group picks its frame bucket from its
        phoneme count and the frames-per-phoneme estimate; a group whose
        length regulator saturated is re-run one bucket up.  Group k+1 is
        dispatched before group k is fetched.  ``two_phase=True`` sends each
        group, at the largest frame bucket (or ``frame_bucket``), through
        `synthesize_batch_two_phase`.

        controls: duration/pitch/energy_scale (scalar or one per text) and
        breathiness/roughness/brightness (scalar or one per text).
        ``want_mel=False`` returns None mels; ``pcm16=True`` returns int16
        waveforms (converted on the device on the fused batched path, on the
        host on the others)."""
        with span("spev.synth.g2p"):
            phones = [self.g2p.phonemes(t) for t in texts]
            ids_list = [self.phonemes_to_ids(p) for p in phones]
        results: list = [None] * len(texts)

        def _post(row):
            wav, mel = row
            return (pcm16_host(wav) if pcm16 else wav, mel if want_mel else None)

        # voice-quality scalars become row-constant per-phoneme tracks
        quality = {}
        for name, track in (("breathiness", "breath"), ("roughness", "rough"),
                            ("brightness", "bright")):
            if name in controls:
                v = np.asarray(controls.pop(name), np.float32)
                if v.ndim not in (0, 1) or (v.ndim == 1 and len(v) != len(texts)):
                    raise ValueError(f"per-request {name} must be a scalar or one value "
                                     f"per text ({len(texts)}); got shape {v.shape}")
                quality[track] = np.broadcast_to(v, (len(texts),))
        if not self.vocoder.is_neural:
            for i, ids in enumerate(ids_list):
                row_q = {t: np.full((len(ids),), q[i], np.float32) for t, q in quality.items()}
                row_c = {k: (float(np.asarray(v, np.float32)[i])
                             if k.endswith("_scale") and np.ndim(v) == 1 else v)
                         for k, v in controls.items()}
                results[i] = _post(self.synthesize_ids(ids, **row_q, **row_c))
            return results

        hop = self.vocoder.generator.cfg.hop_recovery
        M = frame_bucket or self.frame_buckets[-1]
        per_req = {}
        for k in ("duration_scale", "pitch_scale", "energy_scale"):
            v = controls.get(k)
            if v is not None and np.ndim(v) == 1:
                v = np.asarray(v, np.float32)
                if len(v) != len(texts):
                    raise ValueError(f"per-request {k} must have one value per text "
                                     f"({len(texts)}); got {len(v)}")
                per_req[k] = v
        # texts beyond the largest phoneme bucket go through synthesize_ids'
        # span chunking with the same control semantics
        p_cap = self.phoneme_buckets[-1]
        long_set = {i for i in range(len(texts)) if len(ids_list[i]) > p_cap}
        if long_set:
            extra = set(controls) - {"duration_scale", "pitch_scale", "energy_scale"}
            if extra:
                raise UserError(
                    f"controls {sorted(extra)} are not supported for texts longer than "
                    f"the {p_cap}-phoneme bucket; synthesize those via synthesize_ids"
                )
        for i in long_set:
            n_i = len(ids_list[i])
            row_kw = {t: np.full((n_i,), q[i], np.float32) for t, q in quality.items()}
            for k in ("duration_scale", "pitch_scale", "energy_scale"):
                if k in per_req:
                    row_kw[k] = float(per_req[k][i])
                elif k in controls:
                    row_kw[k] = float(np.asarray(controls[k]))
            results[i] = _post(self.synthesize_ids(ids_list[i], frame_bucket=frame_bucket,
                                                   **row_kw))
        order = sorted((i for i in range(len(texts)) if i not in long_set),
                       key=lambda i: len(ids_list[i]))

        def _finish(pend):
            """Fetch a dispatched group, escalate if it saturated, calibrate
            the estimate and write its rows."""
            group, ids_b, lens, g_controls, M_group, outs = pend
            escalated = False
            while True:
                wav, mel, mel_len = outs
                if pcm16:
                    wav = _pcm16_device(wav)
                if want_mel:
                    wav, mel, mel_len = _fetch(wav, mel, mel_len)
                else:
                    wav, mel_len = _fetch(wav, mel_len)
                # mel_len == bucket: the length regulator may have truncated
                if (frame_bucket is not None or M_group >= self.frame_buckets[-1]
                        or (mel_len < M_group).all()):
                    break
                escalated = True
                M_group = self.frame_buckets[self.frame_buckets.index(M_group) + 1]
                outs = self.synthesize_batch(ids_b, lens, frame_bucket=M_group, **g_controls)
            # calibrate from unsaturated rows (saturated ones understate)
            ok = mel_len < M_group
            if frame_bucket is None and ok.any():
                d_scale = float(np.max(g_controls.get("duration_scale", 1.0)))
                obs = float(np.max(mel_len[ok] / np.maximum(lens[ok], 1)))
                self._update_fpp(obs / max(d_scale, 0.1), escalated=escalated)
            for row, i in enumerate(group):
                L = int(mel_len[row])
                results[i] = (wav[row, : L * hop], mel[row, :L] if want_mel else None)

        pending = None
        for start in range(0, len(order), batch_size):
            group = order[start : start + batch_size]
            P = pick_bucket(max(len(ids_list[i]) for i in group), self.phoneme_buckets)
            g_controls = {**controls,
                          **{k: v[group] for k, v in per_req.items()},
                          **{t: np.repeat(q[group][:, None], P, axis=1)
                             for t, q in quality.items()}}
            ids_b = np.stack([pad_to_bucket(ids_list[i], P, self.vocab.pad_id) for i in group])
            lens = np.asarray([len(ids_list[i]) for i in group], np.int32)
            if two_phase:
                rows = self.synthesize_batch_two_phase(ids_b, lens, frame_bucket=M, **g_controls)
                for row, i in enumerate(group):
                    results[i] = _post(rows[row])
                continue
            if frame_bucket is None:
                d_scale = float(np.max(g_controls.get("duration_scale", 1.0)))
                est = int(np.ceil(int(lens.max()) * self._fpp * max(d_scale, 0.1))) + 16
                M_group = pick_bucket(min(est, self.frame_buckets[-1]), self.frame_buckets)
            else:
                M_group = M
            outs = self.synthesize_batch(ids_b, lens, frame_bucket=M_group, **g_controls)
            if pending is not None:
                _finish(pending)
            pending = (group, ids_b, lens, g_controls, M_group, outs)
        if pending is not None:
            _finish(pending)
        return results

    def synthesize(
        self,
        text: str,
        breathiness: float = 0.1,
        roughness: float = 0.05,
        brightness: float = 0.0,
        pitch_scale: float = 1.0,
        duration_scale: float = 1.0,
        energy_scale: float = 1.0,
        breath_curve: Optional[np.ndarray] = None,
        rough_curve: Optional[np.ndarray] = None,
        bright_curve: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Reference synthesis: constant control tracks from the scalars, or
        explicit per-phoneme curves.  Returns (waveform, log-mel (L, n_mels))."""
        ids = self.phonemes_to_ids(self.g2p.phonemes(text))
        n = len(ids)

        def curve(c, scalar):
            if c is not None:
                return np.asarray(c, np.float32)[:n]
            return np.full((n,), scalar, np.float32)

        return self.synthesize_ids(
            ids,
            breath=curve(breath_curve, breathiness),
            rough=curve(rough_curve, roughness),
            bright=curve(bright_curve, brightness),
            duration_scale=duration_scale,
            pitch_scale=pitch_scale,
            energy_scale=energy_scale,
        )


def infer_tts(
    checkpoint_path: str,
    text: str,
    breathiness: float = 0.1,
    roughness: float = 0.05,
    brightness: float = 0.0,
    pitch_scale: float = 1.0,
    duration_scale: float = 1.0,
    energy_scale: float = 1.0,
    hifigan_dir: str = "./hifi-gan",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot inference with the reference function's signature.  Returns
    (waveform, mel (L, n_mels)).  For serving, build a `Synthesizer` once."""
    synth = Synthesizer(checkpoint_path, hifigan_dir=hifigan_dir, device=device)
    return synth.synthesize(
        text,
        breathiness=breathiness,
        roughness=roughness,
        brightness=brightness,
        pitch_scale=pitch_scale,
        duration_scale=duration_scale,
        energy_scale=energy_scale,
    )
