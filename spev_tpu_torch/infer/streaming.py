"""Streaming synthesis: chunked vocoding and clause-by-clause text.
Counterpart of ``spev_tpu.infer.streaming``.

- `stream_vocode` cuts a long mel into chunks and vocodes each in a window
  that adds ``context`` frames on the left and on the right (the context
  covering the generator's receptive field), then emits only the chunk's
  samples.  Every window has the same shape, so one cuDNN plan serves every
  chunk; the generator masks the window past the mel's end, so the last
  chunk ends as a full pass does.  Past the first receptive field the
  emitted audio equals a full pass up to convolution rounding.  (The JAX
  package's windows have no right context, so its chunks' last frames and
  its tail differ from its full pass wherever the output is not near zero;
  the port keeps its chunk count and lengths.)
- `stream_text` splits text at punctuation into clauses and yields each
  clause's waveform as soon as it is synthesized.
"""

from __future__ import annotations

import re
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F


def receptive_field_frames(cfg) -> int:
    """Upper bound of the generator's receptive field in input (mel) frames:
    per upsampling stage the transposed-conv kernel and the resblock
    dilations, mapped back to input resolution."""
    total = 1.0
    up = 1
    for k_up, u in zip(cfg.upsample_kernel_sizes, cfg.upsample_rates):
        up *= u
        total += k_up / up
        for kr, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            span = sum((kr - 1) * d for d in dils) * (2 if cfg.resblock == "1" else 1)
            total += span / up
    total += 7  # conv_pre (k=7) at input resolution + conv_post margin
    return int(np.ceil(total)) + 1


@torch.inference_mode()
def stream_vocode(
    generator,
    mel,
    chunk_frames: int = 64,
    context_frames: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield waveform chunks (np.float32) for a (T, n_mels) log-mel, an
    array or a tensor; the generator's device runs them.

    Each chunk covers chunk_frames·hop samples (the last may be shorter).
    The mel is padded with -10 (the log-mel floor) by the context on the
    left and to whole windows on the right; each window's frames past the
    mel's end are masked (``mel_len``)."""
    cfg = generator.cfg
    hop = cfg.hop_recovery
    ctx = context_frames if context_frames is not None else receptive_field_frames(cfg)
    dev = next(generator.parameters()).device
    mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
    T = int(mel.shape[0])
    win = 2 * ctx + chunk_frames
    n_chunks = -(-T // chunk_frames)
    mel_pad = F.pad(mel, (0, 0, ctx, n_chunks * chunk_frames - T + ctx), value=-10.0)
    for start in range(0, T, chunk_frames):
        # frames of the window before the mel's end (left context included)
        valid = torch.tensor([min(win, ctx + T - start)], device=dev)
        wav = generator(mel_pad[None, start : start + win], valid)[0]
        n = min(chunk_frames, T - start) * hop
        yield wav[ctx * hop : ctx * hop + n].cpu().numpy()


_SENTENCE_RE = re.compile(r"([.!?;:,]+\s*)")


def split_clauses(text: str, min_chars: int = 12) -> list:
    """Split text at punctuation into clauses, merging short ones forward."""
    pieces = _SENTENCE_RE.split(text)
    clauses, buf = [], ""
    for i in range(0, len(pieces), 2):
        clause = pieces[i] + (pieces[i + 1] if i + 1 < len(pieces) else "")
        buf += clause
        if len(buf.strip()) >= min_chars:
            clauses.append(buf.strip())
            buf = ""
    if buf.strip():
        if clauses:
            clauses[-1] = clauses[-1] + " " + buf.strip()
        else:
            clauses.append(buf.strip())
    return clauses or [text.strip()]


def stream_text(synthesizer, text: str, min_chars: int = 12, **controls) -> Iterator[np.ndarray]:
    """Clause-by-clause text → audio: each clause (merged up to min_chars)
    is synthesized and yielded in turn, so the first audio comes after one
    clause instead of the whole utterance."""
    for seg in split_clauses(text, min_chars):
        wav, _ = synthesizer.synthesize(seg, **controls)
        yield wav
