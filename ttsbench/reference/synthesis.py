"""The plain synthesis of one text: frozen rules G2P -> ids -> FastSpeech 2
at the utterance's length -> mel clean-up -> HiFi-GAN generator.

``autocast_dtype`` runs the products at a lower precision (the control);
None runs them in fp32, with TF32 off when the caller has turned it off.
"""

from __future__ import annotations

import numpy as np
import torch

from ttsbench.reference import g2p_rules
from ttsbench.reference.models import clean_mel, fastspeech2, generator


@torch.no_grad()
def synthesize(text: str, fs2_params: dict, cfg: dict, gen_params: dict, hcfg: dict,
               symbols: list, device, controls: dict = None, autocast_dtype=None,
               max_frames: int = 2048):
    """(waveform (L * hop,), log-mel (L, n_mels)) as numpy arrays.
    ``controls``: constant breathiness, roughness and brightness tracks (the
    batcher's defaults), or None for the predictors' own."""
    ids = torch.as_tensor(g2p_rules.encode(g2p_rules.phonemes(text), symbols), device=device)
    tracks = None
    if controls:
        n = len(ids)
        tracks = {"breath": torch.full((n,), float(controls["breathiness"]), device=device),
                  "rough": torch.full((n,), float(controls["roughness"]), device=device),
                  "bright": torch.full((n,), float(controls["brightness"]), device=device)}
    with torch.autocast(device_type=torch.device(device).type, dtype=autocast_dtype,
                        enabled=autocast_dtype is not None):
        mel = clean_mel(fastspeech2(fs2_params, cfg, ids, tracks=tracks,
                                    max_frames=max_frames)["mel"].float())
        wav = generator(gen_params, hcfg, mel).float()
    return wav.cpu().numpy(), mel.cpu().numpy()


def gaps(rows: list, refs: list) -> dict:
    """The numbers that decide a synthesis cell's ``correct``, over pairs of
    (program's (wav, mel), reference's (wav, mel)):

    - ``length_mismatches``: rows whose frame count or sample count differs
      from the reference's (exact: limit 0);
    - ``mel_gap``: the largest |mel - mel_ref| over every frame and bin;
    - ``wav_gap``: the largest |wav - wav_ref| over a row, divided by that
      row's largest |wav_ref|, the worst row."""
    mism, mel_gap, wav_gap = 0, 0.0, 0.0
    for (w, m), (wr, mr) in zip(rows, refs):
        w, m = np.asarray(w, np.float32), np.asarray(m, np.float32)
        if m.shape != mr.shape or w.shape != wr.shape:
            mism += 1
            continue
        mel_gap = max(mel_gap, float(np.max(np.abs(m - mr))) if m.size else 0.0)
        peak = float(np.max(np.abs(wr))) if wr.size else 0.0
        if wr.size:
            wav_gap = max(wav_gap, float(np.max(np.abs(w - wr))) / max(peak, 1e-12))
    return {"length_mismatches": float(mism), "mel_gap": mel_gap, "wav_gap": wav_gap}
