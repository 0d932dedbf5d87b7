"""Plain PyTorch FastSpeech 2 (with SPEV's extra voice-quality predictors) and
HiFi-GAN generator, for one utterance at its exact length.

Nothing here is padded or bucketed: an utterance of n phonemes runs at n
positions and its L frames at L positions, with the zero padding of each
'same' convolution at the true ends.  Parameters are a dict of tensors under
the state-dict names the program's modules use, so the benchmark can hand the
same seeded weights to both sides.  Every product is a plain ``F.linear``,
``torch.matmul``, ``F.conv1d`` or ``F.conv_transpose1d``; the caller sets the
precision (TF32 off for the reference, ``torch.autocast`` for the control).

The equations, with the configuration's numbers (``cfg`` is the ``acoustic``
block of a configuration file, ``hcfg`` its ``vocoder`` block):

- embedding with row 0 pinned to zero; FFT blocks: x = LN(x + MHA(x)),
  x = LN(x + conv2(relu(conv1(x)))), LN with eps 1e-5 and biased variance;
- six variance predictors (duration, pitch, energy, bright, breath, rough):
  vp_layers x [conv k3 -> relu -> LN] -> linear -> LayerNorm over one
  feature (which returns its bias), each clamped to its range;
- inference durations round(clamp((exp(log_dur) - 1) * d, 0, 500)); a
  duration that is non-finite, negative or above 1000 counts as 0;
- length regulation repeats each phoneme's hidden state and tracks; the
  tracks are clamped again and embedded by a k3 conv each (pitch, energy,
  breath, rough, bright) and added; decoder FFT blocks; a linear mel head
  clamped to [-10, 2];
- HiFi-GAN: conv_pre k7, per stage leaky_relu(0.1) -> transposed conv ->
  mean of the resblocks (type 1: per dilation lrelu -> dilated conv -> lrelu
  -> conv; type 2: per dilation lrelu -> dilated conv; residual), then
  leaky_relu(0.01) -> conv_post k7 -> tanh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PREDICTORS = ("duration", "pitch", "energy", "bright", "breath", "rough")
EMBEDDED = ("pitch", "energy", "breath", "rough", "bright")
CLAMP = {"duration": (-4.0, 4.0), "pitch": (-2.5, 2.5), "energy": (-2.5, 2.5),
         "bright": (-2.5, 2.5), "breath": (0.0, 0.8), "rough": (0.0, 1.5)}
CLAMP_EXPANDED = {"pitch": (-3.0, 3.0), "energy": (-3.0, 3.0), "breath": (0.0, 1.0),
                  "rough": (0.0, 2.0), "bright": (-3.0, 3.0)}
MEL_CLAMP = (-10.0, 2.0)


# -- shapes ---------------------------------------------------------------------


def fs2_shapes(cfg: dict, vocab_size: int) -> dict:
    """{name: shape} of every FastSpeech 2 parameter, in the program's order."""
    h, e, k = cfg["hidden_dim"], cfg["embed_dim"], cfg["ffn_kernel_size"]
    inner = h * cfg["ffn_expansion"]
    out = {"embedding.weight": (vocab_size, e)}

    def block(prefix):
        out.update({
            f"{prefix}.attention.in_proj_weight": (3 * h, h),
            f"{prefix}.attention.in_proj_bias": (3 * h,),
            f"{prefix}.attention.out_proj.weight": (h, h),
            f"{prefix}.attention.out_proj.bias": (h,),
            f"{prefix}.norm1.weight": (h,), f"{prefix}.norm1.bias": (h,),
            f"{prefix}.conv1.weight": (inner, h, k), f"{prefix}.conv1.bias": (inner,),
            f"{prefix}.conv2.weight": (h, inner, k), f"{prefix}.conv2.bias": (h,),
            f"{prefix}.norm2.weight": (h,), f"{prefix}.norm2.bias": (h,),
        })

    for i in range(cfg["n_encoder_layers"]):
        block(f"encoder_blocks.{i}")
    for i in range(cfg["n_decoder_layers"]):
        block(f"decoder_blocks.{i}")
    for name in PREDICTORS:
        for j in range(cfg["vp_layers"]):
            out[f"{name}_predictor.layers.{4 * j}.weight"] = (h, h, cfg["vp_kernel_size"])
            out[f"{name}_predictor.layers.{4 * j}.bias"] = (h,)
            out[f"{name}_predictor.layers.{4 * j + 2}.weight"] = (h,)
            out[f"{name}_predictor.layers.{4 * j + 2}.bias"] = (h,)
        out[f"{name}_predictor.proj.weight"] = (1, h)
        out[f"{name}_predictor.proj.bias"] = (1,)
        out[f"{name}_predictor.output_norm.weight"] = (1,)
        out[f"{name}_predictor.output_norm.bias"] = (1,)
    for name in EMBEDDED:
        out[f"{name}_embedding.weight"] = (h, 1, 3)
        out[f"{name}_embedding.bias"] = (h,)
    out["mel_linear.weight"] = (cfg["n_mels"], h)
    out["mel_linear.bias"] = (cfg["n_mels"],)
    return out


def generator_shapes(hcfg: dict) -> dict:
    """{name: shape} of every HiFi-GAN generator parameter (folded weights)."""
    ch = hcfg["upsample_initial_channel"]
    out = {"conv_pre.weight": (ch, hcfg["num_mels"], 7), "conv_pre.bias": (ch,)}
    r = 0
    for i, (u, k) in enumerate(zip(hcfg["upsample_rates"], hcfg["upsample_kernel_sizes"])):
        out[f"ups.{i}.weight"] = (ch, ch // 2, k)
        out[f"ups.{i}.bias"] = (ch // 2,)
        ch //= 2
        for kr, dil in zip(hcfg["resblock_kernel_sizes"], hcfg["resblock_dilation_sizes"]):
            groups = ("convs1", "convs2") if hcfg["resblock"] == "1" else ("convs",)
            for g in groups:
                for j in range(len(dil)):
                    out[f"resblocks.{r}.{g}.{j}.weight"] = (ch, ch, kr)
                    out[f"resblocks.{r}.{g}.{j}.bias"] = (ch,)
            r += 1
    out["conv_post.weight"] = (1, ch, 7)
    out["conv_post.bias"] = (1,)
    return out


# -- FastSpeech 2 ----------------------------------------------------------------


def _conv(x, w, b, dilation=1):
    """'Same' conv over (T, C_in) -> (T, C_out)."""
    pad = (w.shape[-1] - 1) * dilation // 2
    return F.conv1d(x.t()[None], w, b, padding=pad, dilation=dilation)[0].t()


def _ln(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * w + b


def _mha(x, p, prefix, n_heads):
    T, H = x.shape
    qkv = F.linear(x, p[f"{prefix}.in_proj_weight"], p[f"{prefix}.in_proj_bias"])
    q, k, v = (t.reshape(T, n_heads, H // n_heads).transpose(0, 1) for t in qkv.chunk(3, -1))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(H // n_heads)
    out = torch.matmul(torch.softmax(scores, -1), v).transpose(0, 1).reshape(T, H)
    return F.linear(out, p[f"{prefix}.out_proj.weight"], p[f"{prefix}.out_proj.bias"])


def _block(x, p, prefix, n_heads):
    x = _ln(x + _mha(x, p, f"{prefix}.attention", n_heads),
            p[f"{prefix}.norm1.weight"], p[f"{prefix}.norm1.bias"])
    h = torch.relu(_conv(x, p[f"{prefix}.conv1.weight"], p[f"{prefix}.conv1.bias"]))
    h = _conv(h, p[f"{prefix}.conv2.weight"], p[f"{prefix}.conv2.bias"])
    return _ln(x + h, p[f"{prefix}.norm2.weight"], p[f"{prefix}.norm2.bias"])


def _predictor(x, p, name, cfg):
    h = x
    for j in range(cfg["vp_layers"]):
        pre = f"{name}_predictor.layers"
        h = torch.relu(_conv(h, p[f"{pre}.{4 * j}.weight"], p[f"{pre}.{4 * j}.bias"]))
        h = _ln(h, p[f"{pre}.{4 * j + 2}.weight"], p[f"{pre}.{4 * j + 2}.bias"])
    out = F.linear(h, p[f"{name}_predictor.proj.weight"], p[f"{name}_predictor.proj.bias"])
    out = _ln(out, p[f"{name}_predictor.output_norm.weight"],
              p[f"{name}_predictor.output_norm.bias"])
    return out[:, 0]


def _sanitize(d):
    ok = torch.isfinite(d) & (d >= 0) & (d <= 1000.0)
    return torch.where(ok, d, torch.zeros_like(d)).to(torch.int64)


def fastspeech2(p: dict, cfg: dict, ids: torch.Tensor, *, durations=None, tracks=None,
                max_frames: int = 2048) -> dict:
    """One utterance: ids (n,) -> {'mel' (L, n_mels), 'log_duration_pred',
    '<name>_pred' (n,) for each predictor, 'durations' (n,) int}.

    durations given: the teacher-forced path, with ``tracks`` holding the
    targets of every embedded track.  Else the inference path, where
    ``tracks`` may override breath, rough and bright and the controls are 1."""
    emb = p["embedding.weight"][ids]
    x = torch.where((ids == 0)[:, None], torch.zeros_like(emb), emb)
    for i in range(cfg["n_encoder_layers"]):
        x = _block(x, p, f"encoder_blocks.{i}", cfg["n_heads"])
    pred = {n: _predictor(x, p, n, cfg).clamp(*CLAMP[n]) for n in PREDICTORS}
    tracks = dict(tracks or {})
    if durations is None:
        durations = torch.round((torch.exp(pred["duration"]) - 1.0).clamp(0.0, 500.0))
        for n in EMBEDDED:
            tracks.setdefault(n, pred[n])
    d = _sanitize(durations)
    total = int(d.sum())
    L = max(min(total, max_frames), 1)
    if total == 0:
        x_exp = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        feats = {n: torch.zeros(1, dtype=x.dtype, device=x.device) for n in EMBEDDED}
    else:
        x_exp = torch.repeat_interleave(x, d, dim=0)[:L]
        feats = {n: torch.repeat_interleave(tracks[n].to(x.dtype), d)[:L] for n in EMBEDDED}
    dec = x_exp
    for n in EMBEDDED:
        t = feats[n].clamp(*CLAMP_EXPANDED[n])[:, None]
        dec = dec + _conv(t, p[f"{n}_embedding.weight"], p[f"{n}_embedding.bias"])
    for i in range(cfg["n_decoder_layers"]):
        dec = _block(dec, p, f"decoder_blocks.{i}", cfg["n_heads"])
    mel = F.linear(dec, p["mel_linear.weight"], p["mel_linear.bias"]).clamp(*MEL_CLAMP)
    out = {"mel": mel, "durations": d, "log_duration_pred": pred["duration"]}
    out.update({f"{n}_pred": pred[n] for n in PREDICTORS if n != "duration"})
    return out


def clean_mel(mel: torch.Tensor) -> torch.Tensor:
    """The synthesis path's hygiene before the vocoder: NaN -> -5, clip to
    [-10, 2]."""
    return torch.nan_to_num(mel, nan=-5.0).clamp(*MEL_CLAMP)


# -- HiFi-GAN generator ------------------------------------------------------------


def _conv_nc(x, w, b, dilation=1):
    """'Same' conv over (C, T)."""
    return F.conv1d(x[None], w, b, padding=(w.shape[-1] - 1) * dilation // 2,
                    dilation=dilation)[0]


def generator(p: dict, hcfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel (L, num_mels) -> waveform (L * prod(upsample_rates),)."""
    x = _conv_nc(mel.t(), p["conv_pre.weight"], p["conv_pre.bias"])
    n_k = len(hcfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(hcfg["upsample_rates"], hcfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, 0.1)[None], p[f"ups.{i}.weight"],
                               p[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)[0]
        acc = 0
        for j, (kr, dil) in enumerate(zip(hcfg["resblock_kernel_sizes"],
                                          hcfg["resblock_dilation_sizes"])):
            r, y = i * n_k + j, x
            for m, dd in enumerate(dil):
                if hcfg["resblock"] == "1":
                    h = _conv_nc(F.leaky_relu(y, 0.1), p[f"resblocks.{r}.convs1.{m}.weight"],
                                 p[f"resblocks.{r}.convs1.{m}.bias"], dd)
                    h = _conv_nc(F.leaky_relu(h, 0.1), p[f"resblocks.{r}.convs2.{m}.weight"],
                                 p[f"resblocks.{r}.convs2.{m}.bias"])
                else:
                    h = _conv_nc(F.leaky_relu(y, 0.1), p[f"resblocks.{r}.convs.{m}.weight"],
                                 p[f"resblocks.{r}.convs.{m}.bias"], dd)
                y = y + h
            acc = acc + y
        x = acc / n_k
    x = _conv_nc(F.leaky_relu(x, 0.01), p["conv_post.weight"], p["conv_post.bias"])
    return torch.tanh(x)[0]
