"""Useful floating-point operations, from the work's shapes alone.

A multiply-add counts 2.  Only the products count: the linear layers, the
attention's two batched products, the convolutions and the transposed
convolutions, at the utterance's valid lengths (n phonemes, L frames, L*hop
samples), never at a bucket's padded length.  Elementwise work (activations,
norms, softmax, masks) is left out, so a share of the peak from these counts
is a lower bound of what the device executed.
"""

from __future__ import annotations


def fft_block(cfg: dict, t: int) -> int:
    """One FFT block over t positions: in- and out-projections, q.k and
    attn.v over all heads, the two k-wide FFN convolutions."""
    h, k, inner = cfg["hidden_dim"], cfg["ffn_kernel_size"], cfg["hidden_dim"] * cfg["ffn_expansion"]
    return (2 * t * h * 3 * h + 2 * t * h * h + 2 * 2 * t * t * h
            + 2 * t * h * inner * k + 2 * t * inner * h * k)


def fastspeech2(cfg: dict, n: int, frames: int) -> int:
    """The acoustic model's forward pass over n phonemes and L frames: the
    encoder, the six variance predictors, the five variance embeddings, the
    decoder and the mel head."""
    h, kv = cfg["hidden_dim"], cfg["vp_kernel_size"]
    predictors = 6 * (cfg["vp_layers"] * 2 * n * h * h * kv + 2 * n * h)
    embeddings = 5 * 2 * frames * h * 3
    return (cfg["n_encoder_layers"] * fft_block(cfg, n) + predictors + embeddings
            + cfg["n_decoder_layers"] * fft_block(cfg, frames) + 2 * frames * h * cfg["n_mels"])


def generator(hcfg: dict, frames: int) -> int:
    """The HiFi-GAN generator over L mel frames (L * prod(upsample_rates)
    samples out)."""
    ch, t = hcfg["upsample_initial_channel"], frames
    total = 2 * t * hcfg["num_mels"] * ch * 7
    for u, k in zip(hcfg["upsample_rates"], hcfg["upsample_kernel_sizes"]):
        total += 2 * t * ch * (ch // 2) * k  # each input sample feeds k outputs
        ch //= 2
        t *= u
        convs_per_dilation = 2 if hcfg["resblock"] == "1" else 1
        for kr, dil in zip(hcfg["resblock_kernel_sizes"], hcfg["resblock_dilation_sizes"]):
            total += len(dil) * convs_per_dilation * 2 * t * ch * ch * kr
    return total + 2 * t * ch * 7


def train_step(cfg: dict, n: int, frames: int) -> int:
    """A training step's work on one utterance: three times its forward
    (the backward's two products per forward product)."""
    return 3 * fastspeech2(cfg, n, frames)
