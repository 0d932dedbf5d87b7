"""Per-sub-discriminator roofline: the counterpart of the JAX package's
``tools/disc_roofline.py``.

Sets analytic FLOP and byte counts of each sub-discriminator's forward at
the profile's (B, T) against `diag.disc_profile`'s measured times: the
achieved TFLOP/s and GB/s, and which limit binds with its share.  The
rates and the share are taken on the device time of one forward, the CUDA
graph's where the row has one (on the card), else the eager time: eager
calls pay each op's host dispatch, which in TF32 and bf16 sets the pace.

- **FLOPs**: 2 × (output elements) × (input channels per group) × (kernel
  area) per convolution, as the JAX tool counts them; bias adds and
  LeakyReLUs are left out.  The MSD's scale s sees the pooled length
  (`msd_pool`: ``T//2 + 1`` per step), where the JAX tool takes
  ``T // 2**s``.
- **Bytes**: each convolution reads its input once and writes its output
  once, and its weight and bias are read once (the MPD's first input is
  the padded, folded signal).  The JAX tool counts the stack's first input
  (unpadded), every output and the weights of the strided stack only.
- **Peaks**: the H100 SXM's published dense rates at 700 W: 67 TFLOP/s for
  fp32 outside the tensor cores (``'high'``: TF32 off), 495 for TF32 (f32
  at ``'default'``), 989 for bf16; 3350 GB/s of HBM.  Each row takes the
  peak of its own (precision, dtype) unless the caller gives one.

A share over `MAX_SHARE` raises: the count or the time is wrong.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from spev_tpu_torch.models import hifigan_disc

PEAK_TFLOPS = {("high", "f32"): 67.0, ("default", "f32"): 495.0,
               ("high", "bf16"): 989.0, ("default", "bf16"): 989.0}
HBM_GBS = 3350.0
BYTES_PER = {"f32": 4, "bf16": 2}
MAX_SHARE = 1.05

# (out channels, kernel, stride, pad) of the MPD's stack, then its two post convs
Layer = Tuple[int, int, int, int]


def _mpd_layers() -> List[Layer]:
    chans = hifigan_disc._MPD_CHANNELS
    return [(c, 5, 3, 2) for c in chans] + [(chans[-1], 5, 1, 2), (1, 3, 1, 1)]


def mpd_cost(p: int, B: int, T: int, bytes_per: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward of the period-``p`` sub-discriminator
    on a (B, T) wav."""
    H = (T + (-T) % p) // p
    flops = by = 0
    in_ch = 1
    for out_ch, k, stride, pad in _mpd_layers():
        H_out = (H + 2 * pad - k) // stride + 1
        flops += 2 * B * H_out * p * out_ch * in_ch * k
        by += (B * H * p * in_ch + B * H_out * p * out_ch
               + out_ch * in_ch * k + out_ch) * bytes_per
        H, in_ch = H_out, out_ch
    return flops, by


def msd_length(scale: int, T: int) -> int:
    """The length the MSD's scale ``scale`` sees: `msd_pool` ``scale`` times."""
    for _ in range(scale):
        T = T // 2 + 1
    return T


def msd_cost(scale: int, B: int, T: int, bytes_per: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward of the MSD's scale-``scale``
    sub-discriminator on a (B, T) wav (before its pooling)."""
    spec = hifigan_disc._MSD_SPEC
    L = msd_length(scale, T)
    flops = by = 0
    for i_c, o_c, k, s, g, pd in list(spec) + [(spec[-1][1], 1, 3, 1, 1, 1)]:
        L_out = (L + 2 * pd - k) // s + 1
        flops += 2 * B * L_out * o_c * (i_c // g) * k
        by += (B * L * i_c + B * L_out * o_c + o_c * (i_c // g) * k + o_c) * bytes_per
        L = L_out
    return flops, by


def cost(disc: str, B: int, T: int, dtype: str) -> Tuple[int, int]:
    """(FLOPs, bytes) of the sub-discriminator named ``mpd_p{p}`` or
    ``msd_s{s}`` at ``dtype`` ("f32" or "bf16")."""
    kind, n = disc.split("_")
    fn = mpd_cost if kind == "mpd" else msd_cost
    return fn(int(n[1:]), B, T, BYTES_PER[dtype])


def roofline(rows: Sequence[Dict], B: int, T: int, peak_tflops: Optional[float] = None,
             hbm_gbs: Optional[float] = None) -> List[Dict]:
    """For each `time_sub_discriminators` row with a ``disc``: its counts,
    the device time ``ms`` (``fwd_graph_ms`` where given, else ``fwd_ms``),
    achieved TFLOP/s and GB/s over it, the binding limit (``"compute"`` or
    ``"HBM"``), its share of that peak and ``bound_ms``.  Raises when a share
    exceeds `MAX_SHARE` or a time is not finite and positive."""
    out = []
    for r in rows:
        if "disc" not in r:
            continue
        times = [r[k] for k in ("fwd_ms", "fwd_bwd_ms", "fwd_graph_ms", "fwd_bwd_graph_ms")
                 if r.get(k) is not None]
        if not all(math.isfinite(t) and t > 0 for t in times):
            raise ValueError(f"{r['disc']}: times must be finite and positive: {r}")
        ms = r["fwd_ms"] if r.get("fwd_graph_ms") is None else r["fwd_graph_ms"]
        flops, by = cost(r["disc"], B, T, r["dtype"])
        peak = peak_tflops or PEAK_TFLOPS[(r["precision"], r["dtype"])]
        hbm = hbm_gbs or HBM_GBS
        tf, gbs = flops / (ms / 1e3) / 1e12, by / (ms / 1e3) / 1e9
        share = max(tf / peak, gbs / hbm)
        if share > MAX_SHARE:
            raise ValueError(f"{r['disc']} ({r['precision']}, {r['dtype']}): {share:.0%} of the "
                             f"peak in {ms} ms; the count or the time is wrong")
        out.append({"disc": r["disc"], "precision": r["precision"], "dtype": r["dtype"],
                    "gflop": flops / 1e9, "mb": by / 1e6, "ms": ms, "fwd_ms": r["fwd_ms"],
                    "fwd_bwd_ms": r["fwd_bwd_ms"],
                    "fwd_bwd_graph_ms": r.get("fwd_bwd_graph_ms"), "tflops": tf, "gbs": gbs,
                    "limit": "compute" if tf / peak > gbs / hbm else "HBM", "share": share,
                    "peak_tflops": peak, "hbm_gbs": hbm,
                    "bound_ms": max(flops / (peak * 1e12), by / (hbm * 1e9)) * 1e3})
    return out


def roofline_table(rows: Sequence[Dict], B: int, T: int, peak_tflops: Optional[float] = None,
                   hbm_gbs: Optional[float] = None) -> str:
    """The JAX tool's markdown table, one column group per (precision,
    dtype) in the rows' order: the eager fwd ms (the JAX tool's column), the
    device ms the rates are taken on, TF/s, GB/s and the binding limit with
    its share; then each group's total of fwd+bwd, eager and on the device."""
    entries = roofline(rows, B, T, peak_tflops, hbm_gbs)
    groups = list(dict.fromkeys((e["precision"], e["dtype"]) for e in entries))
    names = list(dict.fromkeys(e["disc"] for e in entries))
    by_key = {(e["precision"], e["dtype"], e["disc"]): e for e in entries}
    hdr = ["sub-disc", "GFLOP (fwd)", "MB (f32)"]
    for prec, dt in groups:
        tag = f"{dt} {prec}"
        hdr += [f"{tag} fwd ms", f"{tag} device ms", f"{tag} TF/s", f"{tag} GB/s",
                f"{tag} limit"]
    lines = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    for n in names:
        flops, by = cost(n, B, T, "f32")
        row = [n, f"{flops / 1e9:.2f}", f"{by / 1e6:.0f}"]
        for prec, dt in groups:
            e = by_key.get((prec, dt, n))
            row += (["—"] * 5 if e is None else
                    [f"{e['fwd_ms']:.3f}", f"{e['ms']:.3f}", f"{e['tflops']:.1f}",
                     f"{e['gbs']:.0f}", f"{e['limit']} {e['share'] * 100:.0f}%"])
        lines.append("| " + " | ".join(row) + " |")
    for prec, dt in groups:
        group = [e for e in entries if (e["precision"], e["dtype"]) == (prec, dt)]
        line = f"total fwd+bwd ({dt} {prec}): {sum(e['fwd_bwd_ms'] for e in group):.2f} ms"
        if all(e["fwd_bwd_graph_ms"] is not None for e in group):
            line += f", {sum(e['fwd_bwd_graph_ms'] for e in group):.2f} ms on the device"
        lines.append(line)
    return "\n".join(lines)
