#!/usr/bin/env python3
"""Where the PyTorch port's fp32 training gradients on the card part from
the CPU's, and what each cuDNN setting costs.

    python3 tools/torch_train_precision.py   # from the repository root; one card

On the batch of ``chip_smoke.py``'s phase 7 (the default ModelConfig with
``vp_output_norm=False``, B=2, P=64, M=256, dropout off, the same seeded
weights) one loss-and-gradient pass runs:

- on the CPU in float64 (the reference) and in float32;
- on the card with TF32 off for matmuls and convolutions, under each cuDNN
  setting of ``SETTINGS``, and once more under the default setting in a
  child process with ``NVIDIA_TF32_OVERRIDE=0`` (TF32 off in every library).

For each it prints the loss's relative error and the worst gradients' errors
relative to their max |g|, against float64 and against the CPU's float32,
and how many mel-L1 signs (pred - target) differ from float64.  For the
default setting and cuDNN off it then repeats both references with their
ReLUs taking the card's side of zero wherever the two differ
(``chip_smoke._relu_decisions``), and prints how many ReLU inputs that
moved and how closely the ReLU convs' outputs agree.  Then the
convolution kernels the card ran under the default setting (torch.profiler),
and the steady-state ``Trainer.train_step`` time at B=16, P=128, M=1024 under
each setting.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the cache writer and the phase 7 batch)

SETTINGS = {
    "cudnn": dict(enabled=True, benchmark=False, deterministic=False),
    "cudnn_deterministic": dict(enabled=True, benchmark=False, deterministic=True),
    "cudnn_benchmark": dict(enabled=True, benchmark=True, deterministic=False),
    "no_cudnn": dict(enabled=False, benchmark=False, deterministic=False),
}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def float64_length_regulation():
    """The model's length regulation as plain autograd in the input's dtype
    (K1 and its plain version are float32 only)."""
    import spev_tpu_torch.models.fastspeech2 as fs2
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import expand_by_ends
    from spev_tpu_torch.ops.length_regulator import _mel_len, regulate_lengths

    def lr(x, features, durations, max_frames, guard_max=1000.0):
        ends, total = regulate_lengths(durations, guard_max)
        xo, fo = expand_by_ends(ends, max_frames, x, features.to(x.dtype))
        return xo, fo, _mel_len(total, max_frames)

    orig = fs2.length_regulate_fused
    fs2.length_regulate_fused = lr
    try:
        yield
    finally:
        fs2.length_regulate_fused = orig


def setup(tmp):
    """(cfg, vocab, stats, the phase 7 batch, one (128, 1024) batch of 16)."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher, collate
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.text.vocab import Vocab

    cache = os.path.join(tmp, "cache")
    if not os.path.exists(cache):
        chip_smoke._write_cache(cache)
    ds = SpevDataset(cache_dir=cache)
    vocab = Vocab(ds.vocab)
    short = [i for i, (n, t) in enumerate(ds.lengths) if n <= 64 and t <= 256][:2]
    small = collate([ds.load_utterance(i) for i in short], vocab, 64, 256)
    big = next(b for b in BucketBatcher(ds, vocab, batch_size=16).epoch(0)
               if b["mel"].shape[1] == 1024 and b["ids"].shape[1] == 128)
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=0.0, vp_dropout=0.0),
                     train=TrainConfig(batch_size=2, warmup_steps=20))
    return cfg, vocab, ds.stats, small, big


def one_pass(tmp, dev, dtype=torch.float32, card=None):
    """(loss, gradients as float64 CPU tensors, mel_pred - target signs,
    parameter names, the ReLU record of ``chip_smoke._relu_decisions``) of
    one ``Trainer.gradients`` pass on the phase 7 batch; with ``card`` (a
    record) the ReLUs take the recorded side of zero where they differ."""
    from spev_tpu_torch.train.trainer import Trainer, forward_losses

    cfg, vocab, stats, small, _ = setup(tmp)
    tr = Trainer(cfg, vocab, stats, ckpt_dir=os.path.join(tmp, "ck"),
                 log_dir=os.path.join(tmp, "ck"), device=dev)
    batch = tr.to_device(small)
    ctx = contextlib.nullcontext()
    if dtype == torch.float64:
        tr.model.double()
        batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        ctx = float64_length_regulation()
    with ctx:
        with chip_smoke._relu_decisions(tr.model, card) as rec:
            loss, _, grads = tr.gradients(batch, 1.0)
        with torch.no_grad():
            out, _ = forward_losses(tr.model, cfg, batch, 1.0)
    signs = torch.sign(out["mel_pred"] - batch["mel"]).cpu()
    names = [n for n, _ in tr.model.named_parameters()]
    return (float(loss.detach()), [g.detach().double().cpu() for g in grads], signs, names,
            rec)


def relu_sides(label, run, ref_name):
    """How many ReLU inputs of ``run`` fall on the other side of zero than
    in the reference that recorded ``run``'s sides, and the forward
    agreement of the ReLU convs (max |diff| / max |z|)."""
    rec = run[4]
    flips = {n: c for n, c in rec["flips"].items() if c}
    log(f"{label} vs {ref_name}: ReLU conv outputs within {max(rec['fwd_err'].values()):.2e} "
        f"of their max |z| over {len(rec['fwd_err'])} convs; inputs on the other side of "
        f"zero: {json.dumps(flips)}")
    return {"label": label, "ref": ref_name, "fwd_err": max(rec["fwd_err"].values()),
            "relu_flips": flips}


def compare(label, run, ref, ref_name, names):
    loss, grads, signs = run[:3]
    rloss, rgrads, rsigns = ref[:3]
    errs = sorted(((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30), n)
                  for a, b, n in zip(grads, rgrads, names))[::-1]
    over = sum(e > 1e-4 for e, _ in errs)
    flips = int((signs != rsigns).sum())
    log(f"{label} vs {ref_name}: loss rel {abs(loss - rloss) / abs(rloss):.2e}; gradients "
        f"over 1e-4 of max |g|: {over}; worst " + ", ".join(f"{n} {e:.2e}" for e, n in errs[:4])
        + f"; mel-L1 sign flips {flips}")
    return {"label": label, "ref": ref_name, "over_1e-4": over, "worst": errs[0][0],
            "worst_name": errs[0][1], "sign_flips": flips}


def conv_kernels(tmp):
    """The card's kernels of one default-setting pass whose names mark them
    as convolution or GEMM engines, by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = ("conv", "gemm", "xmma", "cudnn", "fft", "winograd", "grad", "fprop", "implicit")
    one_pass(tmp, "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_pass(tmp, "cuda")
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and any(k in e.key.lower() for k in marks)]
    for key, t, c in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f"  kernel {t / 1e3:.3f} ms x{c}: {key[:160]}")


def step_ms(tmp, setting):
    """Mean wall time of steps 3-10 of ``Trainer.train_step`` on one
    (128, 1024) batch of 16 (each step ends in its host read)."""
    from spev_tpu_torch.config import SpevConfig, TrainConfig
    from spev_tpu_torch.train.trainer import Trainer

    cfg, vocab, stats, _, big = setup(tmp)
    cfg = SpevConfig(model=cfg.model, train=TrainConfig(warmup_steps=20))
    with torch.backends.cudnn.flags(allow_tf32=False, **SETTINGS[setting]):
        tr = Trainer(cfg, vocab, stats, ckpt_dir=os.path.join(tmp, "ck"),
                     log_dir=os.path.join(tmp, "ck"))
        tb = tr.to_device(big)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            tr.train_step(tb)
            times.append(time.perf_counter() - t0)
    return float(np.mean(times[2:])) * 1e3, min(times[2:]) * 1e3, max(times[2:]) * 1e3


def child(tmp, out):
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.backends.cudnn.flags(allow_tf32=False, **SETTINGS["cudnn"]):
        run = one_pass(tmp, "cuda")
    torch.save(run, out)


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3])
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(card, "| torch", torch.__version__, "CUDA", torch.version.cuda, "cuDNN",
        torch.backends.cudnn.version())
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        setup(tmp)
        torch.set_num_threads(max(1, os.cpu_count() or 1))
        ref64 = one_pass(tmp, "cpu", torch.float64)
        names = ref64[3]
        cpu32 = one_pass(tmp, "cpu")
        results.append(compare("cpu fp32", cpu32, ref64, "cpu fp64", names))
        runs = {}
        for setting, flags in SETTINGS.items():
            with torch.backends.cudnn.flags(allow_tf32=False, **flags):
                runs[setting] = one_pass(tmp, "cuda")
        out = os.path.join(tmp, "child.pt")
        env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tmp, out],
                            env=env, timeout=600).returncode
        if rc != 0:
            raise RuntimeError(f"the NVIDIA_TF32_OVERRIDE=0 child exited with {rc}")
        runs["cudnn_tf32_override_0"] = torch.load(out, weights_only=False)
        for setting, run in runs.items():
            results.append(compare(f"card {setting}", run, ref64, "cpu fp64", names))
            results.append(compare(f"card {setting}", run, cpu32, "cpu fp32", names))
        # the same passes with the reference taking each run's side of zero
        # at every ReLU input where the two differ
        for setting in ("cudnn", "no_cudnn"):
            for ref_name, dtype in (("cpu fp64", torch.float64), ("cpu fp32", torch.float32)):
                ref = one_pass(tmp, "cpu", dtype, card=runs[setting][4])
                label = f"card {setting}"
                results.append(relu_sides(label, ref, ref_name))
                results.append(compare(label, runs[setting], ref,
                                       f"{ref_name} on the card's ReLU sides", names))
        log("convolution and GEMM kernels of one pass, default cuDNN setting, TF32 off:")
        with torch.backends.cudnn.flags(allow_tf32=False, **SETTINGS["cudnn"]):
            conv_kernels(tmp)
        times = {}
        for setting in SETTINGS:
            times[setting] = step_ms(tmp, setting)
            log(f"train step B=16 P=128 M=1024, TF32 off, {setting}: mean "
                f"{times[setting][0]:.2f} ms (min {times[setting][1]:.2f}, "
                f"max {times[setting][2]:.2f}) over steps 3-10")
    log(card)
    print(json.dumps({"errors": results, "step_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
