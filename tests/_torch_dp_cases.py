"""Configurations and global batches shared by ``tests/test_torch_parallel.py``
and its two-process worker (``tests/_torch_dp_worker.py``): the acoustic
model at the sizes of ``tests/test_torch_train.py`` with dropout off, and
the tiny HiFi-GAN of ``tests/test_torch_vocoder_training.py``."""

import numpy as np

from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.models.hifigan import HiFiGANConfig

P, M, H, V, NMEL, B = 16, 64, 32, 23, 8, 8
VOCAB = [f"p{i}" for i in range(V)]
MODEL = dict(vocab_size=V, embed_dim=H, hidden_dim=H, n_mels=NMEL, vp_output_norm=False,
             max_frames=M, dropout=0.0, vp_dropout=0.0)
# the advanced model (VAD, nasality, speakers) at the same widths
ADV_MODEL = dict(MODEL, use_vad=True, use_nasality=True, n_speakers=4)
HOP = 256


def acoustic_cfg(**train_kw) -> SpevConfig:
    return SpevConfig(model=ModelConfig(**MODEL),
                      train=TrainConfig(batch_size=B, warmup_steps=10, **train_kw))


def acoustic_batch() -> dict:
    """A global batch of 8 rows whose valid lengths differ from row to row:
    the two halves hold different phoneme counts (40 and 28) and different
    longest rows (row 2 in the first half starts with a 12-frame phoneme)."""
    rng = np.random.default_rng(5)
    n_ph = np.asarray([12, 3, 16, 9, 5, 7, 4, 12])
    ids = np.zeros((B, P), np.int32)
    durs = np.zeros((B, P), np.float32)
    for b, n in enumerate(n_ph):
        ids[b, :n] = rng.integers(1, V, size=n)
        durs[b, :n] = rng.integers(1, 3, size=n)
    durs[2, 0] = 12.0  # the first half's longest row
    mel_lens = durs.sum(axis=1).astype(np.int32)
    mel = np.zeros((B, M, NMEL), np.float32)
    for b in range(B):
        mel[b, : mel_lens[b]] = rng.standard_normal((mel_lens[b], NMEL)) - 4.0

    def feat(lo, hi):
        return np.where(durs > 0, rng.uniform(lo, hi, (B, P)), 0.0).astype(np.float32)

    return {
        "ids": ids, "lens": n_ph.astype(np.int32), "durs": durs,
        "mel": np.clip(mel, -10, 2), "mel_lens": mel_lens,
        "log_durs": (np.log(np.maximum(durs, 1) + 1) * (durs > 0)).astype(np.float32),
        "pitch": feat(-1, 1), "energy": feat(-1, 1), "breath": feat(0, 0.8),
        "rough": feat(0, 1.5), "bright": feat(-1, 1),
    }


def block_input():
    """One FFT block's input (4, P, H), its pad mask (valid lengths 16, 9, 5
    and 12) and a cotangent for its output, as torch tensors."""
    import torch

    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, P, H)).astype(np.float32)
    mask = np.arange(P)[None, :] >= np.asarray([16, 9, 5, 12])[:, None]
    w = rng.standard_normal((4, P, H)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(w)


def voc_cfg() -> HiFiGANConfig:
    return HiFiGANConfig(resblock="2", upsample_rates=(8, 8, 4),
                         upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=16,
                         resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                         num_mels=80)


def voc_batch():
    """A global crop batch of 4 rows, 8 frames each (torch tensors)."""
    import torch

    rng = np.random.default_rng(3)
    mel = rng.standard_normal((4, 8, 80)).astype(np.float32) - 6.0
    wav = (0.3 * rng.standard_normal((4, 8 * HOP))).astype(np.float32)
    return torch.from_numpy(mel), torch.from_numpy(wav)


def vocoder_run(vt, step) -> dict:
    """One fused ``step`` from the initial state (its losses, ``m_*``), and
    the losses (``s_*``) and gradients (``d_<i>``, ``g_<i>``) of
    ``step.d_step`` and ``step.g_step``, each from the initial state: each
    taken against the same D, so a difference in one update is not carried
    into the other."""
    applied = []
    original = vt._apply

    def hook(opt, params, grads, lr, count):
        applied.append([g.detach().clone().numpy() for g in grads])
        return original(opt, params, grads, lr, count)

    def fresh():
        return vt.init_vocoder_train_state(voc_cfg(), periods=(2,), n_scales=1, device="cpu")

    out = {}
    vt._apply = hook
    try:
        _, m = step(fresh(), *voc_batch())
        out.update({f"m_{k}": np.float64(v) for k, v in m.items()})
        applied.clear()
        _, d_loss, _ = step.d_step(fresh(), *voc_batch())
        _, g_loss, aux, _ = step.g_step(fresh(), *voc_batch())
        split = {"d_loss": d_loss, "g_loss": g_loss, **aux}
        out.update({f"s_{k}": np.float64(v) for k, v in split.items()})
    finally:
        vt._apply = original
    for which, grads in zip(("d", "g"), applied):
        out.update({f"{which}_{i}": g for i, g in enumerate(grads)})
    return out
