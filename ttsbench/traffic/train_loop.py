"""Acoustic training: ``Trainer.train_step`` fed as ``Trainer.train_epoch``
feeds it (``prefetch`` -> ``local_rows`` -> ``to_device`` -> ``train_step``)
from the port's ``BucketBatcher`` at the configuration's batch size and the
default buckets, epoch after epoch for the window.

The batcher reads an in-memory dataset in the cache's layout, made from the
seed: ``utterances`` utterances whose audio lengths follow the LJSpeech law
of `texts.TextGenerator`, ``phonemes_per_audio_s`` phonemes a second (the
rules G2P's marks of a generated sentence), ``frames_per_audio_s`` frames a
second, durations of at least one frame summing to the frame count, pitch,
energy and brightness N(0, 1), breath U(0, 0.8), roughness U(0, 1.5),
nasality U(0, 1), and a log-mel target N(-5, 2) clipped to [-10, 2].

Set-up builds the trainer, loads the seeded weights, runs the gradient pass
once at every bucket shape of the dataset without applying it, then makes the
first ``compared_steps`` steps through the window's own feed and call; the
window continues from there.  End to end: ``train_frames_per_s``, the valid
target frames of the distinct rows of applied steps (the batcher's repeated
rows are counted once) over the window's seconds.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from ttsbench.counts import bytes as nbytes
from ttsbench.counts import flops
from ttsbench.lib import program
from ttsbench.lib.trace import Window
from ttsbench.lib.weights import fs2_weights
from ttsbench.reference import g2p_rules
from ttsbench.reference.train import Trainer as Reference
from ttsbench.reference.train import index_utterances, rows_of_batch
from ttsbench.traffic.texts import TextGenerator

LAYER_SPANS = ("Trainer.global_gradients", "Trainer.apply_gradients", "bench.feed")


class Utterances:
    """A cached corpus held in memory: ``load_utterance(i)`` and
    ``lengths`` as the port's cache dataset gives them."""

    def __init__(self, utterances: list):
        self.utterances = utterances
        self.lengths = [(len(u["phs"]), int(u["mel"].shape[0])) for u in utterances]

    def __len__(self) -> int:
        return len(self.utterances)

    def load_utterance(self, i: int) -> dict:
        return self.utterances[i]


def make_corpus(seed: int, p: dict, n_mels: int) -> list:
    gen = TextGenerator(seed, p["phonemes_per_audio_s"], p["audio_s"], p["beta"])
    rng = np.random.default_rng([int(seed) % (2 ** 63), 2])
    seconds = gen.audio_lengths(p["utterances"])
    phs = [g2p_rules.phonemes(t) for t in gen.texts_of(seconds)]
    frames = [max(len(ph), int(round(s * p["frames_per_audio_s"]))) for ph, s in zip(phs, seconds)]
    mel = np.clip(rng.normal(-5.0, 2.0, (sum(frames), n_mels)), -10.0, 2.0).astype(np.float32)
    out, at = [], 0
    for ph, L in zip(phs, frames):
        n = len(ph)
        durs = 1 + rng.multinomial(L - n, np.full(n, 1.0 / n))
        u = {"phs": np.asarray(ph, dtype=object), "durs": durs.astype(np.int32),
             "mel": mel[at: at + L],
             "pitch": rng.normal(0.0, 1.0, n).astype(np.float32),
             "energy": rng.normal(0.0, 1.0, n).astype(np.float32),
             "breath": rng.uniform(0.0, 0.8, n).astype(np.float32),
             "rough": rng.uniform(0.0, 1.5, n).astype(np.float32),
             "bright": rng.normal(0.0, 1.0, n).astype(np.float32),
             "nasal": rng.uniform(0.0, 1.0, n).astype(np.float32)}
        out.append(u)
        at += L
    return out


def distinct_rows(batch: dict) -> list:
    """(phonemes, frames) of each distinct row of a collated batch."""
    seen, out = set(), []
    for b in range(len(batch["lens"])):
        n, L = int(batch["lens"][b]), int(batch["mel_lens"][b])
        key = (n, L, batch["ids"][b, :n].tobytes())
        if key not in seen:
            seen.add(key)
            out.append((n, L))
    return out


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf(prog: dict, ref: dict, leaves=None) -> float:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's norm(ref))."""
    leaves = list(ref) if leaves is None else list(leaves)
    a, b = _leaf_norms({k: prog[k] for k in leaves}), _leaf_norms({k: ref[k] for k in leaves})
    med = float(np.median([b[k] for k in leaves]))
    return max(abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in leaves)


def compare(config: dict, corpus: list, symbols: list, p0: dict, record: dict, device,
            autocast_dtype=None) -> dict:
    """The reference follows the program's first steps on the same rows.
    ``record`` holds the program's (or the control's) ``batches``, ``losses``,
    ``g1`` (the first clipped gradient) and ``p_end`` (the parameters after
    the last compared step)."""
    keys = index_utterances(corpus, symbols)
    ref = Reference(p0, config["acoustic"], config["train"], symbols, device, autocast_dtype)
    unmatched, loss_gap, g1 = 0, 0.0, None
    for batch, loss in zip(record["batches"], record["losses"]):
        idx = rows_of_batch(batch, keys)
        unmatched += sum(i is None for i in idx)
        if unmatched:
            break
        out = ref.step([corpus[i] for i in idx])
        loss_gap = max(loss_gap, abs(loss - out["loss"]) / max(abs(out["loss"]), 1e-30))
        g1 = out["grads"] if g1 is None else g1
    if unmatched:
        return {"unmatched_rows": float(unmatched), "loss_gap": float("nan"),
                "grad_gap": float("nan"), "change_gap": float("nan")}
    p_end = ref.params_cpu()
    p0c = {k: v.detach().cpu() for k, v in p0.items()}
    norms = _leaf_norms(g1)
    med = float(np.median(list(norms.values())))
    moving = [k for k, v in norms.items() if v >= 1e-3 * med]
    return {"unmatched_rows": 0.0, "loss_gap": loss_gap,
            "grad_gap": worst_leaf(record["g1"], g1),
            "change_gap": worst_leaf({k: record["p_end"][k] - p0c[k] for k in moving},
                                     {k: p_end[k] - p0c[k] for k in moving}, moving)}


def feed_of(trainer, batcher, depth: int):
    from spev_tpu_torch.data.prefetch import prefetch

    def epochs():
        e = 0
        while True:
            yield from batcher.epoch(e)
            e += 1

    return prefetch(map(trainer.local_rows, epochs()), depth=depth)


def warm_shapes(trainer, batcher, corpus: list, vocab) -> None:
    """The gradient pass once at every (phoneme, frame) bucket of the corpus,
    not applied (the parameters and the optimizer stay as they are)."""
    from spev_tpu_torch.data.batching import collate
    from spev_tpu_torch.text.vocab import pick_bucket

    groups: dict = {}
    for i, (n, L) in enumerate(Utterances(corpus).lengths):
        key = (pick_bucket(n, batcher.phoneme_buckets), pick_bucket(L, batcher.frame_buckets))
        groups.setdefault(key, []).append(i)
    bs = batcher.batch_size
    for (P, M), idx in sorted(groups.items()):
        rows = [corpus[idx[j % len(idx)]] for j in range(bs)]
        trainer.global_gradients(trainer.to_device(collate(rows, vocab, P, M)))


def control(cell, seed: int, device, variant: str, seconds: float) -> dict:
    """Readings of the reference put in the program's place on the rows of
    the run's first steps, judged by the fp32 reference: ``bf16`` runs it
    under bfloat16 autocast (the control); ``half_batch`` leaves out the
    second half of each batch and takes the mean over the rest (a fault)."""
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.text.vocab import Vocab

    p, config = cell.spec["params"], cell.config
    symbols = g2p_rules.vocab()
    p0 = fs2_weights(config["acoustic"], len(symbols), config["weights"], seed, device)
    corpus = make_corpus(seed, p, config["acoustic"]["n_mels"])
    batcher = BucketBatcher(Utterances(corpus), Vocab(symbols),
                            batch_size=config["train"]["batch_size"], seed=seed)
    epoch = batcher.epoch(0)
    batches = [next(epoch) for _ in range(p["compared_steps"])]
    keys = index_utterances(corpus, symbols)
    dtype = torch.bfloat16 if variant == "bf16" else None
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        low = Reference(p0, config["acoustic"], config["train"], symbols, device, dtype)
        record = {"batches": batches, "losses": []}
        for batch in batches:
            rows = [corpus[i] for i in rows_of_batch(batch, keys)]
            if variant == "half_batch":
                rows = rows[: len(rows) // 2]
            out = low.step(rows)
            record["losses"].append(out["loss"])
            record.setdefault("g1", out["grads"])
        record["p_end"] = low.params_cpu()
        return compare(config, corpus, symbols, p0, record, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def run(run) -> None:
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.text.vocab import Vocab

    p, config = run.cell.spec["params"], run.cell.config
    workdir = tempfile.mkdtemp(prefix="ttsbench-train-")
    try:
        tr, weights, symbols = program.trainer(config, run.seed, run.device, workdir)
        run.log("trainer built")
        corpus = make_corpus(run.seed, p, config["acoustic"]["n_mels"])
        run.log("corpus made")
        vocab = Vocab(symbols)
        batcher = BucketBatcher(Utterances(corpus), vocab, batch_size=tr.cfg.train.batch_size,
                                seed=run.seed)
        warm_shapes(tr, batcher, corpus, vocab)
        run.log("bucket shapes warmed")
        names = [n for n, _ in tr.model.named_parameters()]
        params = dict(tr.model.named_parameters())
        p0 = {k: v.detach().cpu().clone() for k, v in weights.items()}
        feed = feed_of(tr, batcher, tr.cfg.train.prefetch_batches)
        record = {"batches": [], "losses": []}
        b1 = tr.cfg.train.betas[0]
        for s in range(p["compared_steps"]):
            host = next(feed)
            m = tr.train_step(tr.to_device(host))
            record["batches"].append(host)
            record["losses"].append(float(m["loss"]))
            if s == 0:  # the first clipped gradient, from AdamW's first moment
                state = tr.optimizer.state
                record["g1"] = {k: (state[params[k]]["exp_avg"] / (1.0 - b1)).cpu()
                                if "exp_avg" in state.get(params[k], {})
                                else torch.zeros(params[k].shape) for k in names}
        record["p_end"] = {k: v.detach().cpu().clone() for k, v in params.items()}
        run.log("compared steps made")
        run.spans.wrap(tr, "global_gradients", "Trainer.global_gradients")
        run.spans.wrap(tr, "apply_gradients", "Trainer.apply_gradients")
        run.spans.record_kernels()

        steps, frames, failed, useful, step_s = 0, 0, 0, 0, []
        run.setup_done()
        with Window(run.spans) as window:
            while True:
                t_step = time.perf_counter()
                with run.spans.range("bench.feed"):
                    host = next(feed)
                    batch = tr.to_device(host)
                m = tr.train_step(batch)
                step_s.append(time.perf_counter() - t_step)
                if m["skipped"] > 0.5:
                    failed += 1
                else:
                    steps += 1
                    rows = distinct_rows(host)
                    frames += sum(L for _, L in rows)
                    if run.spans.on:
                        useful += sum(flops.train_step(config["acoustic"], n, L) for n, L in rows)
                if run.elapsed(window) >= run.seconds:
                    break
            run.sync()
        run.window_closed(window)
        run.log(f"window's steps (ms): first {[round(t * 1e3, 1) for t in step_s[:5]]}, "
                f"median {np.median(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}")
        run.e2e["train_frames_per_s"] = frames / window.seconds
        run.attempted, run.failed = steps + failed, failed
        k1b = []
        for (B, M, H), F, T, ends in run.spans.k1b_calls:
            valid = int(ends[:, -1].clamp(max=M).sum())
            k1b.append(nbytes.k1b(B, T, H, F, valid))
        run.layer_ctx.update(steps=steps, flops=float(useful) or None, k1b_bytes=k1b)
        if run.spans.on:
            run.reduce_trace(window, LAYER_SPANS)
        del tr, feed, batch, params
        run.free()
        with run.fp32():
            numbers = compare(config, corpus, symbols, weights, record, run.device)
        run.judge(numbers)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

