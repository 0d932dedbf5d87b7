#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises, so the exit code is non-zero:

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``), build
   every CUDA kernel from ``spev_tpu_torch/csrc`` (one nvcc per source, all
   at once) and time the launch floor, a one-element ``fill_`` in a CUDA
   graph, the least of five timings (``launch_floor_ms``, printed beside
   every kernel case).
2. K1 (fused length regulation) against its plain PyTorch version on the
   card: bit-equal (``torch.equal``) at B=16, T=128, H=256, M ∈ {768, 2048}
   with NaN, zero and all-zero duration rows; at T=37 (H=256 and, for the
   scalar copies, H=250); at T=2048, M=8192; and at the serving shape B=1,
   T=128, M=512, one case per row of those durations.
2b. K1b (its backward, a segment-sum) against its plain version: within
   1e-5 with unit-normal cotangents at the same durations, at the bench
   shapes, at T=37 (H=256 and, for the scalar body, H=250) and at the
   training path's (T, M) = (64, 256), (128, 512) and (128, 1024); then
   at B=16, T=128, M=1024 with one phoneme a row at the 1000-frame guard,
   and with 200-frame silences at each row's start and end (1-12 frames
   elsewhere), the cotangents scaled by a power of two to a plain result
   of max |.| near 1; two launches bit-equal every time.
   Timed beside the plain version and one ``index_add`` (never called by
   the port).
3. K3 (overlap-add) against its plain version: bit-equal at n_fft 1024,
   hop 256 and T ∈ {2048, 256, 512, 1, 2, 3} frames, at n_fft 512 / hop
   128 and 800 / 200 (T=512), and on frames at a storage offset of one
   float (which must take the scalar body).  Kernel, plain version and a
   library yardstick (``torch.gather`` / ``F.fold`` / ``index_add``, never
   called by the port) are timed with CUDA graphs of 20 launches replayed
   between CUDA events.
3b. K2 (fused log-mel) against its plain version (float64, rounded once):
   within 2e-4 and two launches bit-equal, on the 22050- and 5000-sample signals
   of the kernel tests and on bucketed 1, 4 and 10 s signals (24576, 90112,
   221184 samples), at fmax sr/2 (the dataset's) and 8000, all at n_fft 1024
   (the FFT body), then at n_fft 512 / hop 128 (the FFT body) and n_fft
   800 / hop 200 (the dense body) on 1 and 10 s signals.  Each case also
   prints how far the plain version and K2 lie from an exact float64 FFT of
   the same frames (``torch.fft``, for the check only).  Timed beside
   its plain version, its bound (an FFT per frame and the filterbank's
   nonzero taps, or the signal's and output's bytes) and a library yardstick
   (``torch.stft`` → |.|² → mel product → log, never called by the port).
4. The full-width serving path through the user's entry points: a reference
   ``.pt`` of a default-config FastSpeech2 (seeded weights, duration bias
   log 7 → 6 frames per phoneme) and an upstream-style HiFi-GAN V1 directory
   (seeded weights) are written to a temporary directory; then 2 ×
   ``synthesize``, one ``synthesize_many`` of 8 texts at batch 4, one request
   through the CLI and one Griffin-Lim request (a Synthesizer with no
   HiFi-GAN).  The launch counts are zeroed just before and read just after:
   K1 must have run once per acoustic pass and K3 33 times for the
   Griffin-Lim request.  The inputs the path gave each kernel are kept, one
   set per distinct shape, and (4b) each kernel is checked against its
   plain version and timed on them, after the counts were read.
5. The card against the CPU: the same request through the port on the CPU
   (plain versions) and on the card (kernels) with TF32 off for matmuls and
   cuDNN: equal mel_len, mel MAE < 1e-4, HiFi-GAN waveform MAE < 1e-4.  The
   process's TF32 settings are restored afterwards: the Trainer sets its own.
6. The training path through the user's entry point: a feature cache of 96
   utterances written with numpy from a seed (the rules G2P's phonemes,
   lengths filling the (64, 256), (128, 512) and (128, 1024) buckets), then
   ``python -m spev_tpu_torch.cli.train`` in-process at the default config,
   batch 16, 2 epochs (1 duration-only), warmup 20 steps, at the default
   matmul precision ('mixed').  With the counts
   zeroed just before and read just after, K1 must have run once per
   forward (train and eval) and K1b once per train step's backward; every
   loss is finite.  Then ten steps on one (128, 1024) batch with dropout
   off at matmul precision 'high' must lower the loss (their steady-state
   time, frames per second and a one-step profile are printed; the profiled step must run no TF32
   kernel, with the process's cuDNN TF32 flag left at PyTorch's default),
   ``Synthesizer(best.pt)`` must give a
   finite waveform with the model config read from the checkpoint, and
   (6b) K1 and K1b are checked and timed on the inputs the run gave them
   (K1b's cotangents scaled by a power of two, exact in float32, to a
   plain result of max |.| near 1, so that its 1e-5 bar is a real test).
7. One training step, card against CPU, through the Trainer's own path (fp32,
   TF32 off: matmul precision 'high'; cuDNN on), at full width, B=2, M=256, dropout off: every ReLU
   conv's output within 1e-5 of its max |z|, then, with the CPU taking the
   card's side of zero at ReLU inputs inside that rounding (counted), loss
   within 1e-5 relative, every gradient within 1e-4 of its max |g|, equal
   skip flags.
8. Feature extraction and the dataset build through the user's entry
   point: a speech-like corpus of 32 wavs written with numpy from a seed
   (1-10 s, a harmonic source with an F0 glide and accents through formant
   resonances, fricative bursts and silences; half with TextGrids, half
   with transcripts; one under 4000 samples, two at 16 kHz), then
   ``python -m spev_tpu_torch.cli.train --data_dir`` in-process at the
   default config for one epoch.  With the counts zeroed just before and
   read just after, K2 must have run once per utterance that reached
   ``full_features`` (31), K1 once per forward and K1b once per backward.
   The cache is checked (finite, durations summing to the mel frames,
   lengths, stats, 31 files in both passes); the pass times, a repeat of
   one 10 s utterance (bit-equal or not, printed) and a profile of its
   ``full_features`` by stage are printed.  (8b) K2 is checked and timed
   on the path's inputs, one per bucket size.
9. Extraction, card against CPU: four of the corpus's utterances (one of
   10 s) built with ``device="cpu"`` and on the card: phonemes, durations
   and lengths equal, mel within 2e-4, per-phoneme targets within 1e-3 on
   99 % of phonemes and within 0.1 on all.
10. The advanced serving path through the user's entry points: a ``.spev``
   written by the port's writer (default ``ModelConfig`` at full width and
   depth with VAD, nasality, 4 speakers and per-phoneme predictors, as
   ``spev_advanced --mode train --multi_speaker`` makes it; seeded weights,
   a nonzero VAD projection, ~6 frames a phoneme from the duration proj
   bias), its size and load time; then ``cli.spev_advanced --mode infer``
   in-process and ``synthesize_advanced_controls`` with HiFi-GAN V1 and
   with Griffin-Lim, every control set (breathiness 0.3, roughness 0.2,
   nasality 0.4, VAD (-0.5, 0.6, -0.3), age 60, speaker 2, word emphasis
   "1,1.5,1,2", lung capacity 0.3) on a three-phrase text that plans
   inhales, and requests that set VAD, speaker and emphasis apart.  With
   the counts zeroed just before and read just after: K1 once per acoustic
   pass, K3 33 times per Griffin-Lim vocoding (two a phrase: the DSP mel
   is vocoded again); the waveform is the mel's frames × 256 plus each
   planned inhale and its two 60 ms pauses, exactly; VAD, speaker and
   emphasis each move the mel.  (10b) K1 and K3 are checked bit-equal and
   timed on the inputs this path gave them.  Then phase 4's ``.pt`` →
   ``cli.convert to-spev`` → ``Synthesizer`` gives a bit-equal mel, and one
   advanced HiFi-GAN request on the card matches the CPU (TF32 off): equal
   lengths, mel and waveform MAE < 1e-4.  A profile of one advanced request
   is printed.
11. Advanced training at full width through the user's entry point: an
   ESD-style corpus of 30 speech-like wavs written with numpy from a seed
   (``{speaker}_{utt}_{emotion}.wav``, 3 speakers × the 5 ESD emotions × 2,
   1-4 s, with transcripts), then ``cli.spev_advanced --mode train
   --multi_speaker --emotion_labels`` in-process for 2 epochs at batch 16
   (VAD, nasality, 3 speakers, per-phoneme predictors).  With the counts
   zeroed just before and read just after: K2 once per utterance, K1 once
   per forward, K1b once per backward.  The cache's speakers, emotions,
   ``speaker_id`` and ``vad`` are checked, ``last.spev``'s optimizer tree
   against optax's chain state, one more epoch resumes from ``last.spev``,
   and ``Synthesizer(best.spev)`` serves speaker 1 with a VAD point.  Then
   ten advanced steps on phase 6's fixed (128, 1024) batch with speaker ids
   and VAD targets at 'high' (timed, profiled, no TF32 kernel), and
   ``Trainer.save("last")`` with the optimizer and its ``restore`` into a
   fresh Trainer, timed (the next step's loss equal on both).  (11b) K1,
   K1b and K2 are checked and timed on the inputs this run gave them.
12. Phase 7's card-vs-CPU step for the advanced model, with speaker ids and
   VAD targets in the batch (every gradient, ``advanced.*`` and ``nasal_*``
   included).
13. The embodied agent on phase 10's ``.spev``: ``cli.embodied`` and
   ``cli.embodied.temporal_main`` with HiFi-GAN V1 and with Griffin-Lim,
   then ``EmbodiedAgent`` static and temporal with each vocoder, on "I made
   it [sigh] but I am so tired [breath] let us go", each timed.  With the
   counts zeroed just before and read just after: K1 once per acoustic
   pass (three a request), K3 33 times per Griffin-Lim vocoding; each
   waveform is its events, silences and whole hops of speech.  A profile of
   one request, then one static HiFi-GAN request on the card against the
   CPU (TF32 off): equal lengths, waveform MAE <= 1e-4.  (13b) K1 and K3 are
   checked bit-equal and timed on this path's inputs.
14. The serving stack and checkpoint evaluation, at full width (phase 10's
   ``.spev``, HiFi-GAN V1 with phase 4's weights).  Two servers are started
   as a user starts them, ``python -m spev_tpu_torch.cli.serve --max_batch
   16 --batch_window_ms 5 --response_cache 256`` on free ports (one with
   HiFi-GAN, one with Griffin-Lim), while, in this process, with the counts
   zeroed just before and read just after: ``synthesize_many`` of the 8
   texts at batch 4, fused and two-phase in turns, timed as served and
   compared in fp32 (equal lengths, mel within 1e-5, waveform within 1e-4;
   as served, cuDNN's TF32 algorithms differ by shape and the difference is
   printed), ``stream_vocode`` of a 600-frame mel against one full
   HiFi-GAN pass, as served and in fp32 (within 1e-4 past the context),
   ``stream_text`` with Griffin-Lim, ``evaluate_checkpoint`` of phase 6's
   ``best.pt`` on its 96-utterance cache with HiFi-GAN V1 (K2 re-extracts
   each vocoded mel) and ``cli.evaluate --split val --vocoder --json``: K1
   once per acoustic pass and teacher-forced forward, K2 once per vocoded
   utterance, K3 33 times per Griffin-Lim vocoding.  Then one coalesced
   batch of 3 on the card against the CPU (TF32 off, waveform MAE <= 1e-4)
   and against batches of one on the card in fp32 (within 1 LSB of PCM).
   Over HTTP, after a warm-up: 16 /synthesize requests over the texts with
   mixed pitch, duration and breathiness at concurrency 1, 4 and 16 (each
   its own response-cache keys), the 16 again (cache hits, the same
   bytes, counted by /healthz), one /synthesize_stream alone and two at
   once, one advanced request with every field, and on the Griffin-Lim
   server one /synthesize and one stream (its first request after start,
   in the warm-up, is timed too).  Every response is a 200 with a valid WAV;
   each response of the concurrency-16 run is within 5e-4 (the batch-size
   drift bar) of ``synthesize_many([text])`` in this process with the same
   controls, as served (its PCM difference in LSB is printed).  The
   servers' launch counts are read through /healthz just before and just
   after that traffic.  Printed: request wall time per concurrency (p50,
   max), the batch sizes the worker formed, the first streamed PCM byte
   and the stream's end, two-phase against fused per batch, evaluation
   seconds per utterance.  The servers are stopped at the end.  (14b) K1
   and K3 on this phase's in-process inputs, K2 on evaluation's.
15. Vocoder training at full width (HiFi-GAN V1, MPD periods 2, 3, 5, 7, 11,
   three MSD scales) on phase 8's corpus, as a user runs it: ``cli.vocoder
   --config v1 --batch_size 8 --segment_frames 32`` in-process for 6 steps
   (``fused_folded``, ``--precision default``, saving at 3 and 6): K2 once
   per distinct file the crop batcher loaded that is long enough for a
   crop; the generator and state files' sizes and write times.  Then
   ``--resume_state state_latest.spev`` (the step count goes on to 8), and
   GTA fine-tuning (``--gta_checkpoint`` phase 8's ``last.pt`` and cache,
   ``--finetune_from gen_00000006.spev``, ``--disc_warmup 2``, 4 steps):
   K1 once per teacher-forced batch, no K2 (the cache is reused), the
   generator bit-equal after each warmup step; GTA's seconds per
   utterance.  Ten steps on one fixed batch (B=8, 8192 samples) per
   configuration (fused against split, default against high precision;
   bf16 discriminators are phase 22's), the mean of steps 3-10 and one
   profiled step each.  One ``split_unfolded`` step's losses and
   gradients at B=1, 16 frames, ``--precision high``, card against CPU
   (losses 1e-5 relative, every gradient 1e-4 of its max |g|, the CPU
   taking the card's side at LeakyReLU inputs within rounding of zero).
   ``gen_00000006.spev`` → ``Vocoder(generator=...)`` vocodes phase 4's
   mel.  A 16-utterance reference-format cache (``torch.save``) goes
   through ``cli.convert cache`` and one epoch of ``cli.train
   --cache_dir``.  (15b) K1 on GTA's inputs and K2 on the batcher's
   signals against their plain versions.
16. The training surface on the formant corpus, at full width (the default
   ``ModelConfig``) with cut depth.  (16a) ``generate_formant_corpus``, 160
   utterances (the quality run's 480 cut), seed 0, timed.  (16b) ``python
   -m torch.distributed.run --standalone --nproc_per_node 1 -m
   spev_tpu_torch.cli.train --data_dir ... --textgrid_dir ...`` as a
   subprocess (NCCL at world size 1, the gradient all-reduce on the path):
   the cache built with K2, 16 epochs at B=16, lr 1e-3, 200 warmup steps,
   the probes at epoch 10, ``val_*.png`` (or the line saying they were
   skipped).  The child's launch counts come from its summary
   line: K2 once per utterance, K1b once per step, K1 once per train
   forward, validation forward and probe.  It fails when the val MCD,
   duration error or val mel loss does not fall from the first third's
   median to the last third's, when a probe fails, or when the run exits
   non-zero; whether the last val MCD is below half of epoch 0's is
   printed (ROADMAP.md, section 4, F6).  (16c) Ten train steps from one init on the same ten
   batches of that cache, card against CPU ('high': fp32, TF32 off, dropout off, lr
   1e-3 from the first step): per step the loss's relative gap, the largest
   parameter gap over its tensor's max |p|, the gap's norm over the
   parameters', the parameters more than 1e-3·lr apart, the ReLU inputs on
   the other side of zero and the card step's time; no bar.  Then the card
   step on one batch timed and profiled (dropout off).
   (16b') K1 and K1b on 16c's card steps' inputs (the cache's batches
   through the Trainer), K2 on the same dataset build over eight of the
   corpus's files, against their plain versions.  (16d) ``cli.vocoder
   --mesh 1`` under the launcher, 2 steps at V1 on phase 8's wavs, exits 0;
   ``--mesh 2`` in this process, at world size 1, returns exit status 2.
17. The rest of the extraction surface and the 'model' mesh axis.  (17a)
   The C++ I/O library (``spev_tpu_torch/csrc/spevio.cpp``, built with g++
   into ``_build/``): on WAVs written byte by byte from a seed (PCM 8, 16
   and 24 bit, 32-bit int and float, stereo, WAVE_FORMAT_EXTENSIBLE, an
   odd-sized chunk) ``native.read_wav`` bit-equal to the Python reader;
   ``write_wav`` round-trips; ``trim_normalize`` within 1e-6 of the Python
   prep; ``PrefetchingReader`` the same arrays in order; µs per 5 s file
   for each reader.  (17b) LJSpeech-, ESD- and Jenny-shaped trees written
   with numpy from a seed, then ``cli.download prep`` on ESD (48 pairs) and
   Jenny and ``cli.download download`` with the LJSpeech root already in
   ``--work_dir`` (``urlretrieve`` raises if reached); counts and seconds.
   (17c) The ESD pairs' cache with speaker and emotion-VAD labels built on
   the card serially (K2 once per utterance, counted) and with
   ``build_workers=4``: metadata and every npz array bit-equal (the largest
   gap per array printed), each build's pass-2 wall time and the speed-up;
   K2's launches counted in the build's own workers (each worker's count
   zeroed after its set-up and written after each file) must sum to one
   per utterance, over at least two workers, with none in the parent; then
   one more spawned worker, set up as the build's, holds K2 against its
   plain version in its process.  (17d) Two ranks on
   the one card over gloo (NCCL refuses two ranks on one device), started
   by this phase, mesh (1, 2) over ('data', 'model'): the base model at full
   width on phase 6's fixed batch (B=16, P=128, M=1024), one step in fp32
   (TF32 off: 'high') with K1 and K1b once per rank, held to the one-process step
   on the card.  cuDNN picks its algorithms by shape, so a ReLU input
   within rounding of zero may fall on the other side on a rank (phase 7's
   effect): the one-process step runs once as it is (loss 1e-6 relative,
   gradients and updated parameters 1e-3 of their max) and once taking the
   ranks' side of zero at every ReLU conv (their outputs within 1e-5 of
   their max, the flips counted), held to loss 1e-6 relative, gathered
   gradients 1e-5 of each max |g|, updated parameters 1e-5 of each max |p|
   where the gradient is above 1e-4 of its max and 1000 times AdamW's eps,
   and the rest (rounding-noise gradients, or ones so small that AdamW's
   first update still depends on their size) moved by at most the first
   step's lr, and, where their |g| is above 1e-5 of its max and the update
   at least lr/2, both updates on -g's side; each rank's K1 and K1b against
   their plain versions, one rank after the other; the gathered ``tp.pt``
   served by a one-process ``Synthesizer``; the step times of both runs.
18. The acoustic trainer's precision modes and remat, at full width on
   phase 6's fixed (128, 1024) batch from one seeded init, with the launch
   counts zeroed before and read after.  (18a) One step in each of
   'highest', 'high', 'mixed' and 'default', dropout off: 'mixed''s and
   'highest''s loss bit-equal to 'high''s, 'highest''s gradients within
   1e-6 of each max |g| of 'high''s, 'mixed''s and 'default''s within
   `MODE_GRAD_BAR` of each max |g| and `MODE_NORM_BAR` of the gradients'
   norm, K1 and K1b once, the process's TF32 flags as they were after
   every step; ms a step (steps 3-10) and the busy share of one profiled
   step per mode.  (18b) Remat off, 'full' and 'dots' at 'mixed' with
   dropout 0.1 from one generator seed, at B=16 and B=48 (the batch three
   times): the loss equal, the gradients within 1e-6 of each max |g| of
   the step without remat and the generator in the same state after it,
   K1 and K1b once a step, the peak memory of a train step over what was
   allocated before it (``max_memory_allocated`` after a reset; 'full'
   below no remat) and ms a step.  The compared passes of 18a and 18b run
   with cuDNN's deterministic algorithms.  (18c) ``cli.train`` on phase 16's formant cache for 2 epochs at
   the default 'mixed': exit 0, a finite ``metrics.jsonl``.  K1 must have
   run once per forward and K1b once per backward of the phase; (18') both
   on its inputs against their plain versions.  Prints "phase 18: N s".
19. The learned-control evidence, with the launch counts zeroed before and
   read after: K1 once per acoustic forward (training, validation,
   evaluation, synthesis and the pitch reads), K1b once per train step, K2
   once per utterance built, K3 33 times per Griffin-Lim vocoding.  (19a)
   ``tools/torch_emotion_register_demo.py``'s run for 60 epochs (the JAX
   package's calibrated count for this proof): a 160-utterance
   emotion-conditioned formant corpus built on the card, the advanced model
   (hidden 96, ``use_vad``) trained at B=16, lr 2e-3, then the same phonemes
   under each emotion's (V, A, D); it fails unless the predicted F0 orders
   happy > neutral > sad, the frames sad > neutral >= happy, ``vad_proj``'s
   |w| mean exceeds 1e-3 and the held-out duration error is under 10 % in
   aggregate (``tests/test_emotion_register.py``); its bar of 15 % for each
   emotion, with 2 held-out happy utterances, broke in one card run of
   many and is printed (`REGISTER_GATING_BARS`; ROADMAP.md, section 4).
   The speaker-identity proof (``tools/torch_multispeaker_demo.py``) is not
   run here: its bar, the voiced pyin F0 of Griffin-Lim audio rising from
   speaker 0 to 2, holds in only some runs of the recipe on the card
   (ROADMAP.md, section 4).  (19c)
   ``tools/torch_advanced_controls_demo.py``'s sweeps on phase 16's
   checkpoint: it fails unless word emphasis gains frames, nasality's
   spectral tilt does not rise, lung capacity's speech frames and inserted
   breaths do not fall (none at 1.0, at least one at 0.3).  The age sweep's
   pitch, as the model uses it after the age rule (its pitch head times the
   rule's scale, de-normalised) and as pyin finds it in the audio, is
   printed without a bar: the rule scales the normalised pitch, so the sign
   of its effect in Hz is the sign of the text's median z, which on this
   checkpoint (the text reads as silences) is ~0 and falls either way
   (ROADMAP.md, section 4).  (19') K1, K1b, K2 and K3 on
   this phase's inputs against their plain versions.  Prints "phase 19: N
   s" and fails beyond 240 s.
20. The installed port and the formant-corpus quality gate.  (20a) A wheel
   of the checkout built offline (``pip wheel --no-deps
   --no-build-isolation`` on a copy) must hold the four ``csrc`` sources;
   installed with ``pip install --target`` into a directory made
   read-only, it is imported first in a fresh process with
   ``XDG_CACHE_HOME`` set to a temporary directory, where it builds K1/K1b,
   K2, K3 and the native I/O library into the cache, holds each kernel
   against its plain version at the first case of phases 2, 2b, 3b and 3
   and the C++ wav reader bit-equal to the Python one; nothing may be
   written into the installed package.  Then, with the launch counts
   zeroed before and read after (K2 once per utterance built, K1b once per
   train step, K1 once per train, validation, free-running and demo
   forward, K3 33 times per Griffin-Lim vocoding): (20b)
   ``tools/torch_gate_calibration.py``'s run, the formant setup (120
   utterances, hidden 96) built on the card and trained 45 epochs at the
   default 'mixed', every held-out utterance run free, and the gate
   summary, held to the bars of ``tests/test_convergence.py``
   (`spev_tpu_torch.diag.convergence.gate_failures`) that held in every
   calibration run on the card (`GATING_BARS`: the duration error and the
   free-running frame error; the MCD bars and the trend, which failed in
   some, are printed: ROADMAP.md, section 4, F6); (20c)
   ``tools/torch_make_demo.py``'s page from that trainer, with phase 15's
   trained V1 generator as the GAN vocoder; (20') K1, K1b, K2 and K3 on
   this phase's inputs against their plain versions.  Prints "phase 20: N
   s" and fails beyond 240 s.
21. The GAN-vocoder evidence on phase 20's formant setup, with the launch
   counts zeroed before and read after (K2 once per utterance built and
   per log-mel made, K1 once per GTA batch, K3 33 times per Griffin-Lim
   vocoding, no K1b): (21a) a V3 generator trained through ``cli.vocoder``
   on phase 20's corpus (`P21_STEPS` steps at JAX's recipe, B=16 and
   32-frame crops; the steps timed), then
   ``tools/torch_gan_copysynth.py``'s copy synthesis of the demo's three
   held-out utterances, GAN and Griffin-Lim; (21b)
   ``tools/torch_prep_gta_work.py``'s work dir from 20b's trained setup, the
   GTA demo's two arms of `P21_ARM_STEPS` steps from 21a's generator and
   its evaluation of the 12 held-out utterances: every wav and JSON written
   and finite, every arm and utterance scored, the gta arm's crops the
   teacher-forced mels (no ground-truth log-mel made), each frame-aligned
   to its waveform; the orderings (GAN under Griffin-Lim; gta under
   control) gating as `GATING_ORDERINGS` says (both held in every card
   run of ``tools/torch_phase21.py``); (21') K1,
   K2 and K3 on this phase's inputs against their plain versions.  Prints
   "phase 21: N s" and fails beyond 200 s.
22. The discriminator probes (``tools/torch_disc_profile.py``,
   ``tools/torch_disc_roofline.py``, ``tools/torch_disc_bf16_probe.py``),
   with the launch counts zeroed before and read after (none of K1-K3 is on
   this path, and none may launch).  (22a) Every sub-discriminator of
   seeded full-width discriminators (MPD periods 2-11, three MSD scales)
   timed alone at B=16, 8192 samples, forward and forward+backward (its
   parameters' gradients), in fp32 at 'high', fp32 at 'default' (TF32) and
   bf16 at 'default', each graph twice before 10 calls between CUDA events,
   beside the host's time to enqueue those calls and one call's device time
   in a CUDA graph (10 replays); the roofline table against the H100's
   published peaks for each group, its rates on the device time; it fails
   unless every time is finite and positive and every share is at most
   105 %.  (22b) The bf16 probe: 50 fused V3 steps at B=16, 32-frame
   crops and 'default' with fp32 and with bf16 discriminators from one
   init over the JAX tool's four synthetic batches; it fails on a skipped
   step, a non-finite loss or a master weight or AdamW moment that is not
   fp32, and prints both trajectories, the speed ratio and the first
   step's bf16 losses against fp32 under JAX's bar of 8 % of max(1,
   |fp32|), which gates (`P22_GATING_BARS`: it held in every card run).
   Prints "phase 22: N s" and fails beyond 60 s.
23. The ``{"kernels": [...]}`` line, then as the last line the device line.

It imports only ``spev_tpu_torch``, ``torch``, ``numpy`` and the standard
library, and exits non-zero without a result when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
LAUNCH_FLOOR_MS = None  # phase 1: the device time of the least kernel, by graph_ms
TEXTS = [
    "Hello there, this is a quick test of the speech system.",
    "The quick brown fox jumps over the lazy dog.",
    "Good morning.",
    "We need to find a new way to bring the music back home tonight.",
    "Why?",
    "She said that the children were playing in the water all day long.",
    "Speech sounds different when you listen very closely.",
    "One two three four five six seven eight nine ten.",
]


# phase 10: three phrases (the rules G2P gives ~10, ~35 and ~30 phonemes),
# so that a lung capacity of 0.3 plans inhales; the short text has two
ADV_TEXT = ("Hello there, this is a quick test of the speech system, "
            "and we speak on until the very end.")
ADV_SHORT = "Good morning, my friend."
ADV_CONTROLS = dict(breathiness=0.3, roughness=0.2, nasality=0.4, valence=-0.5, arousal=0.6,
                    dominance=-0.3, age=60.0, speaker=2, word_emphasis="1,1.5,1,2",
                    lung_capacity=0.3)


def log(*a):
    print(*a, flush=True)


def graph_ms(fn, n=20, reps=10):
    """Device time of one ``fn()``: a CUDA graph of n calls, replayed reps
    times between CUDA events.  Host overhead (Python, ctypes) is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del g
    return ms


def phase1_card_and_build():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    log(card)
    from spev_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"phase 1: built {list(build.SOURCES)} with nvcc {' '.join(build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t0:.2f} s")
    global LAUNCH_FLOOR_MS
    buf = torch.zeros(1, device="cuda")
    floors = [graph_ms(lambda: buf.fill_(1.0)) for _ in range(5)]
    LAUNCH_FLOOR_MS = min(floors)
    log(f"phase 1: launch_floor_ms {LAUNCH_FLOOR_MS} (a one-element fill_ in a CUDA graph: "
        f"the device time of the least kernel; least of {floors})")
    return card


def _k1_case(x, fpad, ends, M, timed=True):
    """K1 against its plain version (bit-equal) on one set of card inputs,
    then (``timed``) timed beside the plain version and ``torch.gather``."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS, lr_fused, lr_fused_plain

    B, T, H = x.shape
    xo, fo = lr_fused(x, fpad, ends, M)
    xr, fr = lr_fused_plain(x, fpad, ends, M)
    torch.cuda.synchronize()
    if not (torch.equal(xo, xr) and torch.equal(fo, fr)):
        raise AssertionError(f"K1 differs from its plain version at B={B} T={T} H={H} M={M}")
    err = max((xo - xr).abs().max().item(), (fo - fr).abs().max().item())
    case = {"B": B, "T": T, "H": H, "M": M, "max_abs_err": err,
            "launch_floor_ms": LAUNCH_FLOOR_MS}
    if not timed:
        return case
    j = torch.arange(M, dtype=torch.int32, device=x.device)
    idx = torch.searchsorted(ends, j.expand(B, -1).contiguous(), right=True).clamp_max(T - 1)
    xf = torch.cat([x, fpad], dim=-1)
    idx_full = idx[..., None].expand(B, M, H + N_TRACKS).contiguous()
    return {
        **case, "ms": graph_ms(lambda: lr_fused(x, fpad, ends, M)),
        "plain_ms": graph_ms(lambda: lr_fused_plain(x, fpad, ends, M)),
        "library_ms": graph_ms(lambda: torch.gather(xf, 1, idx_full)),
        # ends, x and the tracks read once; both outputs written once
        "bound_ms": (B * T * 4 + B * T * (H + N_TRACKS) * 4 + B * M * (H + N_TRACKS) * 4)
        / HBM_BYTES_PER_S * 1e3,
    }


def _k3_case(frames, win, hop):
    """K3 against its plain version (bit-equal) on one set of card inputs,
    then timed beside the plain version and ``F.fold``."""
    from spev_tpu_torch.ops.cuda.kernels import _ola_vec, overlap_add, overlap_add_plain

    T, n_fft = frames.shape
    out = overlap_add(frames, win, hop)
    ref = overlap_add_plain(frames, win, hop)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not torch.equal(out, ref):
        raise AssertionError(f"K3 differs from its plain version (max abs {err}) at T={T} "
                             f"n_fft={n_fft} hop={hop}")
    out_len = n_fft + hop * (T - 1)
    cols = frames.T.contiguous()[None]  # (1, n_fft, T) for F.fold
    return {
        "T": T, "n_fft": n_fft, "hop": hop,
        "body": "vector" if _ola_vec(n_fft, hop, frames, win, out) else "scalar",
        "max_abs_err": err, "launch_floor_ms": LAUNCH_FLOOR_MS,
        "ms": graph_ms(lambda: overlap_add(frames, win, hop)),
        "plain_ms": graph_ms(lambda: overlap_add_plain(frames, win, hop)),
        "library_ms": graph_ms(lambda: torch.nn.functional.fold(
            cols, (1, out_len), (1, n_fft), stride=(1, hop))),
        "bound_ms": (T * n_fft * 4 + n_fft * 4 + out_len * 4) / HBM_BYTES_PER_S * 1e3,
    }


def phase2_k1():
    from spev_tpu_torch.diag.kernel_ab import durations
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS
    from spev_tpu_torch.ops.length_regulator import regulate_lengths

    g = torch.Generator().manual_seed(1)

    def inputs(B, T, H):
        x = torch.randn(B, T, H, generator=g).cuda()
        fpad = torch.randn(B, T, N_TRACKS, generator=g).cuda()
        fpad[..., 5:] = 0.0
        ends, _ = regulate_lengths(durations("mixed", B, T, g).cuda())
        return x, fpad, ends.contiguous()

    cases = []
    # the bench shapes; T=37, not a multiple of a lane's 4 ends (odd rows
    # unaligned), with 16-byte and (H=250) scalar copies; T=2048, 16 passes
    # of 128 ends, with frames reaching past the 11th pass
    for B, T, H, M in [(16, 128, 256, 768), (16, 128, 256, 2048), (16, 37, 256, 256),
                       (16, 37, 250, 256), (6, 2048, 256, 8192)]:
        case = _k1_case(*inputs(B, T, H), M)
        cases.append(case)
        log("phase 2: K1 bit-equal to plain", json.dumps(case))
    # the serving shape B=1, T=128, M=512: each row of the mixed durations (its edge
    # rows) on its own, timed on the first
    x, fpad, ends = inputs(6, 128, 256)
    for r in range(6):
        case = {**_k1_case(x[r:r + 1], fpad[r:r + 1], ends[r:r + 1], 512, timed=r == 0),
                "durations_row": r}
        cases.append(case)
        log("phase 2: K1 bit-equal to plain", json.dumps(case))
    return cases


def _k1b_case(gx, gf, ends, T):
    """K1b against its plain version (within 1e-5) and against itself (two
    launches, equal bits) on one set of card inputs, then timed beside the
    plain version and one ``index_add``.  The bar is absolute, so the
    cotangents must be of unit scale: the check fails when the plain
    result's max |.| is below 1/2."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import (N_TRACKS, lr_fused_bwd,
                                                                 lr_fused_bwd_plain)

    B, M, H = gx.shape
    xo, fo = lr_fused_bwd(gx, gf, ends, T)
    xo2, fo2 = lr_fused_bwd(gx, gf, ends, T)
    xr, fr = lr_fused_bwd_plain(gx, gf, ends, T)
    torch.cuda.synchronize()
    if not (torch.equal(xo, xo2) and torch.equal(fo, fo2)):
        raise AssertionError(f"K1b is not deterministic at B={B} T={T} H={H} M={M}")
    err = max((xo - xr).abs().max().item(), (fo - fr).abs().max().item())
    plain_max = max(xr.abs().max().item(), fr.abs().max().item())
    if not (err <= 1e-5 and plain_max >= 0.5):
        raise AssertionError(f"K1b differs from its plain version by {err} (plain max |.| "
                             f"{plain_max}) at B={B} T={T} M={M}")
    # the library yardstick: one index_add of every frame into its phoneme
    # row (frames past the total into a spare row)
    j = torch.arange(M, dtype=torch.int32, device=gx.device)
    idx = torch.searchsorted(ends, j.expand(B, -1).contiguous(), right=True).clamp_max(T - 1)
    rows = idx + T * torch.arange(B, device=gx.device)[:, None]
    dst = torch.where(j[None, :] < ends[:, -1:], rows, B * T).reshape(-1)
    src = torch.cat([gx, gf], dim=-1).reshape(B * M, H + N_TRACKS)
    zeros = torch.zeros((B * T + 1, H + N_TRACKS), device=gx.device)
    # the frames the data needs (inside each row's total and the bucket)
    # read once, ends read once, both outputs written once
    frames = int(ends[:, -1].clamp(max=M).sum())
    return {
        "B": B, "T": T, "H": H, "M": M, "valid_frames": frames, "max_abs_err": err,
        "launch_floor_ms": LAUNCH_FLOOR_MS,
        "plain_max_abs": plain_max, "ms": graph_ms(lambda: lr_fused_bwd(gx, gf, ends, T)),
        "plain_ms": graph_ms(lambda: lr_fused_bwd_plain(gx, gf, ends, T)),
        "library_ms": graph_ms(lambda: zeros.index_add(0, dst, src)),
        "bound_ms": (B * T * 4 + frames * (H + N_TRACKS) * 4 + B * T * (H + N_TRACKS) * 4)
        / HBM_BYTES_PER_S * 1e3,
    }


def phase2b_k1b():
    from spev_tpu_torch.diag.kernel_ab import durations
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS
    from spev_tpu_torch.ops.length_regulator import regulate_lengths

    g = torch.Generator().manual_seed(4)
    cases = []
    # the bench shapes, T=37 (H=250: the scalar body), then the training
    # path's (P, M) buckets, unit-normal cotangents; then phonemes long
    # enough that a duration-bound kernel would show it: one a row at the
    # 1000-frame guard, and 200-frame silences at each row's start and end.
    # Their sums reach ~30 at unit normal, so there the cotangents are
    # scaled by a power of two (`_unit_scale`, as phase 6b does) for the
    # absolute 1e-5 bar.
    for kind, B, T, H, M in [("mixed", 16, 128, 256, 768), ("mixed", 16, 128, 256, 2048),
                             ("mixed", 16, 37, 256, 256), ("mixed", 16, 37, 250, 256),
                             ("mixed", 16, 64, 256, 256), ("mixed", 16, 128, 256, 512),
                             ("mixed", 16, 128, 256, 1024), ("guard", 16, 128, 256, 1024),
                             ("silence", 16, 128, 256, 1024)]:
        ends, _ = regulate_lengths(durations(kind, B, T, g).cuda())
        ends = ends.contiguous()
        gx = torch.randn(B, M, H, generator=g).cuda()
        gf = torch.randn(B, M, N_TRACKS, generator=g).cuda()
        extra = {"durations": kind}
        if kind != "mixed":
            gx, gf, factors = _unit_scale(gx, gf, ends, T)
            extra["scaled_by"] = factors
        case = {**_k1b_case(gx, gf, ends, T), **extra}
        cases.append(case)
        log("phase 2b: K1b within 1e-5 of plain, deterministic", json.dumps(case))
    return cases


def phase3_k3():
    from spev_tpu_torch.ops.stft import hann_window

    g = torch.Generator().manual_seed(2)
    cases = []
    # the bench shape, 256 and the Griffin-Lim path's 512 frames; fewer
    # frames than k = 4 (edge rows only); n_fft 512 / hop 128 (the other
    # vector body) and 800 / 200 (the scalar body); last, frames at a
    # storage offset of one float, which must take the scalar body
    for n_fft, hop, T, offset in [(1024, 256, 2048, 0), (1024, 256, 256, 0),
                                  (1024, 256, 512, 0), (1024, 256, 1, 0), (1024, 256, 2, 0),
                                  (1024, 256, 3, 0), (512, 128, 512, 0), (800, 200, 512, 0),
                                  (1024, 256, 512, 1)]:
        win = torch.from_numpy(hann_window(n_fft)).cuda()
        frames = (torch.randn(T, n_fft, generator=g).cuda() * win).reshape(-1)
        if offset:
            frames = torch.cat([frames.new_zeros(offset), frames])[offset:]
        case = {**_k3_case(frames.view(T, n_fft), win, hop), "storage_offset_floats": offset}
        if offset and case["body"] != "scalar":
            raise AssertionError("K3 took its vector body on frames that are not 16-byte aligned")
        cases.append(case)
        log("phase 3: K3 bit-equal to plain", json.dumps(case))
    return cases


@contextlib.contextmanager
def _keep_kernel_inputs():
    """While active, the path's calls of K1, K1b, K2 and K3 keep a copy of
    their inputs (positional arguments, keywords), one for each distinct
    shape; the wrappers count launches as before."""
    import spev_tpu_torch.data.dataset as ds_mod
    import spev_tpu_torch.ops.length_regulator as lr_mod
    import spev_tpu_torch.ops.stft as stft_mod

    kept = {"lr_fused": {}, "lr_fused_bwd": {}, "overlap_add": {}, "fused_log_mel": {}}
    sites = [(lr_mod, "lr_fused"), (lr_mod, "lr_fused_bwd"), (stft_mod, "overlap_add"),
             (ds_mod, "fused_log_mel")]
    originals = [getattr(mod, name) for mod, name in sites]

    def keeping(name, fn):
        def call(*args, **kwargs):
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            key += tuple(sorted(kwargs.items()))
            if key not in kept[name]:
                kept[name][key] = (tuple(a.detach().clone() if torch.is_tensor(a) else a
                                         for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return call

    for (mod, name), fn in zip(sites, originals):
        setattr(mod, name, keeping(name, fn))
    try:
        yield kept
    finally:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, fn)


@torch.inference_mode()
def phase4b_main_path_inputs(kept, label="phase 4b"):
    """Each kernel against its plain version on the very inputs a serving
    path gave it (phase 4, or 10 for 10b; one set per distinct shape),
    timed as in phases 2 and 3.  These launches come after the counts were
    read."""
    k1, k3 = [], []
    for args, _ in kept["lr_fused"].values():
        case = {**_k1_case(*args), "main_path": True}
        k1.append(case)
        log(f"{label}: K1 bit-equal to plain on main-path inputs", json.dumps(case))
    for args, _ in kept["overlap_add"].values():
        case = {**_k3_case(*args), "main_path": True}
        k3.append(case)
        log(f"{label}: K3 bit-equal to plain on main-path inputs", json.dumps(case))
    if not (k1 and k3):
        raise AssertionError("the serving path called no kernel")
    return k1, k3


def _write_checkpoints(tmp):
    """A reference .pt (default ModelConfig, seeded) and an upstream-style
    HiFi-GAN V1 directory (seeded); returns (pt_path, hifigan_dir)."""
    from spev_tpu_torch.config import ModelConfig
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2
    from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import Vocab

    g2p = G2P("rules")
    vocab = Vocab.build({p for t in TEXTS for p in g2p.phonemes(t)})
    model = FastSpeech2.random_init(ModelConfig(vocab_size=len(vocab)), seed=0)
    with torch.no_grad():
        model.duration_predictor.output_norm.bias.fill_(math.log(7.0))
    pt = os.path.join(tmp, "model.pt")
    torch.save({"model": model.state_dict(), "vocab": vocab.symbols, "stats": {}}, pt)
    hdir = os.path.join(tmp, "hifigan")
    os.makedirs(hdir)
    cfg = HiFiGANConfig()
    with open(os.path.join(hdir, "config.json"), "w") as f:
        json.dump({"resblock": cfg.resblock, "upsample_rates": list(cfg.upsample_rates),
                   "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
                   "upsample_initial_channel": cfg.upsample_initial_channel,
                   "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
                   "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
                   "num_mels": cfg.num_mels}, f)
    gen = HiFiGANGenerator.random_init(cfg, seed=1)
    with torch.no_grad():  # rescale N(0, 0.01²) to std 1/√fan_in: a waveform well above zero
        for name, p in gen.named_parameters():
            if name.endswith("weight"):
                p.mul_(1.0 / (0.01 * math.sqrt(p[0].numel())))
    torch.save({"generator": gen.state_dict()}, os.path.join(hdir, "g_00000000"))
    return pt, hdir


def _check_row(wav, mel, hop=256):
    if not (np.isfinite(wav).all() and np.isfinite(mel).all()):
        raise AssertionError("non-finite output")
    if mel.ndim != 2 or mel.shape[1] != 80 or len(wav) != mel.shape[0] * hop:
        raise AssertionError(f"bad shapes: wav {wav.shape}, mel {mel.shape}")


def phase4_serving(pt, hdir, tmp):
    from spev_tpu_torch.cli.infer import main as cli_main
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.kernels import overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused

    synth = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules")
    synth_gl = Synthesizer(pt, hifigan_dir=None, g2p_backend="rules")
    if not (synth.vocoder.is_neural and not synth_gl.vocoder.is_neural):
        raise AssertionError("the HiFi-GAN directory was not picked up")
    if not next(synth.model.parameters()).is_cuda:
        raise AssertionError("the Synthesizer does not run on the card by default")
    # warm-up with the same requests (cuDNN algorithm choice per shape, the
    # allocator), outside the counted run, so the times below are steady state
    for i in (0, 1):
        synth.synthesize(TEXTS[i])
    synth.synthesize_many(TEXTS, batch_size=4)
    synth_gl.synthesize(TEXTS[1])
    torch.cuda.synchronize()

    acoustic_calls = [0]
    orig = Synthesizer._acoustic

    def counted(self, *a, **k):
        acoustic_calls[0] += 1
        return orig(self, *a, **k)

    Synthesizer._acoustic = counted
    timings = {}
    try:
        with _keep_kernel_inputs() as kept:
            lr_fused.launches = 0
            overlap_add.launches = 0
            t = time.perf_counter()
            for i in (0, 1):
                t0 = time.perf_counter()
                wav, mel = synth.synthesize(TEXTS[i])
                timings[f"synthesize_{i}"] = (time.perf_counter() - t0, mel.shape[0])
                _check_row(wav, mel)
            t0 = time.perf_counter()
            rows = synth.synthesize_many(TEXTS, batch_size=4)
            timings["synthesize_many_8_at_4"] = (time.perf_counter() - t0,
                                                 sum(m.shape[0] for _, m in rows))
            for wav, mel in rows:
                _check_row(wav, mel)
            t0 = time.perf_counter()
            out_wav = os.path.join(tmp, "cli.wav")
            if cli_main(["--checkpoint", pt, "--hifigan_dir", hdir, "--text", TEXTS[3],
                         "--output", out_wav]) != 0 or not os.path.getsize(out_wav) > 44:
                raise AssertionError("the CLI did not write a waveform")
            timings["cli_infer"] = (time.perf_counter() - t0, None)
            k3_before = overlap_add.launches
            t0 = time.perf_counter()
            wav, mel = synth_gl.synthesize(TEXTS[1])
            timings["griffin_lim"] = (time.perf_counter() - t0, mel.shape[0])
            _check_row(wav, mel)
            gl_k3 = overlap_add.launches - k3_before
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t
            launches = {"lr_fused": lr_fused.launches, "overlap_add": overlap_add.launches}
    finally:
        Synthesizer._acoustic = orig
    if launches["lr_fused"] != acoustic_calls[0] or acoustic_calls[0] < 6:
        raise AssertionError(f"K1 ran {launches['lr_fused']} times for {acoustic_calls[0]} "
                             "acoustic passes")
    if gl_k3 != 33 or launches["overlap_add"] != 33:
        raise AssertionError(f"K3 ran {launches['overlap_add']} times, {gl_k3} for the "
                             "Griffin-Lim request; expected 33")
    for name, (sec, frames) in timings.items():
        extra = "" if frames is None else (
            f", {frames} frames = {frames * 256 / 22050:.2f} s of audio, "
            f"real-time factor {sec / (frames * 256 / 22050):.4f}")
        log(f"phase 4: {name}: {sec * 1e3:.1f} ms wall{extra}")
    log(f"phase 4: serving path {total_s * 1e3:.1f} ms; acoustic passes {acoustic_calls[0]}; "
        f"launches {json.dumps(launches)}; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    _profile(synth, synth_gl)
    return launches, kept


def _profile(synth, synth_gl):
    """Device time by kernel for one request of each vocoder path (after the
    counted run)."""
    _profile_one("phase 4 profile: synthesize", lambda: synth.synthesize(TEXTS[1]))
    _profile_one("phase 4 profile: griffin_lim", lambda: synth_gl.synthesize(TEXTS[1]))


def _profile_stats(fn):
    """One ``fn()`` unprofiled (its wall time), then one under the profiler:
    the summed kernel time, the union of the kernels' intervals (the sum
    counts kernels that run at once, such as cuDNN's per-group fp32
    convolutions, and annotated ranges twice), the device ops and the
    kernels by device time.  None when the profiler recorded no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    covered, reach = 0.0, -math.inf
    for a, b in spans:
        covered += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "busy_pct": 100 * busy / wall_us,
            "union_ms": covered / 1e3, "union_pct": 100 * covered / wall_us,
            "ops": sum(r[2] for r in rows), "kernels": sorted(rows, key=lambda r: -r[1])}


def _profile_one(name, fn):
    """Busy share = summed kernel time of one ``fn()`` under the profiler /
    the wall time of the same call run without it; the top kernels by device
    time.  Returns the names of the kernels that ran."""
    st = _profile_stats(fn)
    if st is None:
        log(f"{name}: no device time recorded (not measured)")
        return []
    log(f"{name}: wall {st['wall_ms']:.2f} ms unprofiled, device busy "
        f"{st['busy_ms']:.2f} ms ({st['busy_pct']:.1f}% of wall; kernels' union "
        f"{st['union_ms']:.2f} ms, {st['union_pct']:.1f}%), device ops "
        f"{st['ops']}; top: " + "; ".join(
            f"{k[:70]} {t / 1e3:.3f} ms x{c}" for k, t, c in st["kernels"][:8]))
    return [r[0] for r in st["kernels"]]


def phase5_card_vs_cpu(pt, hdir):
    """The same request on the CPU and on the card with TF32 off for
    matmuls and cuDNN; the process's TF32 settings are restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _card_vs_cpu_request(pt, hdir)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _card_vs_cpu_request(pt, hdir):
    from spev_tpu_torch.infer.synthesis import Synthesizer

    text = TEXTS[2]
    cpu = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules", device="cpu")
    card = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules")
    w_cpu, m_cpu = cpu.synthesize(text)
    w_gpu, m_gpu = card.synthesize(text)
    if m_cpu.shape != m_gpu.shape or w_cpu.shape != w_gpu.shape:
        raise AssertionError(f"mel_len differs: cpu {m_cpu.shape} card {m_gpu.shape}")
    mel_mae = float(np.abs(m_cpu - m_gpu).mean())
    wav_mae = float(np.abs(w_cpu - w_gpu).mean())
    wav_level = float(np.abs(w_cpu).mean())
    log(f"phase 5: card vs CPU (TF32 off): mel_len {m_gpu.shape[0]} equal, "
        f"mel MAE {mel_mae:.3e} (< 1e-4), wav MAE {wav_mae:.3e} (< 1e-4) "
        f"on a waveform of mean |x| {wav_level:.3e}")
    if not (mel_mae < 1e-4 and wav_mae < 1e-4):
        raise AssertionError("the card disagrees with the CPU")
    if not wav_level > 1e-3:
        raise AssertionError("the waveform is too close to zero to compare")


CACHE_BUCKETS = {(64, 256): 32, (128, 512): 32, (128, 1024): 32}


def _write_cache(cache_dir, seed=0):
    """A feature cache in the layout the dataset build writes (metadata.json
    + u_*.npz), from a seed: 96 utterances of 20-120 phonemes of the rules
    G2P's phoneme set, durations 1-12 frames, at most 1024 frames each,
    32 in each of the (64, 256), (128, 512) and (128, 1024) buckets; mel
    targets in [-10, 2]."""
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import SPECIALS, pick_bucket

    g2p = G2P("rules")
    phones = sorted({p for t in TEXTS for p in g2p.phonemes(t)})
    rng = np.random.default_rng(seed)
    left = dict(CACHE_BUCKETS)
    files, lengths = [], []
    os.makedirs(cache_dir)
    for _ in range(200_000):
        if not any(left.values()):
            break
        n = int(rng.integers(20, 121))
        durs = rng.integers(1, int(rng.integers(1, 13)) + 1, n).astype(np.int32)
        T = int(durs.sum())
        key = (pick_bucket(n, (64, 128, 256)), pick_bucket(T, (256, 512, 1024, 2048)))
        if T > 1024 or not left.get(key):
            continue
        left[key] -= 1
        env = rng.uniform(-8.0, -2.0, 80).astype(np.float32)
        mel = np.clip(env[None, :] + rng.standard_normal((T, 80)), -10.0, 2.0)
        name = f"u_{len(files):05d}.npz"
        np.savez(os.path.join(cache_dir, name),
                 phs=np.asarray([phones[k] for k in rng.integers(0, len(phones), n)], object),
                 durs=durs, mel=mel.astype(np.float32),
                 pitch=np.clip(rng.standard_normal(n), -2.5, 2.5).astype(np.float32),
                 energy=np.clip(rng.standard_normal(n), -2.5, 2.5).astype(np.float32),
                 breath=rng.uniform(0.0, 0.8, n).astype(np.float32),
                 rough=rng.uniform(0.0, 1.5, n).astype(np.float32),
                 bright=np.clip(rng.standard_normal(n), -2.5, 2.5).astype(np.float32),
                 nasal=rng.uniform(0.0, 1.0, n).astype(np.float32))
        files.append(name)
        lengths.append((n, T))
    if any(left.values()):
        raise AssertionError(f"the cache's buckets were not filled: {left}")
    meta = {"files": files, "lengths": lengths, "speakers": [],
            "vocab": sorted(set(phones) | set(SPECIALS)),
            "stats": {"p_mean": 5.0, "p_std": 0.3, "e_mean": -3.0, "e_std": 1.0,
                      "c_mean": 7.5, "c_std": 0.5, "frames_per_phoneme": 6.5}}
    with open(os.path.join(cache_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return files


def phase6_training(tmp):
    """The training CLI in-process from a written cache, counted; then ten
    steps on one fixed batch, timed and profiled; then the trained
    checkpoint served."""
    from spev_tpu_torch.cli import train as train_cli
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    cache = os.path.join(tmp, "cache")
    t0 = time.perf_counter()
    _write_cache(cache)
    log(f"phase 6: wrote a {len(os.listdir(cache)) - 1}-utterance cache in "
        f"{time.perf_counter() - t0:.2f} s")

    steps, evals = [], [0]
    orig_train, orig_eval = Trainer.train_step, Trainer.eval_step

    def train_step(self, batch, variance_weight=1.0):
        m = orig_train(self, batch, variance_weight)
        steps.append((tuple(batch["mel"].shape), variance_weight, m))
        return m

    def eval_step(self, batch):
        evals[0] += 1
        return orig_eval(self, batch)

    Trainer.train_step, Trainer.eval_step = train_step, eval_step
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _keep_kernel_inputs() as kept:
            lr_fused.launches = 0
            lr_fused_bwd.launches = 0
            t0 = time.perf_counter()
            rc = train_cli.main(["--cache_dir", cache, "--name", "smoke", "--epochs", "2",
                                 "--batch_size", "16", "--warmup_epochs", "1",
                                 "--warmup_steps", "20"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"lr_fused": lr_fused.launches, "lr_fused_bwd": lr_fused_bwd.launches}
    finally:
        os.chdir(cwd)
        Trainer.train_step, Trainer.eval_step = orig_train, orig_eval
    if rc != 0:
        raise AssertionError(f"the training CLI exited with {rc}")
    if launches["lr_fused"] != len(steps) + evals[0] or launches["lr_fused_bwd"] != len(steps):
        raise AssertionError(f"launches {launches} for {len(steps)} train steps and "
                             f"{evals[0]} eval forwards")
    if not steps or not all(math.isfinite(m["loss"]) and m["skipped"] == 0 for *_, m in steps):
        raise AssertionError("a training loss was not finite")
    shapes = sorted({s for s, *_ in steps})
    log(f"phase 6: training CLI: {len(steps)} train steps at {shapes} (variance weight "
        f"{sorted({vw for _, vw, _ in steps})}), {evals[0]} eval forwards in {run_s:.2f} s; "
        f"launches {json.dumps(launches)}; losses "
        + " ".join(f"{m['loss']:.4f}" for *_, m in steps))
    ckpt = os.path.join(tmp, "checkpoints", "smoke")
    rows = [json.loads(line) for line in open(os.path.join(tmp, "logs", "smoke", "metrics.jsonl"))]
    log("phase 6: metrics.jsonl: " + json.dumps(rows))
    for name in ("last.pt", "best.pt"):
        if not os.path.exists(os.path.join(ckpt, name)):
            raise AssertionError(f"the training run wrote no {name}")

    # ten steps on one fixed (128, 1024) batch, dropout off
    ds = SpevDataset(None, cache_dir=cache)
    vocab = Vocab(ds.vocab)
    batch = next(b for b in BucketBatcher(ds, vocab, batch_size=16).epoch(0)
                 if b["mel"].shape[1] == 1024 and b["ids"].shape[1] == 128)
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=0.0, vp_dropout=0.0),
                     train=TrainConfig(warmup_steps=20, matmul_precision="high"))
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "fixed"),
                      log_dir=os.path.join(tmp, "fixed"))
    tb = trainer.to_device(batch)
    losses, times = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        m = trainer.train_step(tb)  # reads the step's metrics: ends synchronised
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ten steps on one batch did not lower the loss: {losses}")
    step_s = float(np.mean(times[2:]))
    frames = int(batch["mel_lens"].sum())
    log(f"phase 6: fixed batch B=16 P=128 M=1024 ({frames} target frames), dropout off: "
        f"losses {' '.join(f'{v:.4f}' for v in losses)}; steady-state train step "
        f"{step_s * 1e3:.2f} ms (mean of steps 3-10; min {min(times[2:]) * 1e3:.2f}, "
        f"max {max(times[2:]) * 1e3:.2f}), {frames / step_s:.0f} target frames/s, "
        f"{16 * 1024 / step_s:.0f} bucket frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = _profile_one("phase 6 profile: train_step B=16 P=128 M=1024",
                           lambda: trainer.train_step(tb))
    tf32 = [k for k in kernels if "tf32" in k.lower()]
    log(f"phase 6: process settings cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; TF32 kernels in the "
        f"train step: {len(tf32)} of {len(kernels)}")
    if tf32:
        raise AssertionError(f"the train step ran TF32 kernels: {tf32[:3]}")

    synth = Synthesizer(os.path.join(ckpt, "best.pt"), hifigan_dir=None, g2p_backend="rules")
    if synth.model_cfg.vp_output_norm is not False:
        raise AssertionError("the Synthesizer did not read the model config from best.pt")
    wav, mel = synth.synthesize(TEXTS[0])
    _check_row(wav, mel)
    log(f"phase 6: Synthesizer(best.pt) on the card: {mel.shape[0]} frames, finite "
        f"waveform, model config from the checkpoint (vp_output_norm=False)")
    return launches, kept, {"step_ms": step_s * 1e3, "frames_per_s": frames / step_s}


def _unit_scale(gx, gf, ends, T):
    """gx and gf, each times the power of two that brings the max |.| of its
    plain segment sum nearest 1.  A power of two scales float32 exactly, so
    K1b sees the training run's cotangents bit for bit, only at a scale
    where its absolute 1e-5 bar is a real test.  Returns (gx, gf, the two
    factors)."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused_bwd_plain

    out, factors = [], []
    for t, r in zip((gx, gf), lr_fused_bwd_plain(gx, gf, ends, T)):
        m = r.abs().max().item()
        f = 2.0 ** -round(math.log2(m)) if m > 0 else 1.0
        out.append(t * f)
        factors.append(f)
    return out[0], out[1], factors


@torch.inference_mode()
def phase6b_training_inputs(kept, label="phase 6b", path="training"):
    """K1 and K1b against their plain versions on the inputs a training run
    gave them (phase 6, or 11 for 11b; one set per distinct shape), after
    the counts were read.  The loss's cotangents reaching K1b are ~1e-7, far
    below K1b's absolute 1e-5 bar, so each is first scaled by a power of
    two (`_unit_scale`)."""
    k1 = [{**_k1_case(*args), "main_path": path} for args, _ in kept["lr_fused"].values()]
    k1b = []
    for (gx, gf, ends, T), _ in kept["lr_fused_bwd"].values():
        sgx, sgf, factors = _unit_scale(gx, gf, ends, T)
        k1b.append({**_k1b_case(sgx, sgf, ends, T), "main_path": path,
                    "scaled_by": factors})
    for c in k1:
        log(f"{label}: K1 bit-equal to plain on training-path inputs", json.dumps(c))
    for c in k1b:
        log(f"{label}: K1b within 1e-5 of plain on training-path inputs at unit scale",
            json.dumps(c))
    if not (k1 and k1b):
        raise AssertionError("the training path called no kernel")
    return k1, k1b


def _relu_convs(model):
    """The convolutions whose output goes through a ReLU, by name: each FFT
    block's conv1 and each variance predictor's conv layers."""
    from spev_tpu_torch.models.modules import Conv1d

    return {n: mod for n, mod in model.named_modules()
            if isinstance(mod, Conv1d) and (n.endswith(".conv1") or "_predictor.layers." in n)}


@contextlib.contextmanager
def _relu_decisions(model, card=None):
    """Without ``card``: records each ReLU conv's output (on the CPU) into
    the dict yielded.  With ``card`` (such a record): compares each output
    with the recorded one (max |diff| / max |z|, into ``"fwd_err"``) and
    moves every element whose sign disagrees to the recorded side of zero,
    the least positive float32 or 0, with its derivative kept, so the ReLU
    passes the recorded device's derivative there (``"flips"`` counts
    them)."""
    convs = _relu_convs(model)
    rec = {"z": {}, "fwd_err": {}, "flips": {}}

    def hook(name):
        def fn(mod, inp, out):
            if card is None:
                rec["z"][name] = out.detach().cpu()
                return None
            z = card["z"][name].to(out.device)
            rec["fwd_err"][name] = ((out.detach() - z).abs().max()
                                    / z.abs().max().clamp_min(1e-30)).item()
            want = z > 0
            flip = want != (out.detach() > 0)
            rec["flips"][name] = int(flip.sum())
            tiny = torch.finfo(out.dtype).tiny
            target = torch.where(want, torch.full_like(out, tiny), torch.zeros_like(out))
            return torch.where(flip, out - out.detach() + target, out)
        return fn

    handles = [mod.register_forward_hook(hook(n)) for n, mod in convs.items()]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


def phase7_train_step_card_vs_cpu(tmp):
    """One full-width training step (B=2, M=256, dropout off) through the
    Trainer's own gradient and update path, on the card (K1, K1b, cuDNN,
    TF32 off as the Trainer sets it) and on the CPU (plain versions).  Every
    ReLU conv's output agrees within 1e-5 of its max |z|.  A ReLU input
    inside that rounding of zero may fall on the other side on the two
    devices and pass another derivative (a 1e-3 difference in a conv
    weight's gradient from one element); the CPU step takes the card's side
    at those elements (counted).  Then the loss agrees within 1e-5
    relative, every gradient within 1e-4 of its max |g|, and the skip flags
    are equal."""
    _train_step_card_vs_cpu(tmp, "phase 7", {}, {})


def _train_step_card_vs_cpu(tmp, label, model_kw, extra):
    """Phase 7's comparison at the default config with ``model_kw`` set and
    the batch's arrays ``extra`` added."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import collate
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    ds = SpevDataset(None, cache_dir=os.path.join(tmp, "cache"))
    vocab = Vocab(ds.vocab)
    short = [i for i, (n, t) in enumerate(ds.lengths) if n <= 64 and t <= 256][:2]
    batch = {**collate([ds.load_utterance(i) for i in short], vocab, 64, 256), **extra}
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=0.0, vp_dropout=0.0, **model_kw),
                     train=TrainConfig(batch_size=2, warmup_steps=20, matmul_precision="high"))

    def one_step(dev, card=None):
        tr = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "p7"),
                     log_dir=os.path.join(tmp, "p7"), device=dev)
        with _relu_decisions(tr.model, card) as rec:
            loss, _, grads = tr.gradients(tr.to_device(batch), 1.0)
        grads = [g.detach().cpu() for g in grads]
        m = tr.apply_gradients([g.to(tr.device) for g in grads], loss, {})
        names = [n for n, _ in tr.model.named_parameters()]
        return float(loss.detach()), grads, m["skipped"], names, rec

    lg, gg, sg, names, card = one_step("cuda")
    lc, gc, sc, _, rec = one_step("cpu", card)
    rel = abs(lg - lc) / abs(lc)
    errs = sorted(((a - b).abs().max().item() / max(a.abs().max().item(), 1e-30), n)
                  for a, b, n in zip(gc, gg, names))[::-1]
    over = [n for e, n in errs if e > 1e-4]
    fwd = max(rec["fwd_err"].values())
    flips = {n: c for n, c in rec["flips"].items() if c}
    by_name = {n: e for e, n in errs}
    adv = {n: f"{by_name[n]:.2e}" for n in names if n.startswith(("advanced.", "nasal_"))}
    log(f"{label}: one train step card vs CPU (Trainer fp32: TF32 off; cuDNN on; B=2 P=64 "
        f"M=256{', ' + json.dumps(model_kw) if model_kw else ''}): ReLU conv outputs within "
        f"{fwd:.2e} of their max |z| (< 1e-5) over "
        f"{len(rec['fwd_err'])} convs; ReLU inputs on the other side of zero, the CPU taking "
        f"the card's side: {json.dumps(flips)}; loss {lg:.6f} vs {lc:.6f}, rel {rel:.2e}; "
        f"gradients over 1e-4 of their max |g|: {len(over)} of {len(names)}; worst "
        + ", ".join(f"{n} {e:.2e}" for e, n in errs[:4]) + f"; skipped {sg} vs {sc}"
        + (f"; advanced and nasal groups {json.dumps(adv)}" if adv else ""))
    if over or not (fwd < 1e-5 and rel < 1e-5 and sc == sg
                    and len(rec["fwd_err"]) == len(card["z"]) > 0):
        raise AssertionError(f"the training step disagrees between the card and the CPU: {over}")


def _k2_signal(n, seed):
    """The kernel tests' signal: a 220 Hz tone in noise."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * r.standard_normal(n)).astype(np.float32)


def _k2_case(y, **kw):
    """K2 against its plain version (float64, rounded once: within 2e-4) and
    against itself (two launches, equal bits) on one card signal, then timed
    beside the plain version and ``torch.stft`` → |.|² → mel product →
    log/clip (TF32 off, never called by the port).  The bar is absolute on values in [-10, 2],
    so the check also fails when fewer than a quarter of the plain values
    lie above the clip floor (a speech-like clip with silences and fmax
    sr/2 has about half)."""
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, fused_log_mel_plain
    from spev_tpu_torch.ops.stft import device_constant, hann_window, mel_filterbank

    kw = {"sr": 22050, "n_fft": 1024, "hop_length": 256, "n_mels": 80, "fmin": 0.0,
          "fmax": 11025.0, "floor": 1e-5, "clip_min": -10.0, "clip_max": 2.0, **kw}
    n_fft, n_mels, hop = kw["n_fft"], kw["n_mels"], kw["hop_length"]
    n_freqs = n_fft // 2 + 1
    out, out2 = fused_log_mel(y, **kw), fused_log_mel(y, **kw)
    ref = fused_log_mel_plain(y, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, out2):
        raise AssertionError(f"K2 is not deterministic at n={y.shape[0]}")
    err = (out - ref).abs().max().item()
    above = (ref > kw["clip_min"]).float().mean().item()
    if not (out.shape == ref.shape == (n_mels, 1 + y.shape[0] // hop) and err <= 2e-4
            and above >= 0.25):
        raise AssertionError(f"K2 differs from its plain version by {err} ({above:.3f} of "
                             f"the values above the floor) at n={y.shape[0]}")
    window = torch.hann_window(n_fft, device=y.device)
    fb = device_constant(mel_filterbank, kw["sr"], n_fft, n_mels, kw["fmin"], kw["fmax"],
                         device=y.device)

    def library():
        spec = torch.stft(y, n_fft, hop, window=window, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.clamp(torch.log(torch.clamp_min(fb @ power, kw["floor"])),
                           kw["clip_min"], kw["clip_max"])

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_err = (library() - ref).abs().max().item()
        library_ms = graph_ms(library)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    # how far the plain version's float32 DFT bases put it from an exact
    # float64 FFT of the same windowed frames (torch.fft, for this check only)
    padded = torch.nn.functional.pad(y[None], (n_fft // 2, n_fft // 2), mode="reflect")[0]
    win = device_constant(hann_window, n_fft, device=y.device)  # the plain version's
    frames = (padded.unfold(0, n_fft, hop) * win[None, :]).double()
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2 @ fb.double().T
    exact = torch.clamp(torch.log(torch.clamp_min(spec, kw["floor"])), kw["clip_min"],
                        kw["clip_max"]).T.float()
    plain_vs_exact = (ref - exact).abs().max().item()
    kernel_vs_exact = (out - exact).abs().max().item()
    T = out.shape[1]
    # The bound is the least work of the function, not of K2's design: per
    # frame the window, a real FFT (2.5·n·log2 n, half a complex FFT's
    # 5·n·log2 n), the power (3 a bin), an FMA per nonzero filterbank tap,
    # and floor, log and clip per mel; the signal read once and the output
    # written once (window and filterbank follow from the arguments).  The
    # dense DFT products that K2 and the Pallas kernel compute are reported
    # beside it as ``dense_gflop``.
    taps = int((fb != 0).sum().item())
    flops = T * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * taps + 3 * n_mels)
    dense_flops = T * (2 * 2 * n_fft * n_freqs + 2 * n_freqs * n_mels)
    nbytes = 4 * (y.shape[0] + n_mels * T)
    bound_s = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return {
        "n": int(y.shape[0]), "n_fft": n_fft, "hop": hop, "fmax": kw["fmax"], "frames": T,
        "body": "fft" if n_fft & (n_fft - 1) == 0 else "dense", "max_abs_err": err,
        "launch_floor_ms": LAUNCH_FLOOR_MS,
        "plain_max_abs": ref.abs().max().item(), "above_floor": above,
        "plain_vs_exact_fft": plain_vs_exact, "kernel_vs_exact_fft": kernel_vs_exact,
        "library_max_abs_diff": lib_err, "gflop": flops / 1e9,
        "dense_gflop": dense_flops / 1e9, "mbytes": nbytes / 1e6,
        "ms": graph_ms(lambda: fused_log_mel(y, **kw)),
        "plain_ms": graph_ms(lambda: fused_log_mel_plain(y, **kw)),
        "library_ms": library_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "operations" if flops / FP32_FLOPS_PER_S >= nbytes / HBM_BYTES_PER_S
        else "bytes",
    }


def phase3b_k2():
    cases = []
    # the dataset's bucketed clips first (10 s at fmax sr/2 heads the kernels line)
    for n, seed in [(221184, 5), (90112, 6), (24576, 7), (22050, 0), (5000, 1)]:
        y = torch.from_numpy(_k2_signal(n, seed)).cuda()
        for fmax in (11025.0, 8000.0):
            case = _k2_case(y, fmax=fmax)
            cases.append(case)
            log("phase 3b: K2 within 2e-4 of plain, deterministic", json.dumps(case))
    # another power of two (the FFT body's radix-8, 8, 4 passes) and an n_fft
    # that is not one (the dense body)
    for n_fft, hop in [(512, 128), (800, 200)]:
        for n, seed in [(221184, 8), (22050, 9)]:
            y = torch.from_numpy(_k2_signal(n, seed)).cuda()
            case = _k2_case(y, n_fft=n_fft, hop_length=hop)
            cases.append(case)
            log("phase 3b: K2 within 2e-4 of plain, deterministic", json.dumps(case))
    return cases


PHONES = {"vowel": ["AA1", "AE1", "AH0", "EH1", "IY1", "OW1", "UW1", "ER0"],
          "consonant": ["B", "D", "G", "K", "L", "M", "N", "P", "R", "T", "W"],
          "fricative": ["S", "SH", "F", "TH", "Z", "HH"]}


def _speech_like(rng, n, sr):
    """A speech-like signal of n samples and its segments (start, end, kind):
    a harmonic source with an F0 glide, vibrato and pitch accents through
    four formant resonances, enveloped into syllables, fricative noise
    bursts, and silences."""
    segs, pos = [], int(rng.uniform(0.1, 0.3) * sr)
    segs.append((0, pos, "silence"))
    while pos < n - int(0.3 * sr):
        kind = rng.choice(["syllable", "syllable", "syllable", "fricative", "silence"])
        dur = {"syllable": rng.uniform(0.12, 0.3), "fricative": rng.uniform(0.06, 0.12),
               "silence": rng.uniform(0.05, 0.2)}[kind]
        end = min(n, pos + int(dur * sr))
        segs.append((pos, end, kind))
        pos = end
    segs.append((pos, n, "silence"))
    t = np.arange(n) / sr
    f0 = rng.uniform(95.0, 220.0) * 2 ** (rng.uniform(-0.5, 0.5) * t / t[-1])
    f0 *= 1 + 0.02 * np.sin(2 * np.pi * 5.0 * t)
    for c in rng.uniform(0, t[-1], max(1, int(t[-1] / 1.5))):  # pitch accents
        f0 *= 1 + 0.15 * np.exp(-((t - c) / 0.12) ** 2)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    source = sum(np.sin(h * phase) / h for h in range(1, int(0.45 * sr / f0.max()) + 1))
    freqs = np.fft.rfftfreq(n, 1 / sr)
    formants = [(rng.uniform(500, 800), 90), (rng.uniform(1000, 1800), 110),
                (rng.uniform(2300, 2900), 160), (3500, 250)]
    shape = 0.02 + sum(np.exp(-(((freqs - fc) / bw) ** 2)) / (1 + k)
                       for k, (fc, bw) in enumerate(formants))
    voiced = np.fft.irfft(np.fft.rfft(source) * shape, n)
    noise = rng.standard_normal(n)
    hiss = np.fft.irfft(np.fft.rfft(noise) * (freqs > 3000), n)
    y = 3e-4 * rng.standard_normal(n)
    for a, b, kind in segs:
        if kind == "silence" or b <= a:
            continue
        env = np.sin(np.linspace(0, np.pi, b - a)) ** 2
        if kind == "syllable":
            y[a:b] += rng.uniform(0.3, 1.0) * env * voiced[a:b] / np.abs(voiced).max()
        else:
            y[a:b] += 0.25 * env * hiss[a:b] / np.abs(hiss).max()
    return (0.6 * y / np.abs(y).max()).astype(np.float32), segs


def _textgrid(path, segs, sr, rng):
    """A long-form TextGrid with a phones tier for the segments: silence
    empty, a syllable a consonant and a vowel, a fricative one phone."""
    ivs = []
    for a, b, kind in segs:
        if kind == "syllable":
            cut = a + int(0.3 * (b - a))
            ivs += [(a, cut, rng.choice(PHONES["consonant"])), (cut, b, rng.choice(PHONES["vowel"]))]
        else:
            ivs.append((a, b, "" if kind == "silence" else rng.choice(PHONES["fricative"])))
    end = segs[-1][1] / sr
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {end}", "tiers? <exists>", "size = 1", "item []:", "    item [1]:",
             '        class = "IntervalTier"', '        name = "phones"', "        xmin = 0",
             f"        xmax = {end}", f"        intervals: size = {len(ivs)}"]
    for k, (a, b, mark) in enumerate(ivs, 1):
        lines += [f"        intervals [{k}]:", f"            xmin = {a / sr}",
                  f"            xmax = {b / sr}", f'            text = "{mark}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_corpus(root, tg_dir, seed=0):
    """32 wavs of 1-10 s (triangular around 8 s, as LJSpeech's clips),
    16-bit PCM: file 0 has 3000 samples (skipped by the build), files 1-2 are
    at 16 kHz, file 3 lasts 10 s; even files get a TextGrid, odd ones a
    transcript.  Returns {basename: (samples at 22050 Hz after the build's
    resampling, sample rate)}."""
    from spev_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(root)
    os.makedirs(tg_dir)
    words = " ".join(TEXTS).split()
    info = {}
    for i in range(32):
        sr = 16000 if i in (1, 2) else 22050
        sec = 10.0 if i == 3 else rng.triangular(1.0, 8.0, 10.0)
        n = 3000 if i == 0 else int(sec * sr)
        y, segs = _speech_like(rng, n, sr)
        name = f"clip{i:02d}"
        write_wav(os.path.join(root, f"{name}.wav"), y, sr)
        if i % 2 == 0:
            _textgrid(os.path.join(tg_dir, f"{name}.TextGrid"), segs, sr, rng)
        else:
            k = max(2, int(n / sr * 2))  # about 10 letters a second
            start = int(rng.integers(0, len(words)))
            with open(os.path.join(root, f"{name}.txt"), "w") as f:
                f.write(" ".join(words[(start + j) % len(words)] for j in range(k)))
        info[name] = (int(round(n * 22050 / sr)), sr)
    return info


def _profile_stages(name, fn, labels):
    """One ``fn()`` under the profiler: busy share (kernel time against the
    unprofiled wall time), device ops, top kernels, and for each ``spev.*``
    range the host time inside it and the time of the kernels its ops
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_us = float(np.median(walls)) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # device events, less the ranges' own device-side annotations
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("spev.")]
    busy = sum(k.time_range.elapsed_us() for k in kernels)
    by_name = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), c + 1)
    stages = {}
    for label in labels:
        ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name == label]
        stages[label] = {"host_ms": sum(e.cpu_time_total for e in ranges) / 1e3,
                         "kernel_ms": sum(e.device_time_total for e in ranges) / 1e3}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"{name}: wall {wall_us / 1e3:.2f} ms unprofiled (median of 3: "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}), device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of wall), device ops {len(kernels)}; by stage (host "
        "time / time of the kernels it launched): " + "; ".join(
            f"{k} {v['host_ms']:.2f} / {v['kernel_ms']:.3f} ms" for k, v in stages.items())
        + "; top: " + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{c}" for k, (t, c) in top))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "device_ops": len(kernels),
            "stages": stages, "kernel_names": sorted(by_name)}


# K2 is launched through ctypes, and phase 8's profile does not show it (so
# spev.log_mel shows its host time only); phase 8b times the kernel itself
STAGES = ["spev.log_mel", "spev.f0", "spev.pyin.cmndf", "spev.pyin.trough_probs",
          "spev.pyin.viterbi", "spev.rms", "spev.centroid"]


def phase8_extraction(tmp):
    """The dataset build through ``cli.train --data_dir`` in-process at the
    default config, counted and timed; then the cache checked, one 10 s
    utterance repeated and profiled."""
    from spev_tpu_torch.cli import train as train_cli
    from spev_tpu_torch.data.dataset import FeatureExtractor, SpevDataset
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.train.trainer import Trainer
    from spev_tpu_torch.utils.wavio import read_wav

    corpus, tg = os.path.join(tmp, "corpus"), os.path.join(tmp, "textgrids")
    t0 = time.perf_counter()
    info = _write_corpus(corpus, tg)
    log(f"phase 8: wrote a {len(info)}-file corpus ({sum(n for n, _ in info.values()) / 22050:.1f}"
        f" s at 22050 Hz) in {time.perf_counter() - t0:.2f} s")

    calls = {"stats_features": 0, "full_features": 0, "train_step": 0, "eval_step": 0}
    marks = {}
    originals = {}

    def counting(cls, name):
        orig = originals[name] = getattr(cls, name)

        def call(self, *a, **k):
            calls[name] += 1
            return orig(self, *a, **k)
        setattr(cls, name, call)

    for cls, name in ((FeatureExtractor, "stats_features"), (FeatureExtractor, "full_features"),
                      (Trainer, "train_step"), (Trainer, "eval_step")):
        counting(cls, name)
    orig_build, orig_extract = SpevDataset._build, SpevDataset._serial_extract

    def build(self, *a, **k):
        marks["build_start"] = time.perf_counter()
        orig_build(self, *a, **k)
        torch.cuda.synchronize()
        marks["build_end"] = time.perf_counter()

    def serial_extract(self, *a, **k):
        marks["pass2_start"] = time.perf_counter()
        yield from orig_extract(self, *a, **k)

    SpevDataset._build, SpevDataset._serial_extract = build, serial_extract
    cache = os.path.join(tmp, "cache_built")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _keep_kernel_inputs() as kept:
            fused_log_mel.launches = 0
            lr_fused.launches = 0
            lr_fused_bwd.launches = 0
            t0 = time.perf_counter()
            rc = train_cli.main(["--data_dir", corpus, "--textgrid_dir", tg, "--cache_dir", cache,
                                 "--name", "extract", "--epochs", "1", "--warmup_epochs", "0",
                                 "--batch_size", "16", "--warmup_steps", "20"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"fused_log_mel": fused_log_mel.launches, "lr_fused": lr_fused.launches,
                        "lr_fused_bwd": lr_fused_bwd.launches}
    finally:
        os.chdir(cwd)
        SpevDataset._build, SpevDataset._serial_extract = orig_build, orig_extract
        FeatureExtractor.stats_features = originals["stats_features"]
        FeatureExtractor.full_features = originals["full_features"]
        Trainer.train_step, Trainer.eval_step = originals["train_step"], originals["eval_step"]
    if rc != 0:
        raise AssertionError(f"the training CLI exited with {rc}")
    if not (launches["fused_log_mel"] == calls["full_features"] == 31
            and calls["stats_features"] == 31):
        raise AssertionError(f"K2 ran {launches['fused_log_mel']} times for "
                             f"{calls['full_features']} full_features calls and "
                             f"{calls['stats_features']} stats_features calls (expected 31)")
    if not (launches["lr_fused"] == calls["train_step"] + calls["eval_step"]
            and launches["lr_fused_bwd"] == calls["train_step"] > 0):
        raise AssertionError(f"launches {launches} for {calls}")

    # the cache
    with open(os.path.join(cache, "metadata.json")) as f:
        meta = json.load(f)
    st = meta["stats"]
    if not (all(math.isfinite(v) for v in st.values())
            and min(st["p_std"], st["e_std"], st["c_std"]) > 1e-5):
        raise AssertionError(f"bad stats {st}")
    audio_s = 0.0
    for name, (n_ph, n_fr) in zip(meta["files"], meta["lengths"]):
        with np.load(os.path.join(cache, name), allow_pickle=True) as u:
            arrays = {k: u[k] for k in u.files if k != "phs"}
            n_phs = len(u["phs"])
        if not (all(np.isfinite(a).all() for a in arrays.values())
                and int(arrays["durs"].sum()) == arrays["mel"].shape[0] == n_fr
                and n_phs == n_ph == len(arrays["pitch"]) and arrays["mel"].shape[1] == 80):
            raise AssertionError(f"bad cache entry {name}")
        audio_s += (n_fr - 1) * 256 / 22050
    stats_s = marks["pass2_start"] - marks["build_start"]
    pass2_s = marks["build_end"] - marks["pass2_start"]
    n_utt = len(meta["files"])
    log(f"phase 8: cli.train --data_dir: {n_utt} utterances cached ({audio_s:.1f} s of audio), "
        f"stats pass {stats_s:.2f} s over {calls['stats_features']} files, pass 2 {pass2_s:.2f} s "
        f"({1e3 * pass2_s / n_utt:.1f} ms per utterance, {1e3 * pass2_s / audio_s:.1f} ms per "
        f"second of audio), build {marks['build_end'] - marks['build_start']:.2f} s, whole "
        f"command {run_s:.2f} s; {calls['train_step']} train steps, {calls['eval_step']} eval "
        f"forwards; launches {json.dumps(launches)}; stats {json.dumps(st)}")

    # one 10 s utterance: repeat (bit-equal?) and profile
    y, _ = read_wav(os.path.join(corpus, "clip03.wav"))
    fx = FeatureExtractor()
    first = fx.full_features(y)
    again = fx.full_features(y)
    same = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(first, again))
    log(f"phase 8: full_features of a 10 s utterance ({len(y)} samples, {first[0].shape[1]} "
        f"frames) twice on the card: bit-equal {same}")
    prof = _profile_stages("phase 8 profile: full_features, 10 s utterance",
                           lambda: fx.full_features(y), STAGES)
    k2_names = [k for k in prof["kernel_names"] if "log_mel" in k]
    log(f"phase 8: K2 in the profile by name: {k2_names or 'not seen'}")
    return launches, kept, {"utterances": n_utt, "audio_s": audio_s, "stats_s": stats_s,
                            "pass2_s": pass2_s, "repeat_bit_equal": same, "profile": prof}, \
        (corpus, tg)


@torch.inference_mode()
def phase8b_extraction_inputs(kept, label="phase 8b", path="features"):
    """K2 against its plain version on the signals a build gave it (phase 8,
    or 11 for 11b), one per bucket size, after the counts were read."""
    cases = [{**_k2_case(*args, **kw), "main_path": path}
             for args, kw in kept["fused_log_mel"].values()]
    for c in cases:
        log(f"{label}: K2 within 2e-4 of plain on extraction-path inputs", json.dumps(c))
    if not cases:
        raise AssertionError("the extraction path called no K2")
    return cases


def phase9_extraction_card_vs_cpu(tmp, corpus, tg):
    """Four utterances (one of 10 s, one resampled from 16 kHz, TextGrids
    and transcripts) built on the CPU and on the card."""
    import shutil

    from spev_tpu_torch.data.dataset import SpevDataset

    sub = os.path.join(tmp, "p9_corpus")
    os.makedirs(sub)
    for name in ("clip01", "clip03", "clip04", "clip07"):
        for ext in (".wav", ".txt"):
            if os.path.exists(os.path.join(corpus, name + ext)):
                shutil.copy(os.path.join(corpus, name + ext), sub)
    t0 = time.perf_counter()
    cpu = SpevDataset(sub, textgrid_dir=tg, cache_dir=os.path.join(tmp, "p9_cpu"), device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = SpevDataset(sub, textgrid_dir=tg, cache_dir=os.path.join(tmp, "p9_card"))
    card_s = time.perf_counter() - t0
    if not (cpu.files == card.files and len(cpu.files) == 4
            and [tuple(x) for x in cpu.lengths] == [tuple(x) for x in card.lengths]):
        raise AssertionError(f"files or lengths differ: {cpu.lengths} vs {card.lengths}")
    mel_err, diffs = 0.0, {k: [] for k in ("pitch", "energy", "breath", "rough", "bright",
                                          "nasal")}
    for i in range(4):
        a, b = cpu.load_utterance(i), card.load_utterance(i)
        if not (list(a["phs"]) == list(b["phs"]) and np.array_equal(a["durs"], b["durs"])):
            raise AssertionError(f"phonemes or durations differ in utterance {i}")
        mel_err = max(mel_err, float(np.abs(a["mel"] - b["mel"]).max()))
        for k in diffs:
            diffs[k].append(np.abs(a[k] - b[k]))
    stats_rel = max(abs(cpu.stats[k] - card.stats[k]) / abs(cpu.stats[k]) for k in cpu.stats)
    report, ok = {}, mel_err <= 2e-4
    for k, v in diffs.items():
        v = np.concatenate(v)
        within = float((v <= 1e-3).mean())
        report[k] = {"phonemes": int(v.size), "within_1e-3": within, "max": float(v.max())}
        ok = ok and within >= 0.99 and v.max() <= 0.1
    log(f"phase 9: extraction card vs CPU, 4 utterances ({sum(t for _, t in cpu.lengths)} "
        f"frames): CPU build {cpu_s:.2f} s, card build {card_s:.2f} s; phonemes, durations, "
        f"lengths equal; mel max |diff| {mel_err:.3e} (<= 2e-4); stats max rel diff "
        f"{stats_rel:.3e}; targets (<= 1e-3 on 99 %, <= 0.1 on all): {json.dumps(report)}")
    if not ok:
        raise AssertionError("the card's extraction disagrees with the CPU's")


def _write_advanced_spev(tmp):
    """The full-width advanced checkpoint, written by the port's .spev
    writer; returns (path, write seconds)."""
    from spev_tpu_torch.config import ModelConfig
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.checkpoint import model_config_dict, save_spev

    g2p = G2P("rules")
    vocab = Vocab.build({p for t in TEXTS + [ADV_TEXT, ADV_SHORT] for p in g2p.phonemes(t)})
    cfg = ModelConfig(vocab_size=len(vocab), use_vad=True, use_nasality=True, n_speakers=4,
                      vp_output_norm=False)
    model = FastSpeech2.random_init(cfg, seed=2)
    g = torch.Generator().manual_seed(3)
    H = cfg.hidden_dim
    with torch.no_grad():
        # per-phoneme durations near 6 frames: small proj weights, log 7 bias
        model.duration_predictor.proj.weight.mul_(0.05)
        model.duration_predictor.proj.bias.fill_(math.log(7.0))
        model.advanced.vad_proj.weight.copy_(torch.randn(H, 3, generator=g) * 0.5)
        model.advanced.vad_proj.bias.copy_(torch.randn(H, generator=g) * 0.1)
        model.advanced.speaker_embedding.weight.copy_(torch.randn(4, H, generator=g) * 0.5)
    path = os.path.join(tmp, "advanced.spev")
    t0 = time.perf_counter()
    save_spev(path, model.state_dict(), vocab=vocab.symbols, stats={},
              model_config=model_config_dict(cfg))
    return path, time.perf_counter() - t0


def _expected_wav_len(synth, text, mel_frames, controls):
    """The breath path's waveform length: the mel's frames × 256 plus each
    planned inhale, int(sr · duration), and its two int(0.06 · sr) pauses."""
    from spev_tpu_torch.agents.breath import plan_breaths, split_phrases
    from spev_tpu_torch.agents.prosody import vad_to_knobs
    from spev_tpu_torch.models.advanced import lung_capacity_effect

    sr = synth.audio.sample_rate
    knobs = vad_to_knobs(controls["valence"], controls["arousal"], controls["dominance"])
    duration_s = 1.0 * knobs["duration_scale"] * lung_capacity_effect(
        controls["lung_capacity"]).duration_scale
    phrases = split_phrases(text)
    plan = plan_breaths([len(synth.g2p.phonemes(p)) for p in phrases],
                        controls["lung_capacity"], duration_scale=duration_s)
    inhales = [e for e in plan if e is not None]
    extra = sum(int(sr * e.duration) + 2 * int(0.06 * sr) for e in inhales)
    return mel_frames * 256 + extra, len(phrases), len(inhales)


def phase10_advanced(pt, hdir, tmp):
    import spev_tpu_torch.infer.vocoder as voc_mod
    from spev_tpu_torch.cli.spev_advanced import main as adv_cli
    from spev_tpu_torch.infer.advanced_api import synthesize_advanced_controls
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.kernels import overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused

    spev, write_s = _write_advanced_spev(tmp)
    t0 = time.perf_counter()
    synth = Synthesizer(spev, hifigan_dir=hdir, g2p_backend="rules")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    synth_gl = Synthesizer(spev, hifigan_dir=None, g2p_backend="rules")
    if not (synth.has_advanced and synth.model_cfg.use_nasality
            and synth.model_cfg.n_speakers == 4 and not synth.model_cfg.vp_output_norm):
        raise AssertionError("the .spev's model config did not come through")
    log(f"phase 10: wrote {spev} ({os.path.getsize(spev) / 2**20:.1f} MiB, "
        f"{sum(p.numel() for p in synth.model.parameters())} parameters) in {write_s:.2f} s; "
        f"Synthesizer(.spev) on the card in {load_s:.2f} s")
    short = "this is a quick test of the speech system"
    contrasts = {"neutral": dict(speaker=0),
                 "vad": dict(speaker=0, valence=-0.5, arousal=0.6, dominance=-0.3),
                 "speaker_2": dict(speaker=2), "emphasis_1": dict(word_emphasis="1,1,1,1"),
                 "emphasis": dict(word_emphasis="1,1.5,1,2")}
    # warm-up with the same requests, outside the counted run
    synthesize_advanced_controls(synth, ADV_TEXT, **ADV_CONTROLS)
    synthesize_advanced_controls(synth_gl, ADV_TEXT, **ADV_CONTROLS)
    for kw in contrasts.values():
        synthesize_advanced_controls(synth, short, **kw)
    torch.cuda.synchronize()

    counts = {"acoustic_passes": 0, "griffin_lim_vocodings": 0}
    orig_ac, orig_gl = Synthesizer._acoustic, voc_mod.mel_to_audio

    def counted_ac(self, *a, **k):
        counts["acoustic_passes"] += 1
        return orig_ac(self, *a, **k)

    def counted_gl(*a, **k):
        counts["griffin_lim_vocodings"] += 1
        return orig_gl(*a, **k)

    Synthesizer._acoustic, voc_mod.mel_to_audio = counted_ac, counted_gl
    timings, mels = {}, {}
    out_wav = os.path.join(tmp, "advanced.wav")
    flags = ["--breathiness", "0.3", "--roughness", "0.2", "--nasality", "0.4", "--valence",
             "-0.5", "--arousal", "0.6", "--dominance", "-0.3", "--age", "60", "--speaker", "2",
             "--word_emphasis", "1,1.5,1,2", "--lung_capacity", "0.3"]
    try:
        with _keep_kernel_inputs() as kept:
            lr_fused.launches = 0
            overlap_add.launches = 0
            t = time.perf_counter()
            t0 = time.perf_counter()
            if adv_cli(["--mode", "infer", "--checkpoint", spev, "--hifigan_dir", hdir,
                        "--text", ADV_TEXT, "--output", out_wav] + flags) != 0 \
                    or not os.path.getsize(out_wav) > 44:
                raise AssertionError("cli.spev_advanced did not write a waveform")
            timings["cli_spev_advanced"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            wav_h, mel_h = synthesize_advanced_controls(synth, ADV_TEXT, **ADV_CONTROLS)
            timings["advanced_hifigan"] = time.perf_counter() - t0
            gl_before = counts["griffin_lim_vocodings"]
            t0 = time.perf_counter()
            wav_g, mel_g = synthesize_advanced_controls(synth_gl, ADV_TEXT, **ADV_CONTROLS)
            timings["advanced_griffin_lim"] = time.perf_counter() - t0
            gl_vocodings = counts["griffin_lim_vocodings"] - gl_before
            for name, kw in contrasts.items():
                t0 = time.perf_counter()
                mels[name] = synthesize_advanced_controls(synth, short, **kw)[1]
                timings[f"contrast_{name}"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t
            launches = {"lr_fused": lr_fused.launches, "overlap_add": overlap_add.launches}
    finally:
        Synthesizer._acoustic, voc_mod.mel_to_audio = orig_ac, orig_gl
    for wav, mel in ((wav_h, mel_h), (wav_g, mel_g), *((None, m) for m in mels.values())):
        if not (np.isfinite(mel).all() and (wav is None or np.isfinite(wav).all())):
            raise AssertionError("non-finite output on the advanced path")
    if launches["lr_fused"] != counts["acoustic_passes"]:
        raise AssertionError(f"K1 ran {launches['lr_fused']} times for "
                             f"{counts['acoustic_passes']} acoustic passes")
    expect, n_phrases, n_inhales = _expected_wav_len(synth, ADV_TEXT, mel_h.shape[0],
                                                     ADV_CONTROLS)
    if not (n_phrases >= 3 and n_inhales >= 1):
        raise AssertionError(f"{n_phrases} phrases and {n_inhales} planned inhales")
    if (launches["overlap_add"] != 33 * counts["griffin_lim_vocodings"]
            or gl_vocodings != 2 * n_phrases):
        raise AssertionError(f"K3 ran {launches['overlap_add']} times for "
                             f"{counts['griffin_lim_vocodings']} Griffin-Lim vocodings "
                             f"({gl_vocodings} for the request; {2 * n_phrases} expected)")
    expect_g = _expected_wav_len(synth_gl, ADV_TEXT, mel_g.shape[0], ADV_CONTROLS)[0]
    if len(wav_h) != expect or len(wav_g) != expect_g:
        raise AssertionError(f"waveform lengths {len(wav_h)} / {len(wav_g)}, expected "
                             f"{expect} / {expect_g}")
    for a, b in (("neutral", "vad"), ("neutral", "speaker_2")):
        if mels[a].shape == mels[b].shape and np.array_equal(mels[a], mels[b]):
            raise AssertionError(f"{b} did not move the mel")
    if not mels["emphasis"].shape[0] > mels["emphasis_1"].shape[0]:
        raise AssertionError("word emphasis did not lengthen the utterance")
    for name, sec in timings.items():
        log(f"phase 10: {name}: {sec * 1e3:.1f} ms wall")
    vad_delta = (float(np.abs(mels["vad"] - mels["neutral"]).mean())
                 if mels["vad"].shape == mels["neutral"].shape else "lengths differ")
    log(f"phase 10: advanced path {total_s * 1e3:.1f} ms; {n_phrases} phrases, {n_inhales} "
        f"inhales; HiFi-GAN {mel_h.shape[0]} frames → {len(wav_h)} samples, Griffin-Lim "
        f"{mel_g.shape[0]} frames → {len(wav_g)} samples (frames × 256 + inhales and pauses); "
        f"frames: emphasis 1 {mels['emphasis_1'].shape[0]}, emphasised "
        f"{mels['emphasis'].shape[0]}; mel mean |VAD − neutral| {vad_delta}; counts {json.dumps(counts)}; launches {json.dumps(launches)}")
    _profile_one("phase 10 profile: advanced HiFi-GAN request",
                 lambda: synthesize_advanced_controls(synth, ADV_TEXT, **ADV_CONTROLS))

    rt = os.path.join(tmp, "roundtrip.spev")
    from spev_tpu_torch.cli.convert import main as convert_main

    if convert_main(["to-spev", pt, rt]) != 0:
        raise AssertionError("cli.convert to-spev failed")
    m_pt = Synthesizer(pt, hifigan_dir=hdir, g2p_backend="rules").synthesize(TEXTS[1])[1]
    m_rt = Synthesizer(rt, hifigan_dir=hdir, g2p_backend="rules").synthesize(TEXTS[1])[1]
    if not np.array_equal(m_pt, m_rt):
        raise AssertionError(".pt → .spev changed the mel")
    log(f"phase 10: .pt → cli.convert to-spev → Synthesizer: mel bit-equal ({m_rt.shape[0]} "
        "frames)")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = Synthesizer(spev, hifigan_dir=hdir, g2p_backend="rules", device="cpu")
        t0 = time.perf_counter()
        w_cpu, m_cpu = synthesize_advanced_controls(cpu, ADV_SHORT, **ADV_CONTROLS)
        cpu_s = time.perf_counter() - t0
        w_gpu, m_gpu = synthesize_advanced_controls(synth, ADV_SHORT, **ADV_CONTROLS)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    if m_cpu.shape != m_gpu.shape or w_cpu.shape != w_gpu.shape:
        raise AssertionError(f"lengths differ: cpu {m_cpu.shape} {w_cpu.shape}, card "
                             f"{m_gpu.shape} {w_gpu.shape}")
    mel_mae = float(np.abs(m_cpu - m_gpu).mean())
    wav_mae = float(np.abs(w_cpu - w_gpu).mean())
    n_inh = _expected_wav_len(cpu, ADV_SHORT, m_cpu.shape[0], ADV_CONTROLS)[2]
    log(f"phase 10: advanced request card vs CPU (TF32 off; {n_inh} inhale; CPU "
        f"{cpu_s:.2f} s): mel_len {m_gpu.shape[0]} and wav length {len(w_gpu)} equal, mel MAE "
        f"{mel_mae:.3e} (< 1e-4), wav MAE {wav_mae:.3e} (< 1e-4) on a waveform of mean |x| "
        f"{float(np.abs(w_cpu).mean()):.3e}")
    if not (mel_mae < 1e-4 and wav_mae < 1e-4):
        raise AssertionError("the card disagrees with the CPU on the advanced path")
    return launches, kept


# phase 11: an ESD-style corpus, {speaker}_{utterance}_{emotion}
ESD_EMOTIONS = ["angry", "happy", "neutral", "sad", "surprise"]
ESD_SPEAKERS = ["0011", "0012", "0013"]


def _write_labelled_corpus(root, seed=11):
    """3 speakers × the 5 ESD emotions × 2 utterances of 1-4 s, speech-like
    as phase 8's, named ``{spk}_{utt:06d}_{emotion}.wav`` with a transcript
    each.  Returns the names in the build's (sorted) order."""
    from spev_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(root)
    words = " ".join(TEXTS).split()
    names = []
    for spk in ESD_SPEAKERS:
        for emo in ESD_EMOTIONS:
            for _ in range(2):
                n = int(rng.uniform(1.0, 4.0) * 22050)
                y, _ = _speech_like(rng, n, 22050)
                name = f"{spk}_{len(names):06d}_{emo}"
                write_wav(os.path.join(root, name + ".wav"), y, 22050)
                k = max(2, int(n / 22050 * 2))
                start = int(rng.integers(0, len(words)))
                with open(os.path.join(root, name + ".txt"), "w") as f:
                    f.write(" ".join(words[(start + j) % len(words)] for j in range(k)))
                names.append(name)
    return names


def _check_train_state(path):
    """``path``'s optimizer is optax's chain state of JAX's make_optimizer:
    ``{'0': {}, '1': {'0': {count, mu, nu}, '1': {}, '2': {count}}}``, mu
    and nu shaped as the file's model in float32, both counts int32 and
    equal to the step.  Returns (step, number of parameter leaves)."""
    from spev_tpu_torch.train.checkpoint import load_spev

    ck = load_spev(path)
    opt, step = ck["optimizer"], ck["meta"]["step_num"]

    def shapes(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in shapes(sub, f"{pre}/{key}").items()}
        return {pre: (tree.shape, tree.dtype)}

    want = shapes(ck["model"])
    adam = opt["1"]["0"]
    ok = (opt["0"] == {} and opt["1"]["1"] == {} and sorted(opt) == ["0", "1"]
          and sorted(opt["1"]) == ["0", "1", "2"] and sorted(adam) == ["count", "mu", "nu"]
          and shapes(adam["mu"]) == shapes(adam["nu"]) == want
          and all(d == np.float32 for _, d in want.values())
          and adam["count"].dtype == opt["1"]["2"]["count"].dtype == np.int32
          and int(adam["count"]) == int(opt["1"]["2"]["count"]) == step)
    if not ok:
        raise AssertionError(f"{path}: the optimizer tree is not optax's AdamW chain state")
    return step, len(want)


def phase11_advanced_training(tmp):
    """Advanced training at full width through ``cli.spev_advanced --mode
    train --multi_speaker --emotion_labels`` from a labelled corpus, counted;
    the cache's labels and the train state checked; a resumed epoch;
    ``Synthesizer(best.spev)`` with a speaker and a VAD point; then ten
    advanced steps on one fixed batch, timed and profiled, and the
    ``.spev`` train state's save and restore timed."""
    from spev_tpu_torch.cli import spev_advanced as adv_cli
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.data.dataset import FeatureExtractor, SpevDataset
    from spev_tpu_torch.data.emotion import EMOTION_VAD
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    corpus, cache = os.path.join(tmp, "p11_corpus"), os.path.join(tmp, "p11_cache")
    t0 = time.perf_counter()
    names = _write_labelled_corpus(corpus)
    log(f"phase 11: wrote a {len(names)}-file labelled corpus ({len(ESD_SPEAKERS)} speakers × "
        f"{len(ESD_EMOTIONS)} emotions × 2) in {time.perf_counter() - t0:.2f} s")
    calls = {"full_features": 0, "train_step": 0, "eval_step": 0}
    originals = {}
    for cls, name in ((FeatureExtractor, "full_features"), (Trainer, "train_step"),
                      (Trainer, "eval_step")):
        originals[name] = getattr(cls, name)

        def call(self, *a, _name=name, **k):
            calls[_name] += 1
            return originals[_name](self, *a, **k)
        setattr(cls, name, call)
    argv = ["--mode", "train", "--data_dir", corpus, "--textgrid_dir",
            os.path.join(tmp, "p11_no_textgrids"), "--cache_dir", cache, "--name", "adv11",
            "--epochs", "2", "--batch_size", "16", "--multi_speaker", "--emotion_labels"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _keep_kernel_inputs() as kept:
            fused_log_mel.launches = 0
            lr_fused.launches = 0
            lr_fused_bwd.launches = 0
            t0 = time.perf_counter()
            rc = adv_cli.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"fused_log_mel": fused_log_mel.launches, "lr_fused": lr_fused.launches,
                        "lr_fused_bwd": lr_fused_bwd.launches}
        counted = dict(calls)
        t0 = time.perf_counter()
        ck = os.path.join(tmp, "checkpoints", "adv11")
        rc_resume = adv_cli.main([a if a != "2" else "3" for a in argv]
                                 + ["--resume", os.path.join(ck, "last.spev")])
        resume_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        FeatureExtractor.full_features = originals["full_features"]
        Trainer.train_step, Trainer.eval_step = originals["train_step"], originals["eval_step"]
    if rc != 0 or rc_resume != 0:
        raise AssertionError(f"cli.spev_advanced --mode train exited with {rc} / {rc_resume}")
    if not (launches["fused_log_mel"] == counted["full_features"] == len(names)
            and launches["lr_fused"] == counted["train_step"] + counted["eval_step"]
            and launches["lr_fused_bwd"] == counted["train_step"] > 0):
        raise AssertionError(f"launches {launches} for {counted} ({len(names)} utterances)")

    with open(os.path.join(cache, "metadata.json")) as f:
        meta = json.load(f)
    if not (meta["speakers"] == ESD_SPEAKERS and meta["emotions"] == ESD_EMOTIONS
            and meta["emotion_counts"] == {e: 6 for e in ESD_EMOTIONS}
            and len(meta["files"]) == len(names)):
        raise AssertionError(f"cache labels: {meta['speakers']} {meta.get('emotion_counts')}")
    for i, file in enumerate(meta["files"]):
        spk, _, emo = names[i].split("_")
        with np.load(os.path.join(cache, file), allow_pickle=True) as u:
            if not (u["speaker_id"].dtype == np.int32 and int(u["speaker_id"]) ==
                    ESD_SPEAKERS.index(spk) and u["vad"].dtype == np.float32
                    and np.array_equal(u["vad"], np.asarray(EMOTION_VAD[emo], np.float32))):
                raise AssertionError(f"{file} ({names[i]}): speaker_id / vad wrong")
    if sorted(os.listdir(ck)) != ["best.spev", "last.spev"]:
        raise AssertionError(f"the advanced run wrote {sorted(os.listdir(ck))}")
    step, n_leaves = _check_train_state(os.path.join(ck, "last.spev"))
    rows = [json.loads(line) for line in open(os.path.join(tmp, "logs", "adv11", "metrics.jsonl"))]
    if [r["step"] for r in rows] != [0, 1, 2] or not all(
            math.isfinite(r["train_loss"]) and r["skipped"] == 0 for r in rows):
        raise AssertionError(f"metrics.jsonl: {rows}")
    log(f"phase 11: cli.spev_advanced --mode train --multi_speaker --emotion_labels: "
        f"{len(meta['files'])} utterances cached with speakers {meta['speakers']} and emotions "
        f"{json.dumps(meta['emotion_counts'])}; {counted['train_step']} train steps, "
        f"{counted['eval_step']} eval forwards in {run_s:.2f} s (build included); launches "
        f"{json.dumps(launches)}; resumed one epoch from last.spev in {resume_s:.2f} s, after "
        f"which last.spev holds step {step} and optax's chain state over {n_leaves} leaves; "
        f"metrics.jsonl "
        + json.dumps(rows))

    synth = Synthesizer(os.path.join(ck, "best.spev"), hifigan_dir=None, g2p_backend="rules")
    if not (synth.has_advanced and synth.model_cfg.n_speakers == 3 and synth.model_cfg.use_vad
            and synth.model_cfg.use_nasality and not synth.model_cfg.vp_output_norm):
        raise AssertionError("Synthesizer(best.spev) did not get the advanced config")
    ids = synth.phonemes_to_ids(synth.g2p.phonemes(TEXTS[0]))
    wav, mel = synth.synthesize_ids(ids, speaker_id=1, vad=EMOTION_VAD["happy"])
    if not (np.isfinite(wav).all() and np.isfinite(mel).all() and mel.shape[1] == 80
            and len(wav) == mel.shape[0] * 256):
        raise AssertionError(f"Synthesizer(best.spev): wav {wav.shape}, mel {mel.shape}")
    log(f"phase 11: Synthesizer(best.spev) on the card with speaker 1 and VAD happy: "
        f"{mel.shape[0]} frames, finite")

    # ten advanced steps on phase 6's fixed (128, 1024) batch, dropout off
    ds = SpevDataset(None, cache_dir=os.path.join(tmp, "cache"))
    vocab = Vocab(ds.vocab)
    batch = next(b for b in BucketBatcher(ds, vocab, batch_size=16).epoch(0)
                 if b["mel"].shape[1] == 1024 and b["ids"].shape[1] == 128)
    batch["speaker_ids"] = (np.arange(16) % 3).astype(np.int32)
    batch["vad"] = np.asarray([EMOTION_VAD[ESD_EMOTIONS[k % 5]] for k in range(16)], np.float32)
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False, dropout=0.0,
                                       vp_dropout=0.0, use_vad=True, use_nasality=True,
                                       n_speakers=3),
                     train=TrainConfig(warmup_steps=20, matmul_precision="high"))
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "p11_fixed"),
                      log_dir=os.path.join(tmp, "p11_fixed"))
    tb = trainer.to_device(batch)
    losses, times = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        m = trainer.train_step(tb)
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ten advanced steps on one batch did not lower the loss: {losses}")
    step_s = float(np.mean(times[2:]))
    frames = int(batch["mel_lens"].sum())
    n_params = sum(p.numel() for p in trainer.params)
    log(f"phase 11: fixed batch B=16 P=128 M=1024 ({frames} target frames), advanced model "
        f"({n_params} parameters; VAD, nasality, 3 speakers), dropout off: losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; steady-state train step {step_s * 1e3:.2f} ms "
        f"(mean of steps 3-10; min {min(times[2:]) * 1e3:.2f}, max {max(times[2:]) * 1e3:.2f}), "
        f"{frames / step_s:.0f} target frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = _profile_one("phase 11 profile: advanced train_step B=16 P=128 M=1024",
                           lambda: trainer.train_step(tb))
    if any("tf32" in k.lower() for k in kernels):
        raise AssertionError("the advanced train step ran TF32 kernels")

    t0 = time.perf_counter()
    path = trainer.save("last")
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    fresh = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "p11_fixed"),
                    log_dir=os.path.join(tmp, "p11_fixed"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    p_old, p_new = trainer.params[-1], fresh.params[-1]
    if not (fresh.step == trainer.step and _check_train_state(path)[0] == trainer.step
            and all(torch.equal(a, b) for a, b in zip(trainer.params, fresh.params))
            and torch.equal(trainer.optimizer.state[p_old]["exp_avg_sq"],
                            fresh.optimizer.state[p_new]["exp_avg_sq"])):
        raise AssertionError("the restored train state differs from the saved one")
    after = [fresh.train_step(tb)["loss"], trainer.train_step(tb)["loss"]]
    if not abs(after[0] - after[1]) <= 1e-6 * abs(after[1]):
        raise AssertionError(f"the resumed step differs: {after}")
    log(f"phase 11: Trainer.save('last') with the optimizer: {size / 2**20:.1f} MiB written in "
        f"{save_s:.2f} s; restore into a fresh Trainer on the card in {restore_s:.2f} s; the "
        f"next step's loss {after[0]:.6f} resumed, {after[1]:.6f} straight on (within 1e-6)")
    return launches, kept, {"step_ms": step_s * 1e3, "save_s": save_s, "restore_s": restore_s}


def phase12_advanced_step_card_vs_cpu(tmp):
    """Phase 7's comparison for the advanced model (VAD, nasality, 3
    speakers) with speaker ids and VAD targets in the batch."""
    from spev_tpu_torch.data.emotion import EMOTION_VAD

    extra = {"speaker_ids": np.asarray([0, 2], np.int32),
             "vad": np.asarray([EMOTION_VAD["angry"], EMOTION_VAD["sad"]], np.float32)}
    _train_step_card_vs_cpu(tmp, "phase 12", {"use_vad": True, "use_nasality": True,
                                              "n_speakers": 3}, extra)


AGENT_TEXT = "I made it [sigh] but I am so tired [breath] let us go"


def phase13_agent(spev, hdir, tmp):
    """The embodied agent through ``cli.embodied`` (static and temporal,
    HiFi-GAN and Griffin-Lim) and ``EmbodiedAgent`` on phase 10's
    ``.spev``, counted; then one static HiFi-GAN request on the card against
    the CPU."""
    import spev_tpu_torch.infer.vocoder as voc_mod
    from spev_tpu_torch.agents.embodied import EmbodiedAgent
    from spev_tpu_torch.cli import embodied as emb_cli
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.ops.cuda.kernels import overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused
    from spev_tpu_torch.utils.wavio import read_wav

    synth_h = Synthesizer(spev, hifigan_dir=hdir)
    synth_g = Synthesizer(spev, hifigan_dir=None)
    agents = {f"{mode}_{voc}": EmbodiedAgent(None, synthesizer=s, temporal=mode == "temporal")
              for mode in ("static", "temporal")
              for voc, s in (("hifigan", synth_h), ("griffin_lim", synth_g))}
    emotions = {"static": "exhausted", "temporal": "relief"}
    for name, agent in agents.items():  # warm-up, outside the counted run
        agent.synthesize(AGENT_TEXT, emotions[name.split("_")[0]])
    torch.cuda.synchronize()

    counts = {"acoustic_passes": 0, "griffin_lim_vocodings": 0}
    orig_ac, orig_gl = Synthesizer._acoustic, voc_mod.mel_to_audio

    def counted_ac(self, *a, **k):
        counts["acoustic_passes"] += 1
        return orig_ac(self, *a, **k)

    def counted_gl(*a, **k):
        counts["griffin_lim_vocodings"] += 1
        return orig_gl(*a, **k)

    Synthesizer._acoustic, voc_mod.mel_to_audio = counted_ac, counted_gl
    timings, wavs, requests = {}, {}, 0
    try:
        with _keep_kernel_inputs() as kept:
            lr_fused.launches = 0
            overlap_add.launches = 0
            t = time.perf_counter()
            for mode, main in (("static", emb_cli.main), ("temporal", emb_cli.temporal_main)):
                for voc, d in (("hifigan", hdir), ("griffin_lim", os.path.join(tmp, "none"))):
                    out = os.path.join(tmp, f"agent_{mode}_{voc}.wav")
                    t0 = time.perf_counter()
                    rc = main(["--text", AGENT_TEXT, "--emotion", emotions[mode], "--checkpoint",
                               spev, "--hifigan_dir", d, "--output", out])
                    timings[f"cli_{mode}_{voc}"] = time.perf_counter() - t0
                    requests += 1
                    if rc != 0 or len(read_wav(out)[0]) < 22050:
                        raise AssertionError(f"cli.embodied ({mode}, {voc}) exited with {rc}")
            for name, agent in agents.items():
                t0 = time.perf_counter()
                wavs[name] = agent.synthesize(AGENT_TEXT, emotions[name.split("_")[0]])
                timings[name] = time.perf_counter() - t0
                requests += 1
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t
            launches = {"lr_fused": lr_fused.launches, "overlap_add": overlap_add.launches}
    finally:
        Synthesizer._acoustic, voc_mod.mel_to_audio = orig_ac, orig_gl
    events = {"static": int(22050 * 1.2) + int(22050 * 0.4),
              "temporal": int(22050 * 1.0) + int(22050 * 0.5)}
    for name, wav in wavs.items():
        mode = name.split("_")[0]
        speech = len(wav) - events[mode] - 2 * 2205
        if not (np.isfinite(wav).all() and speech > 0 and speech % 256 == 0):
            raise AssertionError(f"{name}: {len(wav)} samples ({speech} of speech)")
    if not (launches["lr_fused"] == counts["acoustic_passes"] >= 3 * requests
            and launches["overlap_add"] == 33 * counts["griffin_lim_vocodings"]
            and counts["griffin_lim_vocodings"] == 3 * requests // 2):
        raise AssertionError(f"launches {launches} for {counts} ({requests} requests of three "
                             "speech segments, half of them Griffin-Lim)")
    for name, sec in timings.items():
        log(f"phase 13: {name}: {sec * 1e3:.1f} ms wall"
            + (f", {len(wavs[name])} samples = {len(wavs[name]) / 22050:.2f} s of audio"
               if name in wavs else ""))
    log(f"phase 13: agent path {total_s * 1e3:.1f} ms for {requests} requests (4 through the "
        f"CLI, load included); counts {json.dumps(counts)}; launches {json.dumps(launches)}")
    _profile_one("phase 13 profile: static HiFi-GAN agent request",
                 lambda: agents["static_hifigan"].synthesize(AGENT_TEXT, "exhausted"))

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = EmbodiedAgent(spev, hifigan_dir=hdir, device="cpu")
        t0 = time.perf_counter()
        w_cpu = cpu.synthesize(AGENT_TEXT, "exhausted")
        cpu_s = time.perf_counter() - t0
        w_gpu = EmbodiedAgent(spev, hifigan_dir=hdir).synthesize(AGENT_TEXT, "exhausted")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    mae = float(np.abs(w_cpu - w_gpu).mean()) if w_cpu.shape == w_gpu.shape else math.inf
    log(f"phase 13: static HiFi-GAN agent request card vs CPU (TF32 off; CPU {cpu_s:.2f} s): "
        f"lengths {len(w_gpu)} / {len(w_cpu)}, waveform MAE {mae:.3e} (<= 1e-4) on a waveform "
        f"of mean |x| {float(np.abs(w_cpu).mean()):.3e}")
    if not mae <= 1e-4:
        raise AssertionError("the card disagrees with the CPU on the agent path")
    return launches, kept, {"timings": timings}


# phase 14: the serving stack and checkpoint evaluation
SERVE_STREAM_TEXT = ADV_TEXT  # three clauses
CONCURRENCY = (1, 4, 16)


def _serve_payloads(level):
    """Sixteen /synthesize bodies over TEXTS with mixed pitch, duration and
    breathiness; ``level`` sets energy_scale, so no two runs share a
    response-cache key (and no two bodies of a run do)."""
    return [{"text": TEXTS[i % 8], "pitch_scale": round(0.9 + 0.05 * (i % 5), 2),
             "duration_scale": round(0.9 + 0.1 * (i % 3), 2),
             "breathiness": round(0.1 * (i % 4), 2), "energy_scale": round(1.0 - 0.01 * level, 2)}
            for i in range(16)]


def _start_server(name, spev, hdir, tmp):
    """``python -m spev_tpu_torch.cli.serve`` on a free port, as a user starts
    it; returns (process, base url, log path)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "spev_tpu_torch.cli.serve", "--checkpoint", spev,
            "--port", str(port), "--g2p", "rules", "--max_batch", "16", "--batch_window_ms", "5",
            "--response_cache", "256"] + (["--hifigan_dir", hdir] if hdir else [])
    log_path = os.path.join(tmp, f"serve_{name}.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=out, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path


def _healthz(base, proc=None, log_path=None, wait_s=0.0):
    """GET /healthz; with ``wait_s`` it polls until the server answers."""
    import urllib.request

    deadline = time.perf_counter() + wait_s
    while True:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                return json.loads(r.read())
        except OSError:
            if proc is not None and proc.poll() is not None or time.perf_counter() > deadline:
                tail = open(log_path).read()[-3000:] if log_path else ""
                raise AssertionError(f"the server at {base} did not answer:\n{tail}") from None
            time.sleep(0.2)


def _post(base, path, payload, stream=False):
    """(status, body, seconds to the first PCM byte or None, seconds to the end)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, first = r.status, None
            if stream:
                body = r.read(44)
                body += r.read(1)  # blocks until the first clause's PCM
                first = time.perf_counter() - t0
                body += r.read()
            else:
                body = r.read()
    except urllib.error.HTTPError as e:
        status, body, first = e.code, e.read(), None
    return status, body, first, time.perf_counter() - t0


def _fire(base, payloads, concurrency):
    """Send the bodies to /synthesize from ``concurrency`` client threads,
    started together; returns the results in order and the total seconds."""
    import threading

    results = [None] * len(payloads)
    queue_, lock = list(range(len(payloads))), threading.Lock()
    barrier = threading.Barrier(concurrency + 1)

    def client():
        barrier.wait()
        while True:
            with lock:
                if not queue_:
                    return
                i = queue_.pop(0)
            results[i] = _post(base, "/synthesize", payloads[i])

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    return results, time.perf_counter() - t0


def _wav_pcm(status, body, what, whole_hops=True):
    """A 200 with a mono 16-bit 22050 Hz WAV whose data fill the body; its PCM."""
    import io
    import wave

    if status != 200:
        raise AssertionError(f"{what}: status {status}: {body[:300]!r}")
    with wave.open(io.BytesIO(body)) as w:
        fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
        n = w.getnframes()
    if fmt != (1, 2, 22050) or n == 0 or len(body) != 44 + 2 * n:
        raise AssertionError(f"{what}: not a valid WAV ({fmt}, {n} frames, {len(body)} bytes)")
    if whole_hops and n % 256:
        raise AssertionError(f"{what}: {n} samples is not whole hops")
    return np.frombuffer(body[44:], "<i2").astype(np.int32)


def _stream_pcm(status, body, what):
    from spev_tpu_torch.cli.serve import _wav_stream_header

    if status != 200 or body[:44] != _wav_stream_header(22050):
        raise AssertionError(f"{what}: status {status}, header {body[:44]!r}")
    if len(body) == 44 or (len(body) - 44) % 512:
        raise AssertionError(f"{what}: {len(body) - 44} bytes of PCM is not whole hops")
    return np.frombuffer(body[44:], "<i2")


def _row_errors(rows_a, rows_b):
    """(mel, wav) max |d| between two lists of (wav, mel) rows of equal
    lengths (inf when a length differs)."""
    mel_err = wav_err = 0.0
    for (w1, m1), (w2, m2) in zip(rows_a, rows_b):
        if w1.shape != w2.shape or m1.shape != m2.shape:
            return math.inf, math.inf
        mel_err = max(mel_err, float(np.abs(m1 - m2).max()))
        wav_err = max(wav_err, float(np.abs(w1 - w2).max()))
    return mel_err, wav_err


def _streams(base, n, pitch0):
    """n concurrent /synthesize_stream of the three-clause text (pitch
    pitch0, pitch0 + 0.1, ...); their results in order."""
    import threading

    out = [None] * n

    def one(i):
        out[i] = _post(base, "/synthesize_stream",
                       {"text": SERVE_STREAM_TEXT, "pitch_scale": round(pitch0 + 0.1 * i, 2)},
                       stream=True)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def _ms(xs):
    xs = sorted(xs)
    return f"p50 {xs[len(xs) // 2] * 1e3:.1f} ms, max {xs[-1] * 1e3:.1f} ms"


def _batch_delta(before, after):
    b, a = before.get("batcher", {}).get("sizes", {}), after["batcher"]["sizes"]
    return {k: v - b.get(k, 0) for k, v in a.items() if v - b.get(k, 0)}


def _launch_delta(before, after):
    return {k: v - before["launches"][k] for k, v in after["launches"].items()}


def phase14_serving_stack(spev, hdir, tmp, card):
    """The serving stack as users run it (two servers in subprocesses) and
    in process on the card (two-phase batches, chunked vocoding, a
    coalesced batch against the CPU), then checkpoint evaluation."""
    import threading

    import spev_tpu_torch.infer.evaluate as eval_mod
    import spev_tpu_torch.infer.vocoder as voc_mod
    from spev_tpu_torch.cli import evaluate as eval_cli
    from spev_tpu_torch.cli.serve import _wav_bytes
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.infer.batching import _DEFAULTS, CoalescingBatcher
    from spev_tpu_torch.infer.evaluate import evaluate_checkpoint
    from spev_tpu_torch.infer.streaming import (receptive_field_frames, split_clauses,
                                                stream_text, stream_vocode)
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.infer.vocoder import Vocoder
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused

    from spev_tpu_torch.utils.platform import fp32_precision

    fails = []  # every check of the phase runs; the phase fails at its end
    servers = [_start_server("hifigan", spev, hdir, tmp), _start_server("griffin_lim", spev,
                                                                        None, tmp)]
    try:
        synth_h = Synthesizer(spev, hifigan_dir=hdir, g2p_backend="rules")
        synth_g = Synthesizer(spev, hifigan_dir=None, g2p_backend="rules")
        gen = synth_h.vocoder.generator
        for two_phase in (False, True):  # warm-up, outside the counted run
            synth_h.synthesize_many(TEXTS, batch_size=4, two_phase=two_phase)
        torch.cuda.synchronize()

        counts = {"acoustic_passes": 0, "griffin_lim_vocodings": 0, "eval_forwards": 0}
        orig_ac, orig_gl, orig_adv = (Synthesizer._acoustic, voc_mod.mel_to_audio,
                                      eval_mod.apply_advanced)

        def counted(key, fn):
            def call(*a, **k):
                counts[key] += 1
                return fn(*a, **k)
            return call

        Synthesizer._acoustic = counted("acoustic_passes", orig_ac)
        voc_mod.mel_to_audio = counted("griffin_lim_vocodings", orig_gl)
        eval_mod.apply_advanced = counted("eval_forwards", orig_adv)
        times = {}
        try:
            with _keep_kernel_inputs() as kept:
                lr_fused.launches = overlap_add.launches = fused_log_mel.launches = 0
                # two-phase against fused, 8 texts at batch 4 (two batches each):
                # timed as served (cuDNN TF32 on), then compared in fp32 too
                rows, errs = {}, {}
                for two_phase in (False, True, True, False):
                    t0 = time.perf_counter()
                    rows[two_phase] = synth_h.synthesize_many(TEXTS, batch_size=4,
                                                              two_phase=two_phase)
                    times.setdefault(f"two_phase={two_phase}", []).append(
                        (time.perf_counter() - t0) / 2)
                errs["served"] = _row_errors(rows[False], rows[True])
                with fp32_precision():
                    errs["fp32"] = _row_errors(*(synth_h.synthesize_many(
                        TEXTS, batch_size=4, two_phase=tp) for tp in (False, True)))
                # chunked vocoding of a 600-frame mel against one full pass
                mel600 = np.concatenate([m for _, m in rows[False]])[:600]
                ctx = receptive_field_frames(gen.cfg) * 256
                stream_err = {}
                for mode in ("served", "fp32"):
                    with (fp32_precision() if mode == "fp32" else contextlib.nullcontext()):
                        with torch.inference_mode():
                            full = gen(torch.from_numpy(mel600).to(synth_h.device)[None])[0]
                            full = full.cpu().numpy()
                        t0 = time.perf_counter()
                        chunks = list(stream_vocode(gen, mel600, chunk_frames=64))
                        times[f"stream_vocode_600_{mode}"] = [time.perf_counter() - t0]
                    streamed = np.concatenate(chunks)
                    if streamed.shape[0] != 600 * 256:
                        fails.append(f"stream_vocode gave {streamed.shape[0]} samples")
                    stream_err[mode] = float(np.abs(streamed[ctx:] - full[ctx : 600 * 256]).max())
                # clause streaming with Griffin-Lim (K3), in process
                gl_clauses = [len(w) for w in stream_text(synth_g, SERVE_STREAM_TEXT)]
                # evaluation of phase 6's checkpoint on its cache, with HiFi-GAN V1
                ds = SpevDataset(None, cache_dir=os.path.join(tmp, "cache"))
                best = os.path.join(tmp, "checkpoints", "smoke", "best.pt")
                t0 = time.perf_counter()
                res = evaluate_checkpoint(best, ds, vocoder=Vocoder(hdir))
                eval_s = time.perf_counter() - t0
                out_json = os.path.join(tmp, "eval_val.json")
                t0 = time.perf_counter()
                rc = eval_cli.main(["--checkpoint", best, "--data_dir", os.path.join(tmp, "none"),
                                    "--cache_dir", os.path.join(tmp, "cache"), "--split", "val",
                                    "--vocoder", hdir, "--json", out_json])
                cli_s = time.perf_counter() - t0
                torch.cuda.synchronize()
                launches = {"lr_fused": lr_fused.launches, "fused_log_mel": fused_log_mel.launches,
                            "overlap_add": overlap_add.launches}
        finally:
            Synthesizer._acoustic, voc_mod.mel_to_audio = orig_ac, orig_gl
            eval_mod.apply_advanced = orig_adv
        # the bar holds in fp32; as served, cuDNN's TF32 convolutions take
        # other algorithms at the two-phase shapes, which is printed
        for mode, (mel_err, wav_err) in errs.items():
            bar = " (<= 1e-5)" if mode == "fp32" else ""
            log(f"phase 14: two-phase against fused (8 texts at batch 4), {mode}: lengths "
                f"equal, mel max |d| {mel_err:.3e}{bar}, wav max |d| {wav_err:.3e}"
                f"{' (<= 1e-4)' if bar else ''}")
        if not (errs["fp32"][0] <= 1e-5 and errs["fp32"][1] <= 1e-4
                and math.isfinite(errs["served"][0])):
            fails.append(f"two-phase rows differ from fused rows: {errs}")
        log(f"phase 14: wall per batch of 4 as served: fused {_ms(times['two_phase=False'])}, "
            f"two-phase {_ms(times['two_phase=True'])}")
        for mode, err in stream_err.items():
            log(f"phase 14: stream_vocode of a 600-frame mel in {len(chunks)} chunks of 64 "
                f"(context {ctx // 256} frames each side), {mode}, in "
                f"{times[f'stream_vocode_600_{mode}'][0] * 1e3:.1f} ms: max |d| against one "
                f"full pass past the context {err:.3e} (<= 1e-4), waveform mean |x| "
                f"{float(np.abs(full).mean()):.3e}")
            if not err <= 1e-4:
                fails.append(f"the streamed waveform differs from the full pass ({mode})")
        agg = res["aggregate"]
        with open(out_json) as f:
            cli_agg = json.load(f)["aggregate"]
        log(f"phase 14: evaluate_checkpoint(best.pt, 96 utterances, HiFi-GAN V1) in {eval_s:.2f} "
            f"s = {eval_s / max(agg['n_utterances'], 1) * 1e3:.1f} ms per utterance: "
            + json.dumps(agg))
        log(f"phase 14: cli.evaluate --split val --vocoder in {cli_s:.2f} s (load included): "
            + json.dumps(cli_agg))
        if rc != 0 or agg["n_utterances"] != 96 or cli_agg["n_utterances"] != 4:
            fails.append(f"evaluation: rc {rc}, {agg['n_utterances']} / "
                         f"{cli_agg['n_utterances']} utterances")
        for v in res["per_utterance"].values():
            if not all(math.isfinite(v[k]) for k in ("mcd_db", "dur_err_pct", "vocoded_mcd_db",
                                                     "f0_rmse_hz")):
                fails.append(f"a non-finite score: {v}")
        vocoded = agg["n_utterances"] + cli_agg["n_utterances"]
        if not (launches["lr_fused"] == counts["acoustic_passes"] + counts["eval_forwards"]
                and launches["fused_log_mel"] == vocoded
                and launches["overlap_add"] == 33 * counts["griffin_lim_vocodings"]
                and counts["griffin_lim_vocodings"] == len(gl_clauses) > 1):
            fails.append(f"in-process launches {launches} for {counts}, {vocoded} "
                         f"vocoded utterances, {len(gl_clauses)} streamed clauses")
        log(f"phase 14: in-process path counts {json.dumps(counts)}, {vocoded} utterances "
            f"re-extracted; launches {json.dumps(launches)}")

        # one coalesced batch on the card against the same batch on the CPU
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        reqs = [("Good morning.", {"pitch_scale": 1.2}), ("Why?", {"breathiness": 0.4}),
                (ADV_SHORT, {"duration_scale": 1.1})]
        outs = {}
        try:
            for dev, s in (("cuda", synth_h),
                           ("cpu", Synthesizer(spev, hifigan_dir=hdir, g2p_backend="rules",
                                               device="cpu"))):
                b = CoalescingBatcher(s, max_batch=4, window_ms=500.0)
                outs[dev] = [None] * 3

                def submit(i, b=b, dev=dev):
                    outs[dev][i] = b.submit(reqs[i][0], timeout=300, **reqs[i][1])

                ts = [threading.Thread(target=submit, args=(i,)) for i in range(3)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=600)
                if b.stats()["sizes"] != {"3": 1}:
                    raise AssertionError(f"the {dev} batcher formed {b.stats()}")
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        maes = []
        for (wc, _), (wg, _) in zip(outs["cpu"], outs["cuda"]):
            if wc.shape != wg.shape:
                raise AssertionError(f"coalesced row lengths {wg.shape} / {wc.shape}")
            maes.append(float(np.abs(wc - wg).mean()))
        log(f"phase 14: one coalesced batch of 3 (padded to 4), card vs CPU (TF32 off): equal "
            f"lengths, wav MAE {max(maes):.3e} (<= 1e-4)")
        # the same coalesced rows against batches of one on the card, in fp32
        lsb32, flt32 = 0, 0.0
        with fp32_precision():
            for (text, kw), (wav_c, _) in zip(reqs, outs["cuda"]):
                (wav_1, _), = synth_h.synthesize_many([text], **{
                    k: np.asarray([v], np.float32) for k, v in {**_DEFAULTS, **kw}.items()})
                a, b = (np.frombuffer(_wav_bytes(w)[44:], "<i2").astype(np.int32)
                        for w in (wav_c, wav_1))
                if a.shape != b.shape:
                    fails.append(f"coalesced row {text!r}: {a.shape} against {b.shape} alone")
                    continue
                lsb32 = max(lsb32, int(np.abs(a - b).max()))
                flt32 = max(flt32, float(np.abs(wav_c - wav_1).max()))
        log(f"phase 14: that batch's rows against batches of one on the card, fp32: PCM max "
            f"|d| {lsb32} LSB (<= 1), float max |d| {flt32:.3e} (<= 5e-4)")
        if not (lsb32 <= 1 and flt32 <= 5e-4):
            fails.append("a coalesced row differs from its batch of one (fp32)")
        if not max(maes) <= 1e-4:
            fails.append("the coalesced batch on the card disagrees with the CPU")

        # the servers, driven over HTTP
        (proc_h, base_h, log_h), (proc_g, base_g, log_g) = servers
        t0 = time.perf_counter()
        _healthz(base_h, proc_h, log_h, wait_s=300)
        _healthz(base_g, proc_g, log_g, wait_s=300)
        log(f"phase 14: both servers answer /healthz ({time.perf_counter() - t0:.1f} s after "
            "the in-process work)")
        # warm-up, outside the counted run: the shapes of every request below
        # (cuDNN plans), and two handler threads at once (each thread takes
        # its own cuDNN and cuBLAS handles); the Griffin-Lim server's first
        # request after its start is timed as the cold start
        for c in (16, 4, 1):
            _fire(base_h, _serve_payloads(10 + c), c)
        _streams(base_h, 2, pitch0=0.8)
        _post(base_h, "/synthesize", {"text": ADV_TEXT, **ADV_CONTROLS})
        cold_gl = _post(base_g, "/synthesize", {"text": TEXTS[1]})
        _post(base_g, "/synthesize_stream", {"text": SERVE_STREAM_TEXT}, stream=True)
        h0, g0 = _healthz(base_h), _healthz(base_g)

        runs, batches = {}, {}  # concurrency → (results, seconds); its payloads are level c_i
        for c in CONCURRENCY:
            before = _healthz(base_h)
            runs[c] = _fire(base_h, _serve_payloads(CONCURRENCY.index(c)), c)
            batches[c] = _batch_delta(before, _healthz(base_h))
        hits_before = _healthz(base_h)["response_cache"]["hits"]
        repeat, _ = _fire(base_h, _serve_payloads(CONCURRENCY.index(16)), 16)
        alone = _streams(base_h, 1, pitch0=1.2)
        streams = _streams(base_h, 2, pitch0=1.0)
        adv = _post(base_h, "/synthesize", {"text": ADV_TEXT, "emotion": "excited",
                                            "pitch_scale": 1.1, "duration_scale": 1.0,
                                            "energy_scale": 1.0, "brightness": 0.2,
                                            **ADV_CONTROLS})
        gl_req = _post(base_g, "/synthesize", {"text": TEXTS[1], "breathiness": 0.2})
        gl_stream = _post(base_g, "/synthesize_stream", {"text": SERVE_STREAM_TEXT}, stream=True)
        h1, g1 = _healthz(base_h), _healthz(base_g)
    finally:
        for proc, _, _ in servers:
            proc.terminate()
        for proc, _, _ in servers:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    # every response a 200 with a valid WAV; the cache's repeats the same bytes
    for c, (res_c, _) in runs.items():
        for p, r in zip(_serve_payloads(CONCURRENCY.index(c)), res_c):
            _wav_pcm(r[0], r[1], f"/synthesize at concurrency {c}: {p}")
    for first, again in zip(runs[16][0], repeat):
        if again[0] != 200 or again[1] != first[1]:
            raise AssertionError("a cached repeat is not the same bytes")
    hits = h1["response_cache"]["hits"] - hits_before
    stream_pcm = [_stream_pcm(s[0], s[1], "stream") for s in alone + streams]
    _wav_pcm(adv[0], adv[1], "the advanced request", whole_hops=False)
    _wav_pcm(gl_req[0], gl_req[1], "the Griffin-Lim request")
    gl_pcm = _stream_pcm(gl_stream[0], gl_stream[1], "the Griffin-Lim stream")
    if hits != 16:
        fails.append(f"/healthz counts {hits} cache hits for 16 repeats")
    # each coalesced response against synthesize_many([text]) in this process
    lsb, flt = 0, 0.0
    for p, r in zip(_serve_payloads(CONCURRENCY.index(16)), runs[16][0]):
        kw = {**_DEFAULTS, **{k: v for k, v in p.items() if k != "text"}}
        (wav, _), = synth_h.synthesize_many([p["text"]], **{k: np.asarray([v], np.float32)
                                                             for k, v in kw.items()})
        ref = np.frombuffer(_wav_bytes(wav)[44:], "<i2").astype(np.int32)
        got = np.frombuffer(r[1][44:], "<i2").astype(np.int32)
        if got.shape != ref.shape:
            fails.append(f"{p}: {got.shape} samples against {ref.shape} in process")
            continue
        lsb = max(lsb, int(np.abs(got - ref).max()))
        flt = max(flt, float(np.abs(got / 32767.0 - np.clip(wav, -1, 1)).max()))
    d_h, d_g = _launch_delta(h0, h1), _launch_delta(g0, g1)
    served_batches = sum(sum(b.values()) for b in batches.values())
    n_clauses = len(split_clauses(SERVE_STREAM_TEXT))
    log(f"phase 14: {card}")
    for c, (res_c, total) in runs.items():
        log(f"phase 14: 16 /synthesize at concurrency {c}: request wall "
            f"{_ms([r[3] for r in res_c])}, all 16 in {total * 1e3:.1f} ms; batches formed "
            f"(requests: count) {json.dumps(batches[c])}")
    log(f"phase 14: 16 cached repeats at concurrency 16: request wall "
        f"{_ms([r[3] for r in repeat])}, byte-identical; /healthz hits +{hits}")
    for i, s in enumerate(alone + streams):
        log(f"phase 14: stream {'alone' if i == 0 else f'{i} of 2 at once'} ({n_clauses} "
            f"clauses, {len(stream_pcm[i])} samples): first PCM byte after {s[2] * 1e3:.1f} "
            f"ms, end after {s[3] * 1e3:.1f} ms")
    log(f"phase 14: advanced request (every field) {adv[3] * 1e3:.1f} ms, "
        f"{(len(adv[1]) - 44) // 2} samples; Griffin-Lim server: first request after its start "
        f"{cold_gl[3] * 1e3:.1f} ms, then /synthesize {gl_req[3] * 1e3:.1f} ms, stream first "
        f"byte {gl_stream[2] * 1e3:.1f} ms, end {gl_stream[3] * 1e3:.1f} ms ({len(gl_pcm)} "
        "samples)")
    log(f"phase 14: coalesced responses (cuDNN TF32 on, as served) against "
        f"synthesize_many([text]) in process: PCM max |d| {lsb} LSB, float max |d| {flt:.3e} "
        f"(<= 5e-4; the 1-LSB bar is held in fp32 above)")
    log(f"phase 14: server launches over the counted traffic (/healthz before and after): "
        f"HiFi-GAN server {json.dumps(d_h)} for {served_batches} coalesced batches, "
        f"{3 * n_clauses} streamed clauses and one advanced request; Griffin-Lim server "
        f"{json.dumps(d_g)} for one request and {n_clauses} streamed clauses")
    if not flt <= 5e-4:
        fails.append("a coalesced response differs from the in-process synthesis")
    if not (d_h["lr_fused"] >= served_batches + 3 * n_clauses + 1 and d_h["overlap_add"] == 0
            and d_g["lr_fused"] >= 1 + n_clauses and d_g["overlap_add"] == 33 * (1 + n_clauses)
            and d_h["fused_log_mel"] == d_g["fused_log_mel"] == 0):
        fails.append("the servers' kernel launches do not match their traffic")
    if fails:
        raise AssertionError("phase 14: " + "; ".join(fails))
    path_launches = {
        "serving_stack": {"lr_fused": counts["acoustic_passes"] + d_h["lr_fused"]
                          + d_g["lr_fused"],
                          "overlap_add": launches["overlap_add"] + d_g["overlap_add"]},
        "evaluation": {"lr_fused": counts["eval_forwards"],
                       "fused_log_mel": launches["fused_log_mel"]},
    }
    return path_launches, kept, {"times": times, "eval_s_per_utt": eval_s / 96}


# phase 15: vocoder training at full width (HiFi-GAN V1, MPD 2-11, 3 MSD scales)
VOC_ARGS = ["--config", "v1", "--periods", "2,3,5,7,11", "--scales", "3", "--batch_size", "8",
            "--segment_frames", "32", "--log_every", "1"]


@contextlib.contextmanager
def _vocoder_records():
    """While active: the batcher's wav reads and `FeatureExtractor.mel`
    calls, GTA's time, utterances and acoustic forwards (one K1 each), each
    state and generator file written (seconds, MiB, step), each training
    step's wall time, and each warmup ``d_step``'s generator checked
    bit-equal to the generator it started from."""
    import spev_tpu_torch.utils.native as native
    from spev_tpu_torch.data.dataset import FeatureExtractor
    from spev_tpu_torch.infer import gta as gta_mod
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2
    from spev_tpu_torch.train import vocoder_trainer as vt

    rec = {"reads": [], "mel_calls": 0, "gta": [], "forwards": 0, "state_saves": [],
           "gen_saves": [], "step_s": [], "warmup_equal": []}
    saved = [(native, "read_wav"), (FeatureExtractor, "mel"), (gta_mod, "compute_gta_mels"),
             (FastSpeech2, "forward"), (vt, "save_state"), (vt, "save_generator"),
             (vt.VocoderTrainStep, "__call__"), (vt.VocoderTrainStep, "d_step")]
    orig = {k: getattr(*k) for k in saved}

    def read_wav(path):
        rec["reads"].append(path)
        return orig[(native, "read_wav")](path)

    def mel(self, y):
        rec["mel_calls"] += 1
        return orig[(FeatureExtractor, "mel")](self, y)

    def compute_gta_mels(checkpoint, ds, **kw):
        t0 = time.perf_counter()
        out = orig[(gta_mod, "compute_gta_mels")](checkpoint, ds, **kw)
        rec["gta"].append((time.perf_counter() - t0, len(out), len(ds)))
        return out

    def forward(self, *a, **k):
        rec["forwards"] += 1
        return orig[(FastSpeech2, "forward")](self, *a, **k)

    def timed_save(key, name):
        def fn(path, state, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig[(vt, name)](path, state, *a)
            rec[key].append((os.path.basename(path), time.perf_counter() - t0,
                             os.path.getsize(path) / 2**20, state.step))
        return fn

    def call(self, state, mel_b, wav_b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig[(vt.VocoderTrainStep, "__call__")](self, state, mel_b, wav_b)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        return out

    def d_step(self, state, mel_b, wav_b):
        before = {k: v.clone() for k, v in state.generator.state_dict().items()}
        out = orig[(vt.VocoderTrainStep, "d_step")](self, state, mel_b, wav_b)
        rec["warmup_equal"].append(all(torch.equal(v, before[k])
                                       for k, v in state.generator.state_dict().items()))
        return out

    new = [read_wav, mel, compute_gta_mels, forward, timed_save("state_saves", "save_state"),
           timed_save("gen_saves", "save_generator"), call, d_step]
    for (obj, name), fn in zip(saved, new):
        setattr(obj, name, fn)
    try:
        yield rec
    finally:
        for (obj, name), fn in orig.items():
            setattr(obj, name, fn)


def _leaky_decisions(card=None):
    """Phase 7's ReLU handling for LeakyReLU, over every ``F.leaky_relu``
    call in order: without ``card`` records each input (on the CPU); with
    ``card`` (such a record) compares each input with the recorded one
    (``"fwd_err"``, max |diff| / max |z|) and moves every element on the
    other side of zero to the recorded side (± the least positive float32,
    its derivative kept), so the CPU passes the card's slope there
    (``"flips"``)."""
    import torch.nn.functional as F

    rec = {"z": [], "fwd_err": [], "flips": 0}
    orig = F.leaky_relu

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        if card is None:
            rec["z"].append(x.detach().cpu())
            return orig(x, negative_slope)
        z = card["z"][len(rec["fwd_err"])].to(x.device)
        if z.shape != x.shape:
            raise AssertionError(f"leaky_relu call {len(rec['fwd_err'])}: {tuple(x.shape)} "
                                 f"on the CPU, {tuple(z.shape)} on the card")
        rec["fwd_err"].append(((x.detach() - z).abs().max()
                               / z.abs().max().clamp_min(1e-30)).item())
        want = z > 0
        flip = want != (x.detach() > 0)
        rec["flips"] += int(flip.sum())
        tiny = torch.finfo(x.dtype).tiny
        target = torch.where(want, torch.full_like(x, tiny), torch.full_like(x, -tiny))
        return orig(torch.where(flip, x - x.detach() + target, x), negative_slope)

    @contextlib.contextmanager
    def patched():
        F.leaky_relu = leaky_relu
        try:
            yield rec
        finally:
            F.leaky_relu = orig

    return patched()


def _gan_grads(state, step, mel, wav):
    """The split step's two passes without their updates: D's loss and
    gradients on [real; G(mel)], then G's loss and gradients against the
    same D.  Returns (d_loss, g_loss, {name: gradient on the CPU})."""
    from spev_tpu_torch.train.vocoder_trainer import step_precision

    G, D = state.generator, state.discriminators
    with step_precision(step.precision):
        with torch.no_grad():
            fake = G(mel)
        d_loss = step.d_loss(D, wav, fake)
        d_names, d_params = zip(*D.named_parameters())
        d_grads = torch.autograd.grad(d_loss, d_params)
        g_loss, _ = step.g_loss_from_fake(G(mel), D, wav)
        g_names, g_params = zip(*G.named_parameters())
        g_grads = torch.autograd.grad(g_loss, g_params)
    grads = {f"D.{n}": g.cpu() for n, g in zip(d_names, d_grads)}
    grads.update({f"G.{n}": g.cpu() for n, g in zip(g_names, g_grads)})
    return d_loss.item(), g_loss.item(), grads


def _gan_step_card_vs_cpu(hdir, batch):
    """One ``split_unfolded`` step's losses and gradients at V1 width with
    every sub-discriminator, B=1, 16 frames, ``--precision high``: the same
    weights (phase 4's HiFi-GAN V1 generator, seeded discriminators) and
    batch on the card and on the CPU."""
    from spev_tpu_torch.models.hifigan import HiFiGANGenerator
    from spev_tpu_torch.models.hifigan_disc import Discriminators
    from spev_tpu_torch.train import vocoder_trainer as vt

    gen = HiFiGANGenerator.from_pretrained(hdir)
    disc = Discriminators.random_init(seed=15)
    step = vt.make_vocoder_train_step(gen.cfg, precision="high")
    out = {}
    card = None
    for dev in ("cuda", "cpu"):
        st = vt.init_vocoder_train_state(gen.cfg, gen_state_dict=gen.state_dict(), device=dev)
        st.discriminators.load_state_dict(disc.state_dict())
        mel, wav = (torch.from_numpy(a).to(next(st.generator.parameters()).device)
                    for a in batch)
        t0 = time.perf_counter()
        with _leaky_decisions(card) as rec:
            out[dev] = _gan_grads(st, step, mel, wav)
        out[dev + "_s"] = time.perf_counter() - t0
        card = card or rec
        del st
    (dg, gg, grads_g), (dc, gc, grads_c) = out["cuda"], out["cpu"]
    errs = sorted((((grads_c[n] - grads_g[n]).abs().max()
                    / grads_g[n].abs().max().clamp_min(1e-30)).item(), n) for n in grads_g)[::-1]
    over = [n for e, n in errs if e > 1e-4]
    rel_d, rel_g = abs(dg - dc) / abs(dc), abs(gg - gc) / abs(gc)
    fwd = max(rec["fwd_err"])
    log(f"phase 15: one split_unfolded step card vs CPU (V1, MPD 2-11 + 3 MSD, B=1, 16 frames, "
        f"--precision high: TF32 off; CPU {out['cpu_s']:.1f} s): LeakyReLU inputs within "
        f"{fwd:.2e} of their max |z| over {len(rec['fwd_err'])} calls, {rec['flips']} on the "
        f"other side of zero (the CPU taking the card's side); d_loss {dg:.6f} vs {dc:.6f} "
        f"(rel {rel_d:.2e}), g_loss {gg:.6f} vs {gc:.6f} (rel {rel_g:.2e}); gradients over 1e-4 "
        f"of their max |g|: {len(over)} of {len(errs)}; worst "
        + ", ".join(f"{n} {e:.2e}" for e, n in errs[:4]))
    if over or not (rel_d < 1e-5 and rel_g < 1e-5 and fwd < 1e-5
                    and len(rec["fwd_err"]) == len(card["z"]) > 0):
        raise AssertionError(f"the GAN step disagrees between the card and the CPU: {over}")
    return {"rel_d": rel_d, "rel_g": rel_g, "worst_grad": errs[0][0], "flips": rec["flips"]}


def _time_gan_steps(state, batch, cfg):
    """Ten steps on one fixed batch per configuration, in turns on one state
    (the time does not depend on the weights): the mean of steps 3-10, then
    one profiled step."""
    from spev_tpu_torch.train import vocoder_trainer as vt

    mel, wav = batch
    confs = [("fused_folded, default, fp32 D", dict(fused=True)),
             ("split_unfolded, default, fp32 D", dict(fused=False)),
             ("fused_folded, high, fp32 D", dict(fused=True, precision="high"))]
    out = {}
    for name, kw in confs:
        step = vt.make_vocoder_train_step(cfg, **{"precision": "default", **kw})
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, mel, wav)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if m["skipped"]:
                raise AssertionError(f"phase 15: a {name} step skipped: {m}")
        mean = sum(times[2:]) / len(times[2:])
        log(f"phase 15: fixed batch B=8, 8192 samples, {name}: step {mean * 1e3:.2f} ms (mean "
            f"of steps 3-10; first {times[0] * 1e3:.1f} ms), {8 * 8192 / 22050 / mean:.2f} s of "
            f"audio per second; losses " + json.dumps({k: round(v, 4) for k, v in m.items()}))
        _profile_one(f"phase 15 profile: one {name} step",
                     lambda: step(state, mel, wav))
        out[name] = mean
    return out


def _write_reference_cache(root, seed=15):
    """16 utterances in the reference's format: ``u_{i:05d}.pt`` torch
    pickles (phs, durs, a (T, 80) mel tensor, per-phoneme numpy arrays) and
    ``metadata.json`` with files, stats and vocab."""
    from spev_tpu_torch.text.g2p import G2P
    from spev_tpu_torch.text.vocab import SPECIALS

    g2p = G2P("rules")
    phones = sorted({p for t in TEXTS for p in g2p.phonemes(t)})
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    files = []
    for i in range(16):
        n = int(rng.integers(20, 60))
        durs = rng.integers(1, 8, n).tolist()
        T = int(sum(durs))
        mel = np.clip(rng.uniform(-8.0, -2.0, 80)[None] + rng.standard_normal((T, 80)), -10, 2)
        u = {"phs": [phones[k] for k in rng.integers(0, len(phones), n)], "durs": durs,
             "mel": torch.from_numpy(mel.astype(np.float32))}
        for k, (lo, hi) in {"pitch": (-2, 2), "energy": (-2, 2), "breath": (0, 0.8),
                            "rough": (0, 1.5), "bright": (-2, 2)}.items():
            u[k] = rng.uniform(lo, hi, n).astype(np.float32)
        files.append(os.path.join(root, f"u_{i:05d}.pt"))
        torch.save(u, files[-1])
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({"files": files, "vocab": sorted(set(phones) | set(SPECIALS)),
                   "stats": {"p_mean": 5.0, "p_std": 0.3, "e_mean": -3.0, "e_std": 1.0,
                             "c_mean": 7.5, "c_std": 0.5}}, f)


def phase15_vocoder_training(tmp, pt, hdir):
    """Vocoder training through ``cli.vocoder`` at full width on phase 8's
    corpus, a resume, GTA fine-tuning from phase 8's checkpoint, the GAN
    step timed and held against the CPU, a trained generator served, and a
    reference cache imported and trained on."""
    from spev_tpu_torch.cli import convert as convert_cli
    from spev_tpu_torch.cli import train as train_cli
    from spev_tpu_torch.cli import vocoder as voc_cli
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.infer.vocoder import Vocoder
    from spev_tpu_torch.models.hifigan import HiFiGANConfig
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.train import vocoder_trainer as vt
    from spev_tpu_torch.utils.wavio import read_wav, resample_linear

    corpus, tg = os.path.join(tmp, "corpus"), os.path.join(tmp, "textgrids")
    cache = os.path.join(tmp, "cache_built")
    acoustic = os.path.join(tmp, "checkpoints", "extract", "last.pt")
    work = os.path.join(tmp, "vocoder")
    os.makedirs(work)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seg = 33 * 256  # one 32-frame crop and a hop
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with _keep_kernel_inputs() as kept, _vocoder_records() as rec:
            # 1. six steps at the CLI's defaults (fused_folded, --precision default)
            fused_log_mel.launches = lr_fused.launches = 0
            t0 = time.perf_counter()
            rc = voc_cli.main(["--data_dir", corpus, "--name", "v1", "--steps", "6",
                               "--save_every", "3", *VOC_ARGS])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            run_launches = {"fused_log_mel": fused_log_mel.launches,
                            "lr_fused": lr_fused.launches}
            if rc != 0:
                raise AssertionError(f"cli.vocoder exited with {rc}")
            reads, mel_calls = list(rec["reads"]), rec["mel_calls"]
            run_steps = list(rec["step_s"])
            saves = [list(rec["state_saves"]), list(rec["gen_saves"])]
            # 2. an exact resume
            rc = voc_cli.main(["--data_dir", corpus, "--name", "v1_resume", "--steps", "2",
                               "--save_every", "2", "--resume_state",
                               "checkpoints/v1/state_latest.spev", *VOC_ARGS])
            resumed_step = rec["state_saves"][-1][3]
            if rc != 0 or resumed_step != 8:
                raise AssertionError(f"the resumed run exited with {rc} at step {resumed_step} "
                                     "(expected 8)")
            # 3. GTA fine-tuning from the trained generator, D warmed up first
            fused_log_mel.launches = lr_fused.launches = 0
            rec["forwards"] = 0
            rec["warmup_equal"].clear()
            t0 = time.perf_counter()
            rc = voc_cli.main(["--data_dir", corpus, "--textgrid_dir", tg, "--cache_dir", cache,
                               "--gta_checkpoint", acoustic, "--name", "v1_gta",
                               "--finetune_from", "checkpoints/v1/gen_00000006.spev",
                               "--disc_warmup", "2", "--steps", "4", "--save_every", "4",
                               *VOC_ARGS])
            torch.cuda.synchronize()
            gta_run_s = time.perf_counter() - t0
            gta_launches = {"fused_log_mel": fused_log_mel.launches,
                            "lr_fused": lr_fused.launches}
            gta_forwards = rec["forwards"]
    finally:
        os.chdir(cwd)
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != tf32:
        raise AssertionError("cli.vocoder left the process's TF32 settings changed")
    ck = os.path.join(work, "checkpoints")
    want = ["gen_00000003.spev", "gen_00000006.spev", "state_latest.spev"]
    if rc != 0 or sorted(os.listdir(os.path.join(ck, "v1"))) != want:
        raise AssertionError(f"cli.vocoder wrote {sorted(os.listdir(os.path.join(ck, 'v1')))}")

    # K2 once per distinct file the batcher loaded that is long enough for a crop
    loaded = set(reads)

    def length(path):
        y, sr = read_wav(path)
        return len(y if sr == 22050 else resample_linear(y, sr, 22050))

    long_enough = {p for p in loaded if length(p) >= seg}
    if not (len(reads) == len(loaded) and run_launches["fused_log_mel"] == mel_calls
            == len(long_enough) > 0 and run_launches["lr_fused"] == 0):
        raise AssertionError(f"launches {run_launches} for {len(reads)} reads of {len(loaded)} "
                             f"files, {len(long_enough)} long enough, {mel_calls} mel calls")
    gta_s, gta_utts, gta_ds = rec["gta"][-1]
    if not (gta_launches["lr_fused"] == gta_forwards > 0 and gta_launches["fused_log_mel"] == 0
            and rec["warmup_equal"] == [True, True] and gta_utts == gta_ds > 0):
        raise AssertionError(f"GTA run: launches {gta_launches} for {gta_forwards} forwards, "
                             f"warmup generator bit-equal {rec['warmup_equal']}, {gta_utts} of "
                             f"{gta_ds} utterances")
    state_save, gen_save = saves[0][-1], saves[1][-1]
    log(f"phase 15: cli.vocoder --config v1 (MPD 2,3,5,7,11, 3 MSD scales, B=8, 32 frames, "
        f"fused_folded, --precision default), 6 steps in {run_s:.2f} s (load and builds "
        f"included); step wall " + ", ".join(f"{s * 1e3:.1f}" for s in run_steps) + " ms; "
        f"{len(loaded)} files read, {len(long_enough)} log-mels (K2 launches "
        f"{run_launches['fused_log_mel']}); {gen_save[0]} {gen_save[2]:.1f} MiB written in "
        f"{gen_save[1]:.2f} s; state_latest.spev {state_save[2]:.1f} MiB written in "
        f"{state_save[1]:.2f} s (at steps " + ", ".join(str(s[3]) for s in saves[0]) + ")")
    log(f"phase 15: --resume_state state_latest.spev, 2 more steps: saved at step "
        f"{resumed_step}")
    log(f"phase 15: GTA run (--gta_checkpoint {os.path.basename(acoustic)}, phase 8's cache, "
        f"--finetune_from gen_00000006.spev, --disc_warmup 2, 4 steps) in {gta_run_s:.2f} s: "
        f"compute_gta_mels {gta_s:.2f} s for {gta_utts} utterances ({1e3 * gta_s / gta_utts:.1f} "
        f"ms per utterance), {gta_forwards} teacher-forced batches; launches "
        f"{json.dumps(gta_launches)}; generator bit-equal after each warmup step")

    # the GAN step on one fixed batch, in four configurations
    cfg = HiFiGANConfig()
    state = vt.init_vocoder_train_state(cfg, seed=15)
    dev = next(state.generator.parameters()).device
    make = voc_cli.make_crop_batcher(sorted(long_enough), AudioConfig(), 32, 8, seed=15)
    batch = tuple(torch.from_numpy(a).to(dev) for a in make())
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminators.parameters())
    log(f"phase 15: parameters: generator {n_g:,}, discriminators {n_d:,} (MPD "
        f"{sum(p.numel() for p in state.discriminators.mpd.parameters()):,}, MSD "
        f"{sum(p.numel() for p in state.discriminators.msd.parameters()):,})")
    step_s = _time_gan_steps(state, batch, cfg)
    del state
    torch.cuda.empty_cache()

    # card against CPU: B=1, 16 frames
    small = voc_cli.make_crop_batcher(sorted(long_enough), AudioConfig(), 16, 1, seed=16)()
    agree = _gan_step_card_vs_cpu(hdir, small)

    # the trained generator serves phase 4's mel
    gen = vt.load_generator(os.path.join(ck, "v1", "gen_00000006.spev"), cfg)
    voc = Vocoder(generator=gen)
    _, mel = Synthesizer(pt, hifigan_dir=None, g2p_backend="rules").synthesize(TEXTS[1])
    wav = voc.infer(mel)
    if not (np.isfinite(wav).all() and len(wav) == mel.shape[0] * 256):
        raise AssertionError(f"the trained generator gave {wav.shape} for {mel.shape[0]} frames")
    log(f"phase 15: gen_00000006.spev → HiFiGANGenerator → Vocoder: phase 4's {mel.shape[0]}-"
        f"frame mel → {len(wav)} finite samples (max |y| {np.abs(wav).max():.4f})")

    # a reference-format cache imported and trained on
    ref = os.path.join(tmp, "cache_reference")
    _write_reference_cache(ref)
    imported = os.path.join(tmp, "cache_imported")
    if convert_cli.main(["cache", ref, imported]) != 0:
        raise AssertionError("cli.convert cache failed")
    os.chdir(tmp)
    try:
        lr_fused.launches = lr_fused_bwd.launches = 0
        rc = train_cli.main(["--cache_dir", imported, "--name", "imported", "--epochs", "1",
                             "--warmup_epochs", "0", "--batch_size", "8", "--warmup_steps", "20"])
    finally:
        os.chdir(cwd)
    with open(os.path.join(tmp, "logs", "imported", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if rc != 0 or not (rows and all(math.isfinite(r["train_loss"]) for r in rows)
                       and lr_fused_bwd.launches > 0):
        raise AssertionError(f"training on the imported cache: rc {rc}, rows {rows}")
    log(f"phase 15: cli.convert cache (16 reference-format u_*.pt) → cli.train --cache_dir, 1 "
        f"epoch: train_loss {rows[-1]['train_loss']:.4f}; K1 {lr_fused.launches}, K1b "
        f"{lr_fused_bwd.launches}")
    launches = {"lr_fused": gta_launches["lr_fused"],
                "fused_log_mel": run_launches["fused_log_mel"]}
    return launches, kept, {"step_s": step_s, "agree": agree, "gta_s_per_utt": gta_s / gta_utts,
                            "state_save": state_save}


@torch.inference_mode()
def phase15b_vocoder_inputs(kept):
    """K1 on GTA's teacher-forced inputs and K2 on the batcher's signals,
    against their plain versions, after the counts were read."""
    k1 = []
    for args, _ in kept["lr_fused"].values():
        case = {**_k1_case(*args), "main_path": "vocoder_training"}
        k1.append(case)
        log("phase 15b: K1 bit-equal to plain on GTA's inputs", json.dumps(case))
    if not k1:
        raise AssertionError("GTA called no K1")
    return k1, phase8b_extraction_inputs(kept, "phase 15b", "vocoder_training")


# phase 16: the formant corpus, data-parallel training through the launcher
# (NCCL at world size 1, the gradient all-reduce on the path), ten steps'
# drift card against CPU, and cli.vocoder --mesh
FORMANT_UTTS = 160
# at 200 warmup steps the val MCD first halves at epoch 14 in most runs;
# shorter warmups stall above half (PERF.md, section 6)
FORMANT_EPOCHS = 16
FORMANT_WARMUP = 200
DRIFT_STEPS = 10
# the last epoch's val MCD below this share of epoch 0's (the JAX package's
# hidden-256 run fell from 149.5 to 96.8 dB in 5 epochs,
# docs/demo/q256_train_log.jsonl)
MCD_BAR = 0.5
# phase 16b's bars (`formant_quality`): the MCD bar above, and the JAX
# package's trend bar (tests/test_convergence.py) on the val MCD, the
# duration error and the val mel loss
FORMANT_BARS = ("mcd_ratio", "trend_mcd", "trend_durerr", "trend_val")
# those that gate the smoke: the ones that held in every card run.  The MCD
# bar broke in 2 of 15 (87.38 and 71.01 dB at epoch 16, against 137.01) and
# is printed; the trends held in all nine of tools/torch_formant_spread.py's
# runs (ROADMAP.md, section 4, F6)
FORMANT_GATING_BARS = ("trend_mcd", "trend_durerr", "trend_val")
_TREND_BARS = {"trend_mcd": "val_mcd_db", "trend_durerr": "val_dur_err_pct",
               "trend_val": "val_mel"}


def _launch(module, args, cwd, log_path, timeout=900):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    module args`` as a user launches it; returns (exit code, output)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "1", "-m", module, *args]
    with open(log_path, "w") as out:
        rc = subprocess.run(argv, cwd=cwd, env=env, stdout=out, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    with open(log_path) as f:
        return rc, f.read()


def formant_quality(rows):
    """Phase 16b's readings from ``cli.train``'s metrics rows: epoch 0's and
    the last epoch's val MCD and their ratio, the medians of the first and
    the last third of the epochs for each of `_TREND_BARS`' metrics, and the
    names of the `FORMANT_BARS` broken (a NaN breaks its bar)."""
    k = len(rows) // 3

    def med(key, part):
        return float(np.median([r[key] for r in part]))

    trend = {key: [med(key, rows[:k]), med(key, rows[-k:])] for key in _TREND_BARS.values()}
    mcd0, mcd1 = rows[0]["val_mcd_db"], rows[-1]["val_mcd_db"]
    broken = [] if mcd1 < MCD_BAR * mcd0 else ["mcd_ratio"]
    broken += [bar for bar, key in _TREND_BARS.items() if not trend[key][1] < trend[key][0]]
    return {"mcd0": mcd0, "mcd_last": mcd1, "mcd_ratio": mcd1 / mcd0, "trend": trend,
            "broken": broken,
            "val_mcd_db_by_epoch": [round(r["val_mcd_db"], 2) for r in rows],
            "val_dur_err_pct_by_epoch": [round(r["val_dur_err_pct"], 2) for r in rows],
            "val_mel_by_epoch": [round(r["val_mel"], 4) for r in rows]}


def _formant_train_args(corpus, tg, cache):
    """``cli.train``'s arguments for phase 16b (its checkpoints land in
    ``checkpoints/formant`` under the working directory)."""
    return ["--data_dir", corpus, "--textgrid_dir", tg, "--cache_dir", cache, "--name",
            "formant", "--epochs", str(FORMANT_EPOCHS), "--batch_size", "16", "--lr", "1e-3",
            "--warmup_steps", str(FORMANT_WARMUP), "--warmup_epochs", "2", "--save_every", "10"]


def _drift(cache, kept_all):
    """``DRIFT_STEPS`` train steps from one init on the same batches of the
    formant cache, on the card and on the CPU (fp32, TF32 off, dropout off,
    lr 1e-3 from the first step): per step the loss's relative gap, the
    largest parameter gap over its tensor's max |p|, the gap's norm over the
    parameters' norm, the share of parameters more than 1e-3·lr apart, the
    ReLU inputs on the other side of zero and the card step's wall time.
    Then the card's step on the last batch timed and profiled.  The card
    steps' K1/K1b inputs go to ``kept_all``."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    ds = SpevDataset(None, cache_dir=cache)
    vocab = Vocab(ds.vocab)
    batcher = BucketBatcher(ds, vocab, batch_size=16)
    batches = list(itertools.islice((b for e in range(DRIFT_STEPS) for b in batcher.epoch(e)),
                                    DRIFT_STEPS))
    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=0.0, vp_dropout=0.0),
                     train=TrainConfig(warmup_steps=1, learning_rate=1e-3,
                                       matmul_precision="high"))
    tmp = os.path.dirname(cache)
    tg, tc = (Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(tmp, "p16c"),
                      log_dir=os.path.join(tmp, "p16c"), device=d) for d in ("cuda", "cpu"))
    rows = []
    for i, b in enumerate(batches):
        with _keep_kernel_inputs() as kept, _relu_decisions(tg.model) as rg:
            t0 = time.perf_counter()
            mg = tg.train_step(tg.to_device(b))  # ends on a host read
            card_ms = (time.perf_counter() - t0) * 1e3
        for k, v in kept.items():
            for key, val in v.items():
                kept_all[k].setdefault(key, val)
        with _relu_decisions(tc.model) as rc:
            mc = tc.train_step(tc.to_device(b))
        flips = sum(int(((rg["z"][n] > 0) != (rc["z"][n] > 0)).sum()) for n in rg["z"])
        pairs = [(n, pg.detach().cpu(), pc.detach())
                 for (n, pg), pc in zip(tg.model.named_parameters(), tc.model.parameters())]
        gaps = sorted((((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item(), n)
                      for n, a, c in pairs)
        diff2 = sum(float(((a - c).double() ** 2).sum()) for _, a, c in pairs)
        norm2 = sum(float((c.double() ** 2).sum()) for _, _, c in pairs)
        apart = sum(int(((a - c).abs() > 1e-3 * cfg.train.learning_rate).sum())
                    for _, a, c in pairs)
        rows.append({"step": i + 1, "shape": list(b["mel"].shape[:2]),
                     "loss_card": mg["loss"], "loss_cpu": mc["loss"],
                     "loss_rel_gap": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
                     "param_gap": gaps[-1][0], "param_gap_at": gaps[-1][1],
                     "param_rms_gap": math.sqrt(diff2 / norm2),
                     "params_apart": apart, "params": sum(c.numel() for _, _, c in pairs),
                     "relu_flips": flips, "relu_inputs": sum(z.numel() for z in rg["z"].values()),
                     "card_step_ms": card_ms})
        log("phase 16c: drift " + json.dumps(rows[-1]))
    tb = tg.to_device(batches[-1])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        tg.train_step(tb)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 16c: card train step B=16 M={tb['mel'].shape[1]}, dropout 0.0: "
        f"{np.mean(times[2:]):.2f} ms (mean of steps 3-5; {[round(t, 2) for t in times]})")
    _profile_one(f"phase 16c profile: train_step B=16 M={tb['mel'].shape[1]}, dropout 0.0",
                 lambda: tg.train_step(tb))
    return rows


def phase16_formant_training(tmp, corpus8):
    """The formant corpus (16a), ``cli.train`` on it under
    ``torch.distributed.run`` (16b), ten steps' drift card against CPU
    (16c), K1, K1b and K2 on this path's inputs (16b'), ``cli.vocoder
    --mesh 1`` under the launcher and ``--mesh 2`` refused (16d)."""
    from spev_tpu_torch.cli import vocoder as vocoder_cli
    from spev_tpu_torch.cli.common import PNGS_SKIPPED
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.data.synthetic import generate_formant_corpus

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "formant")
    corpus = os.path.join(work, "wavs")
    t0 = time.perf_counter()
    tg = generate_formant_corpus(corpus, n_utterances=FORMANT_UTTS, seed=0)
    gen_s = time.perf_counter() - t0
    log(f"phase 16a: generate_formant_corpus: {FORMANT_UTTS} utterances (seed 0; the quality "
        f"run's 480 cut to {FORMANT_UTTS}) in {gen_s:.2f} s")

    cache = os.path.join(work, "cache")
    t0 = time.perf_counter()
    rc, out = _launch("spev_tpu_torch.cli.train", _formant_train_args(corpus, tg, cache), work,
                      os.path.join(work, "train.log"))
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.train under torch.distributed.run exited with {rc}:\n"
                             + out[-4000:])
    import re

    m = re.search(r"Trained (\d+) steps in ([\d.]+) s \(([\d.]+) ms a step\); kernel launches "
                  r"(\{.*\})", out)
    if m is None:
        raise AssertionError("the training run printed no summary line:\n" + out[-4000:])
    steps, step_ms, launches = int(m.group(1)), float(m.group(3)), json.loads(m.group(4))
    probes = re.findall(r"Probe (\d+): mean=", out)
    failed = re.findall(r"Probe \d+ failed: .*", out)
    rows = [json.loads(line) for line in open(os.path.join(work, "logs", "formant",
                                                              "metrics.jsonl"))]
    pngs = sorted(f for f in os.listdir(os.path.join(work, "logs", "formant"))
                  if f.endswith(".png"))
    quality = formant_quality(rows)
    result = {"steps": steps, "mean_step_ms": step_ms, "run_s": run_s, "launches": launches,
              "epochs": len(rows), "val_mcd_db": [quality["mcd0"], quality["mcd_last"]],
              "val_dur_err_pct": [rows[0].get("val_dur_err_pct"),
                                  rows[-1].get("val_dur_err_pct")],
              "val_mel": [rows[0]["val_mel"], rows[-1]["val_mel"]],
              "probes": len(probes), "pngs": len(pngs),
              "pngs_skipped": PNGS_SKIPPED in out, "quality": quality}
    log(f"phase 16b: python -m torch.distributed.run --standalone --nproc_per_node 1 -m "
        f"spev_tpu_torch.cli.train (NCCL, world size 1; depth cut to {FORMANT_EPOCHS} epochs at "
        f"B=16, lr 1e-3, warmup {FORMANT_WARMUP} steps): " + json.dumps(result))
    group = [ln for ln in out.splitlines() if ln.startswith("Data-parallel")]
    log("phase 16b: the run's process-group line: " + json.dumps(group))
    if group != ["Data-parallel over 1 rank(s), model axis 1 (nccl)"]:
        raise AssertionError("the training run did not report an NCCL group of one rank")
    if failed or len(probes) != 3 * (FORMANT_EPOCHS // 10):
        raise AssertionError(f"the probes failed or did not run: {failed or probes}")
    gating = [b for b in quality["broken"] if b in FORMANT_GATING_BARS]
    if quality["broken"]:
        log("phase 16b: bars broken " + json.dumps(quality["broken"])
            + (" (not gating: ROADMAP.md, section 4, F6)" if not gating else ""))
    if gating:
        raise AssertionError(f"phase 16b: bars broken {gating}: " + json.dumps(quality))
    if launches["fused_log_mel"] != FORMANT_UTTS or launches["lr_fused_bwd"] != steps:
        raise AssertionError(f"launches {launches} for {FORMANT_UTTS} utterances, {steps} steps")
    evals = launches["lr_fused"] - steps - len(probes)
    if evals <= 0 or evals % FORMANT_EPOCHS:
        raise AssertionError(f"K1 launches {launches['lr_fused']} are not one per train "
                             f"forward, validation forward and probe")
    if not (result["pngs_skipped"] or pngs):
        raise AssertionError("no PNG was written and none was reported skipped")

    # 16c: drift, card against CPU; the card's K1/K1b inputs are kept
    kept = {"lr_fused": {}, "lr_fused_bwd": {}, "overlap_add": {}, "fused_log_mel": {}}
    t0 = time.perf_counter()
    drift = _drift(cache, kept)
    drift_s = time.perf_counter() - t0
    # K2's inputs: the same dataset build on eight of the corpus's files
    sub = os.path.join(work, "sub")
    os.makedirs(sub)
    for name in sorted(n for n in os.listdir(corpus) if n.endswith((".wav", ".txt")))[:16]:
        os.symlink(os.path.join(corpus, name), os.path.join(sub, name))  # eight pairs
    with _keep_kernel_inputs() as kept_fx:
        SpevDataset(sub, textgrid_dir=tg, cache_dir=os.path.join(work, "sub_cache"),
                    device="cuda")
    kept["fused_log_mel"] = kept_fx["fused_log_mel"]
    k1, k1b = phase6b_training_inputs(kept, "phase 16b'", "formant_training")
    k2 = phase8b_extraction_inputs(kept, "phase 16b'", "formant_corpus")

    # 16d: cli.vocoder --mesh 1 under the launcher (it saves at its last
    # step, as JAX's does); --mesh 2 refused in this process, before any data
    voc = ["--data_dir", corpus8, "--steps", "2", *VOC_ARGS]
    t0 = time.perf_counter()
    rc1, out1 = _launch("spev_tpu_torch.cli.vocoder", voc + ["--name", "mesh1", "--mesh", "1"],
                        work, os.path.join(work, "voc1.log"))
    voc_s = time.perf_counter() - t0
    err2 = io.StringIO()
    with contextlib.redirect_stderr(err2):
        rc2 = vocoder_cli.main(voc + ["--name", "mesh2", "--mesh", "2"])
    out2 = err2.getvalue()
    log(f"phase 16d: cli.vocoder --mesh 1 under the launcher (V1, 2 steps) exited {rc1} in "
        f"{voc_s:.1f} s: " + json.dumps([ln for ln in out1.splitlines()
                                          if ln.startswith(("data-parallel", "step "))])
        + f"; --mesh 2 at world size 1 returned {rc2}: "
        + json.dumps([ln for ln in out2.splitlines() if ln.startswith("error:")]))
    if rc1 != 0 or "data-parallel over 1 devices" not in out1:
        raise AssertionError("cli.vocoder --mesh 1 failed:\n" + out1[-4000:])
    if rc2 != 2 or "error: --mesh 2 needs a process group of 2 ranks" not in out2:
        raise AssertionError("cli.vocoder --mesh 2 at world size 1 did not exit 2:\n" + out2)
    phase_s = time.perf_counter() - t_phase
    log(f"phase 16: {phase_s:.1f} s (corpus {gen_s:.1f}, training run {run_s:.1f}, drift "
        f"{drift_s:.1f}, vocoder {voc_s:.1f})")
    return ({"formant_training": launches, "drift": drift, "phase_s": phase_s},
            k1, k1b, k2)


# -- phase 17: native I/O, the preppers, the parallel build, the model axis -------


def _riff(path, fmt_code, n_ch, sr, bits, data, extensible=False, junk=b""):
    """A RIFF/WAVE file written byte by byte; ``junk`` goes into an odd-sized
    LIST chunk (padded to even) before the data."""
    import struct

    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code, n_ch, sr, sr * block,
                      block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if junk:
        chunks += b"LIST" + struct.pack("<I", len(junk)) + junk + b"\x00" * (len(junk) & 1)
    chunks += b"data" + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


def phase17a_native_io(work):
    """The C++ reader against the Python reader on every format, the writer,
    trim/normalize against the Python prep, the prefetcher, and each
    reader's time per file."""
    from spev_tpu_torch.data.downloaders import _normalize, _trim_silence
    from spev_tpu_torch.utils import native, wavio

    t0 = time.perf_counter()
    if not native.available():  # builds it
        raise AssertionError("the native I/O library did not build")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(17)
    n = 22050
    x = rng.uniform(-1, 1, n)
    i24 = np.round(x * 8388607).astype(np.int32)
    b24 = np.stack([i24 & 255, (i24 >> 8) & 255, (i24 >> 16) & 255], 1).astype(np.uint8)
    pcm16 = np.round(x * 32767).astype("<i2").tobytes()
    cases = {
        "pcm8": (1, 1, 16000, 8, np.round(x[:-1] * 127 + 128).astype(np.uint8).tobytes(), {}),
        "pcm16": (1, 1, 22050, 16, pcm16, {}),
        "pcm24": (1, 1, 44100, 24, b24.tobytes(), {}),
        "int32": (1, 1, 22050, 32, np.round(x * 2147483000).astype("<i4").tobytes(), {}),
        "float32": (3, 1, 24000, 32, x.astype("<f4").tobytes(), {}),
        "stereo": (1, 2, 22050, 16,
                   np.round(rng.uniform(-1, 1, (n, 2)) * 32767).astype("<i2").tobytes(), {}),
        "extensible": (1, 1, 22050, 16, pcm16, {"extensible": True}),
        "odd_chunk": (1, 1, 22050, 16, pcm16, {"junk": b"INFOabc"}),
    }
    for name, (code, n_ch, sr, bits, data, kw) in cases.items():
        path = os.path.join(work, f"{name}.wav")
        _riff(path, code, n_ch, sr, bits, data, **kw)
        y, rate = native.read_wav(path)
        yp, rate_p = wavio.read_wav(path)
        if not (rate == rate_p == sr and y.dtype == np.float32 and np.array_equal(y, yp)):
            raise AssertionError(f"phase 17a: the C++ reader and the Python reader differ on "
                                 f"{name}")
    y = rng.uniform(-1.1, 1.1, 30000).astype(np.float32)
    path = os.path.join(work, "written.wav")
    native.write_wav(path, y, 22050)
    back, rate = native.read_wav(path)
    pcm = (np.clip(y, -1, 1) * 32767.0).astype(np.int16).astype(np.float32) / 32768.0
    if not (rate == 22050 and np.array_equal(back, pcm)):
        raise AssertionError("phase 17a: write_wav does not round-trip")
    speech, _ = _speech_like(rng, 3 * 22050, 22050)
    ours = native.trim_normalize(speech, top_db=25.0)
    ref = _normalize(_trim_silence(speech, top_db=25.0))
    gap = float(np.abs(ours - ref).max()) if ours.shape == ref.shape else math.inf
    if not gap <= 1e-6:
        raise AssertionError(f"phase 17a: trim_normalize is {gap} from the Python prep "
                             f"(shapes {ours.shape}, {ref.shape})")
    paths = []
    for i in range(16):
        paths.append(os.path.join(work, f"timed_{i:02d}.wav"))
        wavio.write_wav(paths[-1], _speech_like(rng, 5 * 22050, 22050)[0], 22050)
    times = {}
    for name, read in (("native.read_wav", native.read_wav), ("wavio.read_wav", wavio.read_wav)):
        t0 = time.perf_counter()
        arrays = [read(p)[0] for p in paths]
        times[name] = (time.perf_counter() - t0) / len(paths) * 1e6
    t0 = time.perf_counter()
    reader = native.PrefetchingReader(paths, capacity=4)
    got = list(reader)
    reader.close()
    times["PrefetchingReader"] = (time.perf_counter() - t0) / len(paths) * 1e6
    if [i for i, _, _ in got] != list(range(len(paths))) or not all(
            np.array_equal(a, y) for (_, a, _), y in zip(got, arrays)):
        raise AssertionError("phase 17a: the prefetcher's arrays differ from read_wav's")
    result = {"formats": sorted(cases), "trim_normalize_gap": gap, "build_s": build_s,
              "us_per_5s_file": times}
    log("phase 17a: native I/O: the C++ reader bit-equal to the Python reader on "
        + json.dumps(result))
    return result


def _write_prep_trees(root, rng):
    """LJSpeech-, ESD- and Jenny-shaped trees of speech-like wavs: LJSpeech
    24 wavs at 44.1 kHz with metadata.csv; ESD 3 speakers × 4 emotions × 4
    utterances at 16 kHz with tab transcripts; Jenny 8 wavs at 48 kHz."""
    from spev_tpu_torch.utils.wavio import write_wav

    words = " ".join(TEXTS).split()

    def text(k):
        start = int(rng.integers(0, len(words)))
        return " ".join(words[(start + j) % len(words)] for j in range(k))

    lj = os.path.join(root, "raw", "LJSpeech-1.1")
    os.makedirs(os.path.join(lj, "wavs"))
    rows = []
    for i in range(24):
        wid = f"LJ017-{i:04d}"
        write_wav(os.path.join(lj, "wavs", wid + ".wav"),
                  _speech_like(rng, int(rng.uniform(1.0, 2.0) * 44100), 44100)[0], 44100)
        t = text(4)
        rows.append(f"{wid}|{t.upper()}|{t}")
    with open(os.path.join(lj, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    esd = os.path.join(root, "esd")
    for spk in ESD_SPEAKERS:
        lines = []
        for emo in ("Angry", "Happy", "Neutral", "Sad"):
            os.makedirs(os.path.join(esd, spk, emo))
            for k in range(4):
                utt = f"{spk}_{len(lines):06d}"
                write_wav(os.path.join(esd, spk, emo, utt + ".wav"),
                          _speech_like(rng, int(rng.uniform(1.0, 2.5) * 16000), 16000)[0],
                          16000)
                lines.append(f"{utt}\t{text(3)}\t{emo}")
        with open(os.path.join(esd, spk, f"{spk}.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    jenny = os.path.join(root, "jenny")
    os.makedirs(os.path.join(jenny, "audio"))
    rows = []
    for i in range(8):
        uid = f"jenny_{i:04d}"
        write_wav(os.path.join(jenny, "audio", uid + ".wav"),
                  _speech_like(rng, int(rng.uniform(1.0, 2.0) * 48000), 48000)[0], 48000)
        rows.append(f"{uid}|{text(4)}")
    with open(os.path.join(jenny, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return lj, esd, jenny


def phase17b_preppers(work):
    """``cli.download prep`` on the ESD and Jenny trees and ``download``
    with the LJSpeech root already in ``--work_dir``; no network (a call to
    ``urlretrieve`` would raise).  Returns the ESD pairs' folder."""
    import urllib.request

    from spev_tpu_torch.cli import download

    t0 = time.perf_counter()
    lj, esd, jenny = _write_prep_trees(work, np.random.default_rng(170))
    trees_s = time.perf_counter() - t0

    def offline(*a, **k):
        raise AssertionError("phase 17b: urlretrieve was called")

    saved, urllib.request.urlretrieve = urllib.request.urlretrieve, offline
    runs = {}
    try:
        for name, argv in (
                ("esd", ["prep", "--dataset", "esd", "--in_dir", esd, "--out_dir",
                         os.path.join(work, "esd_pairs")]),
                ("jenny", ["prep", "--dataset", "jenny", "--in_dir", jenny, "--out_dir",
                           os.path.join(work, "jenny_pairs")]),
                ("ljspeech", ["download", "--dataset", "single-speaker", "--work_dir",
                              os.path.dirname(lj), "--out_dir", os.path.join(work, "lj_pairs")])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = download.main(argv)
            runs[name] = {"rc": rc, "s": time.perf_counter() - t0,
                          "printed": out.getvalue().strip().splitlines()}
    finally:
        urllib.request.urlretrieve = saved
    counts = {k: len([f for f in os.listdir(os.path.join(work, f"{p}_pairs"))
                      if f.endswith(".wav")])
              for k, p in (("esd", "esd"), ("jenny", "jenny"), ("ljspeech", "lj"))}
    log(f"phase 17b: trees written in {trees_s:.2f} s; cli.download: " + json.dumps(runs)
        + "; pairs " + json.dumps(counts))
    if (any(r["rc"] != 0 for r in runs.values())
            or counts != {"esd": 48, "jenny": 8, "ljspeech": 24}
            or runs["ljspeech"]["printed"] != ["LJSpeech: 24 utterances"]):
        raise AssertionError("phase 17b: the preppers did not write every pair")
    return os.path.join(work, "esd_pairs"), runs


_K2_COUNT_FILE = []


def _counted_worker_init(count_dir, *initargs):
    """A build worker's `_build_worker_init`, then K2's count zeroed: from
    here on the worker's launches are the build's."""
    from spev_tpu_torch.data import dataset as ds_mod
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel

    ds_mod._build_worker_init(*initargs)
    fused_log_mel.launches = 0
    _K2_COUNT_FILE.append(os.path.join(count_dir, f"k2_{os.getpid()}.json"))


def _counted_worker_run(item):
    """A build worker's `_build_worker_run`, then the worker's K2 count so
    far written to its file (the last write holds its total)."""
    from spev_tpu_torch.data import dataset as ds_mod
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel

    row = ds_mod._build_worker_run(item)
    with open(_K2_COUNT_FILE[0], "w") as f:
        json.dump({"launches": fused_log_mel.launches}, f)
    return row


def _worker_k2_probe(paths):
    """In a spawned build worker (after ``_build_worker_init``): pass 2 of
    ``paths`` as the build runs it there, with K2's launch count zeroed just
    before and read just after, then K2 against its plain version on the
    signals it was given, in this process."""
    from spev_tpu_torch.data import dataset as ds_mod
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel

    fused_log_mel.launches = 0
    with _keep_kernel_inputs() as kept:
        rows = [ds_mod._build_worker_run((i, p))[1] for i, p in enumerate(paths)]
    launches = fused_log_mel.launches
    cases = phase8b_extraction_inputs(kept, f"phase 17c (build worker, pid {os.getpid()})",
                                      "parallel_build_worker")
    return {"pid": os.getpid(), "rows": rows, "launches": launches, "cases": cases}


def phase17c_parallel_build(work, pairs):
    """The ESD pairs' cache built on the card serially and over four build
    workers: the caches must be bit-equal; each build's pass-2 wall time; K2's
    launches in the build's own workers (each worker's count zeroed after its
    set-up and written after each file; they must sum to one a file); and, in
    one more spawned worker set up as the build's, K2 against its plain
    version."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from spev_tpu_torch.data import dataset as ds_mod
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel

    kw = dict(g2p_backend="rules", multi_speaker=True, emotion_vad=True, device="cuda")
    pass2 = {}
    originals = {k: getattr(ds_mod.SpevDataset, k) for k in ("_serial_extract",
                                                             "_parallel_extract")}
    workers = {k: getattr(ds_mod, k) for k in ("_build_worker_init", "_build_worker_run")}
    count_dir = os.path.join(work, "k2_counts")
    os.makedirs(count_dir)

    def timed(name):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            yield from originals[name](self, *a, **k)
            pass2[name] = time.perf_counter() - t0
        return run

    builds, walls = {}, {}
    try:
        for name in originals:
            setattr(ds_mod.SpevDataset, name, timed(name))
        # the pool pickles these by name: the workers run chip_smoke's wrappers
        ds_mod._build_worker_init = functools.partial(_counted_worker_init, count_dir)
        ds_mod._build_worker_run = _counted_worker_run
        for label, n_workers in (("serial", 1), ("workers4", 4)):
            fused_log_mel.launches = 0
            t0 = time.perf_counter()
            builds[label] = ds_mod.SpevDataset(pairs, cache_dir=os.path.join(work, label),
                                               build_workers=n_workers, **kw)
            walls[label] = time.perf_counter() - t0
            if label == "serial":
                serial_launches = fused_log_mel.launches
            else:
                parent_launches = fused_log_mel.launches
    finally:
        for name, fn in originals.items():
            setattr(ds_mod.SpevDataset, name, fn)
        for name, fn in workers.items():
            setattr(ds_mod, name, fn)
    by_worker = {}
    for name in sorted(os.listdir(count_dir)):
        with open(os.path.join(count_dir, name)) as f:
            by_worker[name[3:-5]] = json.load(f)["launches"]
    worker_launches = sum(by_worker.values())
    a, b = builds["serial"], builds["workers4"]
    metas = [json.load(open(os.path.join(d.cache_dir, "metadata.json"))) for d in (a, b)]
    if metas[0] != metas[1] or len(a) != 48 or len(a.speakers) != 3 or len(a.emotions) != 4:
        raise AssertionError("phase 17c: the two builds' metadata differ or are short")
    gaps = {}
    for i in range(len(a)):
        ua, ub = a.load_utterance(i), b.load_utterance(i)
        if sorted(ua) != sorted(ub) or list(ua["phs"]) != list(ub["phs"]):
            raise AssertionError(f"phase 17c: utterance {i} differs in its keys or phonemes")
        for k in ua:
            if k != "phs":
                gaps[k] = max(gaps.get(k, 0.0), float(np.abs(ua[k].astype(np.float64)
                                                             - ub[k]).max()))
    bit_equal = not any(gaps.values())
    if not bit_equal:
        # each worker runs the serial build's kernels on the same shapes
        raise AssertionError(f"phase 17c: the 4-worker cache differs from the serial one: {gaps}")

    if serial_launches != len(a):
        raise AssertionError(f"phase 17c: K2 ran {serial_launches} times in the serial build of "
                             f"{len(a)} utterances")
    if (worker_launches != len(a) or parent_launches != 0 or len(by_worker) < 2
            or str(os.getpid()) in by_worker):
        raise AssertionError(f"phase 17c: K2 ran {by_worker} times in the build's workers and "
                             f"{parent_launches} times in the parent, for {len(a)} utterances")
    # one more worker, set up as the build sets up its own, holds K2 against
    # its plain version in its process (these launches are the check's)
    os.makedirs(os.path.join(work, "probe"))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx, initializer=ds_mod._build_worker_init,
                             initargs=(a.audio, a.stats, os.path.join(work, "probe"), "rules",
                                       None, 4000, True, ds_mod.resolve_device("cuda"),
                                       torch.get_num_threads())) as ex:
        wavs = sorted(os.path.join(pairs, f) for f in os.listdir(pairs) if f.endswith(".wav"))
        probe = ex.submit(_worker_k2_probe, wavs[:4]).result()
    if probe["rows"] != ["ok"] * 4 or probe["launches"] != 4 or probe["pid"] == os.getpid():
        raise AssertionError(f"phase 17c: the checking worker's K2 launches {probe}")
    speedup = pass2["_serial_extract"] / pass2["_parallel_extract"]
    result = {"utterances": len(a), "bit_equal": bit_equal, "max_gap_by_array": gaps,
              "pass2_s": {"serial": pass2["_serial_extract"],
                          "workers4": pass2["_parallel_extract"]},
              "pass2_speedup": speedup, "build_s": walls,
              "serial_k2_launches": serial_launches, "worker_k2_launches": worker_launches,
              "worker_k2_launches_by_pid": by_worker}
    log("phase 17c: parallel build on the card (4 spawned workers, K2 in each): "
        + json.dumps(result))
    return result, probe


def _p17_config(vocab_size, **train):
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig

    return SpevConfig(model=ModelConfig(vocab_size=vocab_size, vp_output_norm=False,
                                        dropout=0.0, vp_dropout=0.0),
                      train=TrainConfig(warmup_steps=20, matmul_precision="high", **train))


def _p17_batch(work):
    """Phase 6's fixed (128, 1024) batch of 16, its vocab and stats, as
    written by the parent for the ranks."""
    with open(os.path.join(work, "setup.json")) as f:
        setup = json.load(f)
    with np.load(os.path.join(work, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    return setup["vocab"], setup["stats"], batch


def _tp_rank(rank, n, coordinator, work):
    """One rank of phase 17d: two ranks on the one card over gloo (NCCL
    refuses two ranks on one device), mesh (1, 2).  One train step with
    the launch counts zeroed just before and read just after; the gathered
    gradients and parameters (rank 0 writes them and the checkpoint); a few
    more steps timed; then, one rank after the other, K1 and K1b against
    their plain versions on this rank's inputs."""
    import torch.distributed as dist

    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.parallel.mesh import gather_state_dict
    from spev_tpu_torch.train.trainer import Trainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=n, rank=rank)
    try:
        vocab, stats, batch = _p17_batch(work)
        cfg = _p17_config(len(vocab), mesh_shape=(n // 2, 2), mesh_axes=("data", "model"))
        tr = Trainer(cfg, vocab, stats, ckpt_dir=os.path.join(work, "ckpt"),
                     log_dir=os.path.join(work, "log"), device="cuda")
        tb = tr.to_device(tr.local_rows(batch))
        lr_fused.launches = lr_fused_bwd.launches = 0
        with _keep_kernel_inputs() as kept, _relu_decisions(tr.model) as relu:
            t0 = time.perf_counter()
            loss, metrics, grads = tr.global_gradients(tb)
            m = tr.apply_gradients(grads, loss, metrics)  # reads the metrics: synchronised
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = {"lr_fused": lr_fused.launches, "lr_fused_bwd": lr_fused_bwd.launches}
        torch.save(relu["z"], os.path.join(work, f"relu_rank{rank}.pt"))
        names = [name for name, _ in tr.model.named_parameters()]
        g = gather_state_dict(dict(zip(names, grads)), tr.mesh)
        p = gather_state_dict(tr.model.state_dict(), tr.mesh)
        if tr.is_main:
            np.savez(os.path.join(work, "tp_step.npz"), loss=np.float64(m["loss"]),
                     **{f"g_{k}": v.cpu().numpy() for k, v in g.items()},
                     **{f"p_{k}": v.cpu().numpy() for k, v in p.items()})
        tr.save("tp", include_opt=False)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            tr.train_step(tb)
            times.append((time.perf_counter() - t0) * 1e3)
        k1 = k1b = None
        for r in range(n):  # the kernel checks one rank at a time: the card is shared
            if r == rank:
                k1, k1b = phase6b_training_inputs(kept, f"phase 17d rank {rank}",
                                                  "tensor_parallel")
            dist.barrier()
        return {"rank": rank, "coords": [tr.mesh.data_index, tr.mesh.model_index],
                "devices": [str(d) for d in tr.mesh.devices.reshape(-1)],
                "loss": m["loss"], "skipped": m["skipped"], "launches": launches,
                "first_step_ms": first_ms, "step_ms": times, "k1": k1, "k1b": k1b}
    finally:
        dist.destroy_process_group()


def _tp_gaps(tp, grads, params, before, lr, eps, wd):
    """The tensor-parallel step's gathered gradients and updated parameters
    against a one-process step's: the largest gradient gap over its
    tensor's max |g| (and the three worst tensors); the largest parameter
    gap over its tensor's max |p| where the gradient is above 1e-4 of its
    max and above 1000·eps; and, for the other weights, how far either step
    moved them and, where |g| is above 1e-5 of its max (well above the
    gradients' rounding) and the update is at least lr/2, whether both
    updates take -g's sign.  AdamW's first update is lr·g/(|g| + eps) after
    the decay p·(1 - lr·wd): about ±lr whatever |g|, so a gradient that is
    rounding noise moves a weight by up to lr either way, and within a few
    decades of eps the update still depends on |g|, by eps/|g| times the
    gradient's relative gap (the attention's zero-initialised in_proj
    biases have such gradients)."""
    g_gaps = sorted(((float(np.abs(tp[f"g_{k}"] - v).max() / max(np.abs(v).max(), 1e-30)), k)
                     for k, v in grads.items()), reverse=True)
    p_gaps, noise, moved, signed, wrong = [(0.0, "")], 0, 0.0, 0, 0
    for k, v in params.items():
        g = grads.get(k)
        real = ((np.abs(g) > 1e-4 * np.abs(g).max()) & (np.abs(g) > 1e3 * eps)
                if g is not None else np.ones(v.shape, bool))
        if real.any():
            p_gaps.append((float(np.abs(tp[f"p_{k}"][real] - v[real]).max()
                                 / max(np.abs(v).max(), 1e-30)), k))
        if (~real).any():
            noise += int((~real).sum())
            moved = max(moved, float(np.abs(np.stack([tp[f"p_{k}"][~real], v[~real]])
                                            - before[k][~real]).max()))
            kept = before[k].astype(np.float64) * (1.0 - lr * wd)
            d_ref, d_tp = v - kept, tp[f"p_{k}"] - kept
            check = (~real & (np.abs(g) > 1e-5 * np.abs(g).max())
                     & (np.abs(d_ref) >= 0.5 * lr))
            signed += int(check.sum())
            wrong += int((check & ((np.sign(d_ref) != -np.sign(g))
                                   | (np.sign(d_tp) != -np.sign(g)))).sum())
    p_gaps.sort(reverse=True)
    return {"grad_gap_of_max": g_gaps[0][0], "worst_grads": g_gaps[:3],
            "param_gap_of_max": p_gaps[0][0], "worst_params": p_gaps[:3],
            "noise_gradient_weights": noise, "noise_weights_moved_max": moved,
            "noise_weights_sign_checked": signed, "noise_weights_wrong_sign": wrong,
            "within": (g_gaps[0][0] <= 1e-5 and p_gaps[0][0] <= 1e-5 and moved <= 1.01 * lr
                       and wrong == 0)}


def phase17d_tensor_parallel(work, cache, hdir):
    """Two ranks on the one card over gloo, mesh (1, 2), the base model at
    full width on phase 6's fixed batch: one step in fp32 (TF32 off) held to
    the one-process step on the card.  cuDNN picks its algorithms by shape,
    and conv1's and conv2's shapes differ on a rank, so a ReLU input within
    rounding of zero can fall on the other side (phase 7's effect): the
    one-process step is taken twice: as it is (loss within 1e-6 relative,
    gradients and updated parameters within 1e-3 of their max), and taking
    the tensor-parallel step's side of zero at every ReLU conv (held to the
    bars of `_tp_gaps`).  The gathered checkpoint served by a one-process
    Synthesizer."""
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.infer.synthesis import Synthesizer
    from spev_tpu_torch.parallel.multiproc import spawn_ranks
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    ds = SpevDataset(None, cache_dir=cache)
    vocab = Vocab(ds.vocab)
    batch = next(b for b in BucketBatcher(ds, vocab, batch_size=16).epoch(0)
                 if b["mel"].shape[1] == 1024 and b["ids"].shape[1] == 128)
    np.savez(os.path.join(work, "batch.npz"), **batch)
    with open(os.path.join(work, "setup.json"), "w") as f:
        json.dump({"vocab": list(vocab.symbols), "stats": ds.stats}, f)
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, "chip_smoke:_tp_rank", (work,), timeout_s=300)
    ranks_s = time.perf_counter() - t0
    with np.load(os.path.join(work, "tp_step.npz")) as z:
        tp = {k: z[k] for k in z.files}
    # the ranks' ReLU conv outputs: conv1's column halves joined, the rest replicated
    zs = [torch.load(os.path.join(work, f"relu_rank{r}.pt")) for r in range(2)]
    tp_relu = {"z": {k: torch.cat([zs[0][k], zs[1][k]], -1) if k.endswith(".conv1")
                     else zs[0][k] for k in zs[0]}}

    # the one-process step on the card, from the same weights and batch
    runs = {}
    for label in ("as_is", "taking_tp_sides"):
        tr = Trainer(_p17_config(len(vocab)), vocab, ds.stats,
                     ckpt_dir=os.path.join(work, "one"), log_dir=os.path.join(work, "one"))
        tb = tr.to_device(batch)
        before = {k: v.detach().cpu().numpy().copy() for k, v in tr.model.state_dict().items()}
        side = tp_relu if label == "taking_tp_sides" else None
        with (_relu_decisions(tr.model, side) if side else contextlib.nullcontext()) as rec:
            t0 = time.perf_counter()
            loss, metrics, grads = tr.global_gradients(tb)
            m = tr.apply_gradients(grads, loss, metrics)
            first_ms = (time.perf_counter() - t0) * 1e3
        names = [name for name, _ in tr.model.named_parameters()]
        ref_g = {k: v.detach().cpu().numpy().copy() for k, v in zip(names, grads)}
        ref_p = {k: v.detach().cpu().numpy().copy() for k, v in tr.model.state_dict().items()}
        lr = tr.cfg.train.learning_rate / tr.cfg.train.warmup_steps
        runs[label] = {"loss": m["loss"], "skipped": m["skipped"], "first_step_ms": first_ms,
                       "loss_rel_gap": abs(float(tp["loss"]) - m["loss"]) / abs(m["loss"]),
                       **_tp_gaps(tp, ref_g, ref_p, before, lr, tr.cfg.train.eps,
                                  tr.cfg.train.weight_decay)}
        if side:
            runs[label]["relu_flips"] = sum(rec["flips"].values())
            runs[label]["relu_inputs"] = sum(z.numel() for z in tp_relu["z"].values())
            runs[label]["relu_conv_out_gap"] = max(rec["fwd_err"].values())
    one_times = []
    for _ in range(4):
        t1 = time.perf_counter()
        tr.train_step(tb)
        one_times.append((time.perf_counter() - t1) * 1e3)
    per_rank = [r["launches"] for r in ranks]
    aligned, as_is = runs["taking_tp_sides"], runs["as_is"]
    result = {"ranks": [{k: r[k] for k in ("rank", "coords", "devices", "loss", "launches",
                                           "first_step_ms", "step_ms")} for r in ranks],
              "one_process": runs, "one_process_step_ms": one_times, "lr_first_step": lr,
              "ranks_wall_s": ranks_s}
    log("phase 17d: tensor parallelism, 2 gloo ranks on one card, mesh (1, 2), full width, "
        "B=16 P=128 M=1024, fp32 (TF32 off): " + json.dumps(result))
    if (any(r["skipped"] for r in ranks) or aligned["skipped"] or as_is["skipped"]
            or per_rank != [{"lr_fused": 1, "lr_fused_bwd": 1}] * 2
            or [r["coords"] for r in ranks] != [[0, 0], [0, 1]]):
        raise AssertionError("phase 17d: a step was skipped, or a rank's launches or "
                             "coordinates are wrong")
    if not (aligned["loss_rel_gap"] <= 1e-6 and aligned["within"]
            and aligned["relu_conv_out_gap"] < 1e-5):
        raise AssertionError("phase 17d: the tensor-parallel step disagrees with the "
                             "one-process step taking its ReLU sides")
    # as it is, the one-process step differs where a ReLU input within
    # rounding of zero falls on the other side (1.1e-4 of max |g| in the
    # runs so far): a sharding fault would show far above that
    if not (as_is["loss_rel_gap"] <= 1e-6 and as_is["grad_gap_of_max"] <= 1e-3
            and as_is["param_gap_of_max"] <= 1e-3):
        raise AssertionError("phase 17d: the tensor-parallel step is more than 1e-3 from the "
                             "one-process step as it is")
    synth = Synthesizer(os.path.join(work, "ckpt", "tp.pt"), hifigan_dir=hdir,
                        g2p_backend="rules")
    wav, mel = synth.synthesize(TEXTS[0])
    _check_row(wav, mel)
    log(f"phase 17d: the gathered tp.pt served by a one-process Synthesizer: {mel.shape[0]} "
        "frames, finite waveform")
    return result, [c for r in ranks for c in r["k1"]], [c for r in ranks for c in r["k1b"]]


def phase17_extraction_and_model_axis(tmp, hdir):
    """Native I/O (17a), the preppers (17b), the parallel build (17c) and the
    model axis on one card (17d)."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "p17")
    os.makedirs(work)
    native_io = phase17a_native_io(work)
    pairs, prep = phase17b_preppers(work)
    build, probe = phase17c_parallel_build(work, pairs)
    tp_work = os.path.join(work, "tp")
    os.makedirs(tp_work)
    tp, k1, k1b = phase17d_tensor_parallel(tp_work, os.path.join(tmp, "cache"), hdir)
    phase_s = time.perf_counter() - t_phase
    log(f"phase 17: {phase_s:.1f} s")
    launches = {"lr_fused": sum(r["launches"]["lr_fused"] for r in tp["ranks"]),
                "lr_fused_bwd": sum(r["launches"]["lr_fused_bwd"] for r in tp["ranks"]),
                "fused_log_mel_serial": build["serial_k2_launches"],
                "fused_log_mel_worker": build["worker_k2_launches"]}
    return ({"launches": launches, "native_io": native_io, "preppers": prep, "build": build,
             "tensor_parallel": tp, "phase_s": phase_s}, k1, k1b, probe["cases"])


# -- phase 18: the acoustic trainer's precision modes and remat -----------------
MODES = ("highest", "high", "mixed", "default")
# each TF32 mode's gradients against 'high''s: the largest gap of a tensor
# over its max |g|, and the gap's norm over the gradients' (TF32 keeps a
# 10-bit mantissa; 'default''s TF32 forward also moves the activations, and
# a tensor whose gradient is a sum that cancels shows it most; PERF.md,
# section 2)
MODE_GRAD_BAR = {"mixed": 1e-2, "default": 2e-1}
MODE_NORM_BAR = 1e-2
# remat against no remat, and 'highest' against 'high', of each max |g|;
# the compared passes run with cuDNN's deterministic algorithms, so they
# are bit-equal unless something else differs
REMAT_GRAD_BAR = 1e-6
REMAT_BATCHES = (16, 48)
MODE_STEPS, REMAT_STEPS = 10, 5  # timed steps after the compared one


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _grad_gap(grads, ref, names):
    """The largest gap of a gradient over its tensor's max |g| of ``ref``,
    and the tensor it is in."""
    gaps = [(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)), n)
            for a, b, n in zip(grads, ref, names)]
    return max(gaps)


def _norm_gap(grads, ref):
    """‖grads − ref‖ / ‖ref‖ over all the gradients."""
    num = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(grads, ref))
    return math.sqrt(num / sum(float(b.double().square().sum()) for b in ref))


def _p18_trainer(vocab, stats, work, precision, dropout=0.0, policy=None):
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.train.trainer import Trainer

    cfg = SpevConfig(model=ModelConfig(vocab_size=len(vocab), vp_output_norm=False,
                                       dropout=dropout, vp_dropout=dropout,
                                       remat=policy is not None, remat_policy=policy or "full"),
                     train=TrainConfig(warmup_steps=20, matmul_precision=precision))
    return Trainer(cfg, vocab, stats, ckpt_dir=work, log_dir=work)


def _compared_pass(tr, tb):
    """``tr.global_gradients(tb)`` with cuDNN's deterministic algorithms
    (some of its fp32 weight-gradient kernels sum in a varying order: two
    runs of one step differed by 4e-7 of max |g|), synchronised."""
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        out = tr.global_gradients(tb)
    torch.cuda.synchronize()
    return out


def _timed_steps(tr, tb, n):
    """ms of each of ``n`` train steps (each reads its metrics: synchronised)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        tr.train_step(tb)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase18a_modes(batch, vocab, stats, work, counts):
    """One step from one seeded init, dropout off, in each mode: the loss,
    the gradients against 'high''s, K1/K1b once, the process's TF32 flags
    unchanged; then ten steps (3-10 timed) and one profiled."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd

    caller = _tf32_flags()
    res, grads, losses = {}, {}, {}
    for mode in MODES:
        tr = _p18_trainer(vocab, stats, work, mode)
        names = [n for n, _ in tr.model.named_parameters()]
        tb = tr.to_device(batch)
        before = (lr_fused.launches, lr_fused_bwd.launches)
        loss, metrics, g = _compared_pass(tr, tb)
        once = (lr_fused.launches - before[0], lr_fused_bwd.launches - before[1])
        flags = _tf32_flags()
        losses[mode], grads[mode] = loss.detach().clone(), [x.detach().clone() for x in g]
        tr.apply_gradients(g, loss, metrics)
        times = _timed_steps(tr, tb, MODE_STEPS)
        prof = _profile_stats(lambda: tr.train_step(tb))
        counts["fwd"] += MODE_STEPS + 3  # the compared step, the timed, the profiled two
        counts["bwd"] += MODE_STEPS + 3
        res[mode] = {"loss": float(loss.detach()), "k1_k1b_first_step": list(once),
                     "flags_after": list(flags), "flags_after_steps": list(_tf32_flags()),
                     "step_ms": float(np.mean(times[2:])), "step_ms_min": min(times[2:]),
                     "step_ms_max": max(times[2:]),
                     "busy_pct": prof and prof["busy_pct"], "union_pct": prof and prof["union_pct"],
                     "busy_ms": prof and prof["busy_ms"],
                     "busy_pct_of_mean_step": prof and 100 * prof["busy_ms"] / np.mean(times[2:]),
                     "device_ops": prof and prof["ops"],
                     "tf32_kernels": prof and sum("tf32" in k.lower()
                                                  for k, _, _ in prof["kernels"]),
                     "top": prof and [(k[:60], round(t / 1e3, 3)) for k, t, _ in
                                      prof["kernels"][:4]]}
        del tr, tb
    for mode in MODES:
        gap, where = _grad_gap(grads[mode], grads["high"], names)
        res[mode].update(grad_gap_of_max_vs_high=gap, worst=where,
                         grad_norm_gap_vs_high=_norm_gap(grads[mode], grads["high"]),
                         loss_equal_high=bool(torch.equal(losses[mode], losses["high"])))
    log("phase 18a: one step per matmul precision mode, B=16 P=128 M=1024, dropout off "
        f"(the caller's TF32 flags {list(caller)}): " + json.dumps(res))
    if any(r["k1_k1b_first_step"] != [1, 1] for r in res.values()):
        raise AssertionError("phase 18a: K1 and K1b did not run once per step in every mode")
    if any(r["flags_after"] != list(caller) or r["flags_after_steps"] != list(caller)
           for r in res.values()):
        raise AssertionError("phase 18a: a step left the process's TF32 flags changed")
    if not (res["mixed"]["loss_equal_high"] and res["highest"]["loss_equal_high"]):
        raise AssertionError("phase 18a: 'mixed''s or 'highest''s loss is not bit-equal to "
                             "'high''s")
    if res["highest"]["grad_gap_of_max_vs_high"] > REMAT_GRAD_BAR:
        raise AssertionError("phase 18a: 'highest''s gradients differ from 'high''s")
    if any(res[m]["grad_gap_of_max_vs_high"] > bar or res[m]["grad_norm_gap_vs_high"]
           > MODE_NORM_BAR for m, bar in MODE_GRAD_BAR.items()):
        raise AssertionError(f"phase 18a: a TF32 mode's gradients lie beyond {MODE_GRAD_BAR} "
                             f"of max |g| or {MODE_NORM_BAR} of their norm from 'high''s")
    return res


def phase18b_remat(batch, vocab, stats, work, counts):
    """Remat off, 'full' and 'dots' with dropout 0.1 from one generator seed,
    at the default 'mixed', at B=16 and B=48 (phase 6's batch three times):
    gradients and the generator's state against no remat, K1/K1b once a
    step, the peak memory of the next train step over what was allocated
    before it, and ms a step."""
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd

    res = {}
    for rows in REMAT_BATCHES:
        big = {k: np.concatenate([v] * (rows // len(v))) for k, v in batch.items()}
        ref = None
        for policy in (None, "full", "dots"):
            tr = _p18_trainer(vocab, stats, work, "mixed", dropout=0.1, policy=policy)
            names = [n for n, _ in tr.model.named_parameters()]
            tb = tr.to_device(big)
            before = (lr_fused.launches, lr_fused_bwd.launches)
            loss, metrics, g = _compared_pass(tr, tb)
            once = [lr_fused.launches - before[0], lr_fused_bwd.launches - before[1]]
            state = tr.generator.get_state().clone()
            if ref is None:
                ref = (loss.detach().clone(), [x.detach().clone() for x in g], state)
            gap, where = _grad_gap(g, ref[1], names)
            tr.apply_gradients(g, loss, metrics)  # AdamW's moments are allocated
            del g
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            times = _timed_steps(tr, tb, 1)
            peak = torch.cuda.max_memory_allocated()
            times += _timed_steps(tr, tb, REMAT_STEPS - 1)
            counts["fwd"] += REMAT_STEPS + 1
            counts["bwd"] += REMAT_STEPS + 1
            res[f"B{rows}_{policy or 'off'}"] = {
                "peak_gib": peak / 2**30, "activations_gib": (peak - resident) / 2**30,
                "step_ms": float(np.mean(times[1:])), "step_ms_all": times,
                "loss_equal": bool(torch.equal(loss.detach(), ref[0])),
                "grad_gap_of_max": gap, "worst": where,
                "grads_bit_equal": gap == 0.0,
                "generator_equal": bool(torch.equal(state, ref[2])), "k1_k1b": once}
            del tr, tb
    log("phase 18b: remat at 'mixed', dropout 0.1 from one seed, P=128 M=1024: "
        + json.dumps(res))
    bad = [k for k, r in res.items() if r["k1_k1b"] != [1, 1] or not r["loss_equal"]
           or r["grad_gap_of_max"] > REMAT_GRAD_BAR or not r["generator_equal"]]
    if bad:
        raise AssertionError(f"phase 18b: remat changed the step or its launches: {bad}")
    for rows in REMAT_BATCHES:
        if not res[f"B{rows}_full"]["peak_gib"] < res[f"B{rows}_off"]["peak_gib"]:
            raise AssertionError(f"phase 18b: 'full' remat did not lower the peak at B={rows}")
    return res


def phase18c_cli(cache, work, counts):
    """``cli.train`` on phase 16's formant cache, 2 epochs at the default
    'mixed': exits 0, every number in its metrics.jsonl finite, K1 once per
    train and eval forward, K1b once per train step."""
    from spev_tpu_torch.cli import train as train_cli
    from spev_tpu_torch.train.trainer import Trainer

    steps, evals, modes = [0], [0], set()
    orig_train, orig_eval = Trainer.train_step, Trainer.eval_step

    def train_step(self, batch, variance_weight=1.0):
        steps[0] += 1
        modes.add(self.cfg.train.matmul_precision)
        return orig_train(self, batch, variance_weight)

    def eval_step(self, batch):
        evals[0] += 1
        return orig_eval(self, batch)

    Trainer.train_step, Trainer.eval_step = train_step, eval_step
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rc = train_cli.main(["--cache_dir", cache, "--name", "p18", "--epochs", "2",
                             "--batch_size", "16", "--warmup_steps", "20"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        Trainer.train_step, Trainer.eval_step = orig_train, orig_eval
    counts["fwd"] += steps[0] + evals[0]
    counts["bwd"] += steps[0]
    rows = [json.loads(line) for line in open(os.path.join(work, "logs", "p18",
                                                              "metrics.jsonl"))]
    finite = all(math.isfinite(v) for r in rows for v in r.values()
                 if isinstance(v, (int, float)))
    result = {"rc": rc, "steps": steps[0], "evals": evals[0], "modes": sorted(modes),
              "run_s": run_s, "epochs": len(rows), "finite": finite,
              "train_loss": [r.get("train_loss") for r in rows]}
    log("phase 18c: cli.train on phase 16's formant cache, 2 epochs at the default "
        "precision: " + json.dumps(result))
    if rc != 0 or not finite or len(rows) != 2 or modes != {"mixed"}:
        raise AssertionError("phase 18c: the training CLI failed at the default 'mixed'")
    return result


def phase18_precision_and_remat(tmp):
    """The acoustic trainer's precision modes (18a), remat (18b) and the CLI
    at the default mode (18c), at full width on phase 6's fixed batch; the
    launch counts zeroed before and read after, then (18') K1 and K1b on
    this phase's inputs."""
    from spev_tpu_torch.data.batching import BucketBatcher
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd
    from spev_tpu_torch.text.vocab import Vocab

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "p18")
    os.makedirs(work)
    ds = SpevDataset(None, cache_dir=os.path.join(tmp, "cache"))
    vocab = Vocab(ds.vocab)
    batch = next(b for b in BucketBatcher(ds, vocab, batch_size=16).epoch(0)
                 if b["mel"].shape[1] == 1024 and b["ids"].shape[1] == 128)
    counts = {"fwd": 0, "bwd": 0}
    with _keep_kernel_inputs() as kept:
        lr_fused.launches = lr_fused_bwd.launches = 0
        modes = phase18a_modes(batch, vocab, ds.stats, work, counts)
        remat = phase18b_remat(batch, vocab, ds.stats, work, counts)
        cli = phase18c_cli(os.path.join(tmp, "formant", "cache"), work, counts)
        launches = {"lr_fused": lr_fused.launches, "lr_fused_bwd": lr_fused_bwd.launches}
    if launches != {"lr_fused": counts["fwd"], "lr_fused_bwd": counts["bwd"]}:
        raise AssertionError(f"phase 18: launches {launches} for {counts['fwd']} forwards and "
                             f"{counts['bwd']} backwards")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 18: {phase_s:.1f} s; launches {json.dumps(launches)}")
    k1, k1b = phase6b_training_inputs(kept, "phase 18'", "precision_remat")
    return {"launches": launches, "modes": modes, "remat": remat, "cli": cli,
            "phase_s": phase_s}, k1, k1b


# -- phase 19: the learned-control evidence ---------------------------------------
# the JAX package's calibrated epochs for the register proof
# (tests/test_emotion_register.py:31)
REGISTER_EPOCHS = 60
PHASE19_CAP_S = 240.0
# tests/test_emotion_register.py:43-71, one name for each of its asserts
REGISTER_BARS = ("f0_order", "frames_order", "vad_proj", "emotions", "durerr_aggregate",
                 "durerr_per_emotion")
# the bars that held in every card run of the recipe; the per-emotion 15 %
# (2 held-out happy utterances) broke in one card run (ROADMAP.md, section 4)
REGISTER_GATING_BARS = ("f0_order", "frames_order", "vad_proj", "emotions", "durerr_aggregate")


@contextlib.contextmanager
def _count_evidence_calls():
    """While active: acoustic forwards (one K1 each), train steps (one K1b
    each), utterances through ``full_features`` and log-mels through
    ``mel`` (one K2 each), Griffin-Lim vocodings (33 K3 each), and the
    seconds spent building datasets, training and validating."""
    from spev_tpu_torch.data.dataset import FeatureExtractor, SpevDataset
    from spev_tpu_torch.infer import vocoder as voc_mod
    from spev_tpu_torch.models.fastspeech2 import FastSpeech2
    from spev_tpu_torch.train.trainer import Trainer

    counts = {"forwards": 0, "train_steps": 0, "utterances_built": 0, "mels": 0,
              "griffin_lim_vocodings": 0, "build_s": 0.0, "train_s": 0.0, "validate_s": 0.0}
    sites = [(FastSpeech2, "forward", "forwards"), (Trainer, "train_step", "train_steps"),
             (FeatureExtractor, "full_features", "utterances_built"),
             (FeatureExtractor, "mel", "mels"),
             (voc_mod, "mel_to_audio", "griffin_lim_vocodings"),
             (SpevDataset, "__init__", "build_s"), (Trainer, "train_epoch", "train_s"),
             (Trainer, "validate", "validate_s")]
    originals = [getattr(owner, name) for owner, name, _ in sites]

    def counting(fn, key):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if key.endswith("_s"):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                counts[key] += time.perf_counter() - t0
                return out
            counts[key] += 1
            return fn(*args, **kwargs)
        return call

    for (owner, name, key), fn in zip(sites, originals):
        setattr(owner, name, counting(fn, key))
    try:
        yield counts
    finally:
        for (owner, name, _), fn in zip(sites, originals):
            setattr(owner, name, fn)


def register_quality(res):
    """The readings of ``tools/torch_emotion_register_demo.py``'s JSON that
    the JAX package's asserts hold (``tests/test_emotion_register.py:43-71``):
    the predicted F0 and frames per register, the held-out duration error
    in aggregate (weighted by each emotion's count) and per emotion, and
    the names of the `REGISTER_BARS` broken."""
    r, rows = res["registers"], res["per_emotion_val"]
    f0 = {e: r[e]["pred_f0_hz"] for e in ("happy", "neutral", "sad")}
    fr = {e: r[e]["synth_frames"] for e in ("happy", "neutral", "sad")}
    total_n = sum(row["n"] for row in rows.values())
    agg = sum(row["dur_err_pct"] * row["n"] for row in rows.values()) / max(total_n, 1)
    per = {e: row["dur_err_pct"] for e, row in rows.items()}
    met = {"f0_order": f0["happy"] > f0["neutral"] > f0["sad"],
           "frames_order": fr["sad"] > fr["neutral"] >= fr["happy"],
           "vad_proj": res["vad_proj_abs_mean"] > 1e-3,
           "emotions": set(rows) >= {"neutral", "happy", "sad", "angry"},
           "durerr_aggregate": agg < 10.0,
           "durerr_per_emotion": all(v < 15.0 for v in per.values())}
    return {"pred_f0_hz": f0, "synth_frames": fr, "dur_err_pct_aggregate": agg,
            "dur_err_pct": per, "n": {e: row["n"] for e, row in rows.items()},
            "broken": [b for b in REGISTER_BARS if not met[b]]}


def phase19a_registers(work):
    """The emotion-register run of ``tools/torch_emotion_register_demo.py``
    for `REGISTER_EPOCHS`, held to the JAX package's asserts that gate
    (`REGISTER_GATING_BARS`); the others are printed."""
    from spev_tpu_torch.diag.evidence import train_emotion_registers

    t0 = time.perf_counter()
    res = train_emotion_registers(REGISTER_EPOCHS, os.path.join(work, "emotion_metrics.json"),
                                  device="cuda", work=os.path.join(work, "emo"))
    run_s = time.perf_counter() - t0
    q = register_quality(res)
    log(f"phase 19a: emotion registers, {REGISTER_EPOCHS} epochs in {run_s:.1f} s: "
        + json.dumps({"registers": res["registers"], "per_emotion_val": res["per_emotion_val"],
                      "dur_err_pct_aggregate": q["dur_err_pct_aggregate"],
                      "vad_proj_abs_mean": res["vad_proj_abs_mean"],
                      "final_quality": res["final_quality"], "broken": q["broken"],
                      "gating": list(REGISTER_GATING_BARS)}))
    failed = [b for b in q["broken"] if b in REGISTER_GATING_BARS]
    if failed:
        raise AssertionError("phase 19a: bars " + ", ".join(failed) + " broken: "
                             + json.dumps({k: q[k] for k in ("pred_f0_hz", "synth_frames",
                                                             "dur_err_pct_aggregate",
                                                             "dur_err_pct")}))
    return {"run_s": run_s, "dur_err_pct_aggregate": q["dur_err_pct_aggregate"], **res}


def phase19c_sweeps(ckpt, work):
    """``tools/torch_advanced_controls_demo.py``'s sweeps on phase 16's
    checkpoint: emphasis gains frames, nasality's tilt does not rise, lung
    capacity's frames and breaths do not fall (none at 1.0, at least one at
    0.3).  The age sweep's pitch after the rule, in the model and in the
    audio, is printed with no bar (see the module's docstring, phase 19)."""
    from spev_tpu_torch.diag.evidence import AGES, SWEEP_BUCKETS, age_model_f0, control_sweeps
    from spev_tpu_torch.infer.synthesis import Synthesizer

    t0 = time.perf_counter()
    res = control_sweeps(ckpt, os.path.join(work, "sweeps"), device="cuda")
    synth = Synthesizer(ckpt, hifigan_dir=None, g2p_backend="rules", device="cuda",
                        **SWEEP_BUCKETS)
    model_f0 = age_model_f0(synth)
    run_s = time.perf_counter() - t0
    frames = [r["speech_frames"] for r in res["lung_sweep"]]
    breaths = [r["inserted_breaths"] for r in res["lung_sweep"]]
    tilts = [r["spectral_tilt"] for r in res["nasality_sweep"]]
    audio_f0 = [r["median_f0_hz"] for r in res["age_sweep"]]
    summary = {"age": list(AGES), "age_model_f0_hz": model_f0, "age_audio_f0_hz": audio_f0,
               "emphasis": res["emphasis"], "nasality_tilt": tilts, "lung_frames": frames,
               "lung_breaths": breaths,
               "lung_samples": [r["wav_samples"] for r in res["lung_sweep"]]}
    log(f"phase 19c: control sweeps on phase 16's checkpoint in {run_s:.1f} s: "
        + json.dumps(summary))
    failed = []
    if not res["emphasis"]["emphasized_frames"] > res["emphasis"]["baseline_frames"]:
        failed.append("emphasis gained no frames")
    if not all(a >= b for a, b in zip(tilts, tilts[1:])):
        failed.append(f"nasality's tilt rose: {tilts}")
    if not (res["lung_monotone"] and breaths[0] == 0 and breaths[-1] >= 1):
        failed.append(f"lung capacity: frames {frames}, breaths {breaths}")
    if failed:
        raise AssertionError("phase 19c: " + "; ".join(failed))
    return {"run_s": run_s, "age_model_f0_hz": model_f0, **res}


_KERNEL_WRAPPERS = ("lr_fused", "lr_fused_bwd", "fused_log_mel", "overlap_add")


def _kernel_wrappers():
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd

    return dict(zip(_KERNEL_WRAPPERS, (lr_fused, lr_fused_bwd, fused_log_mel, overlap_add)))


def _expected_launches(counts):
    return {"lr_fused": counts["forwards"], "lr_fused_bwd": counts["train_steps"],
            "fused_log_mel": counts["utterances_built"] + counts["mels"],
            "overlap_add": 33 * counts["griffin_lim_vocodings"]}


def phase19_control_evidence(tmp):
    """The emotion registers (19a), then the control sweeps (19c), with the
    launch counts zeroed before and read after; then (19') K1, K1b, K2 and
    K3 on this phase's inputs against their plain versions."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "p19")
    os.makedirs(work)
    ckpt = os.path.join(tmp, "formant", "checkpoints", "formant", "best.spev")
    wrappers = _kernel_wrappers()
    with _keep_kernel_inputs() as kept, _count_evidence_calls() as counts:
        for w in wrappers.values():
            w.launches = 0
        registers = phase19a_registers(work)
        sweeps = phase19c_sweeps(ckpt, work)
        launches = {name: w.launches for name, w in wrappers.items()}
    log("phase 19: launches " + json.dumps(launches) + " for " + json.dumps(counts))
    if launches != _expected_launches(counts) or min(launches.values()) == 0:
        raise AssertionError(f"phase 19: launches {launches}, expected "
                             f"{_expected_launches(counts)}")
    run_s = time.perf_counter() - t_phase
    k1, k1b = phase6b_training_inputs(kept, "phase 19'", "control_evidence")
    k2 = phase8b_extraction_inputs(kept, "phase 19'", "control_evidence")
    k3 = []
    for args, _ in kept["overlap_add"].values():
        k3.append({**_k3_case(*args), "main_path": "control_evidence"})
        log("phase 19': K3 bit-equal to plain on control-evidence inputs", json.dumps(k3[-1]))
    phase_s = time.perf_counter() - t_phase
    log(f"phase 19: {phase_s:.1f} s (cap {PHASE19_CAP_S:.0f}; 19a {registers['run_s']:.1f}, "
        f"19c {sweeps['run_s']:.1f}, 19' {phase_s - run_s:.1f}; dataset builds "
        f"{counts['build_s']:.1f}, training {counts['train_s']:.1f}, validation "
        f"{counts['validate_s']:.1f})")
    if phase_s > PHASE19_CAP_S:
        raise AssertionError(f"phase 19 took {phase_s:.1f} s, over its {PHASE19_CAP_S:.0f} s")
    return {"launches": launches, "counts": counts, "phase_s": phase_s}, k1, k1b, k2, k3


# -- phase 20: the installed port, and the formant-corpus quality gate ---------
GATE_EPOCHS = 45  # tests/test_convergence.py's
PHASE20_CAP_S = 240.0
# the bars of `convergence.gate_failures` that gate the smoke: those that
# held in every calibration run on the card (PERF.md, section 6).  The MCD
# bars and the trend are printed without failing the phase: the val MCD at
# epoch 45 lands anywhere from 22 to 65 dB from run to run (ROADMAP.md,
# section 4, F6)
GATING_BARS = ("durerr", "freerun")
# what an installed package is built from: everything git would commit
# (gitignored outputs and build products left out)
_NOT_SHIPPED = (".git", ".scratch", ".scratch2", "_build", "__pycache__",
                "*.egg-info", "build", "dist", "checkpoints", "logs", "cache_spev",
                ".pytest_cache")
WHEEL_SOURCES = ("spev_tpu_torch/csrc/length_regulator.cu", "spev_tpu_torch/csrc/log_mel.cu",
                 "spev_tpu_torch/csrc/overlap_add.cu", "spev_tpu_torch/csrc/spevio.cpp")


def _pip(*args, cwd=None):
    """``python -m pip`` offline: no index, no cache, no version check."""
    argv = [sys.executable, "-m", "pip", *args, "--no-index", "--no-cache-dir",
            "--disable-pip-version-check", "-q"]
    out = subprocess.run(argv, cwd=cwd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"pip {args[0]} failed ({out.returncode}):\n{out.stdout}{out.stderr}")


def install_read_only(work):
    """A wheel of this checkout built offline (``pip wheel --no-deps
    --no-build-isolation`` on a copy, so nothing is written into the
    checkout), installed with ``pip install --no-deps --target`` into
    ``work/site``, whose files and directories are then made read-only.
    Returns (wheel path, the wheel's names, the install directory)."""
    import shutil
    import zipfile

    src, dist, target = (os.path.join(work, d) for d in ("src", "dist", "site"))
    shutil.copytree(os.path.dirname(os.path.abspath(__file__)), src,
                    ignore=shutil.ignore_patterns(*_NOT_SHIPPED))
    _pip("wheel", "--no-deps", "--no-build-isolation", "-w", dist, src)
    (wheel,) = [os.path.join(dist, f) for f in os.listdir(dist) if f.endswith(".whl")]
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
    _pip("install", "--no-deps", "--no-compile", "--target", target, wheel)
    for d, _, files in os.walk(target):
        for f in files:
            os.chmod(os.path.join(d, f), 0o444)
        os.chmod(d, 0o555)
    return wheel, names, target


def tree_state(root):
    """Every path under ``root`` with its size and modification time."""
    state = {}
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            p = os.path.join(d, name)
            st = os.lstat(p)
            state[os.path.relpath(p, root)] = (st.st_size, st.st_mtime_ns)
    return state


def run_installed(target, cache, kernels):
    """`installed_checks` in a fresh interpreter that imports the port
    from ``target`` (first on ``sys.path``), with ``XDG_CACHE_HOME`` at
    ``cache`` and no bytecode written; returns its JSON line."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{target!r}, {here!r}]; import chip_smoke; "
            f"chip_smoke.installed_checks({target!r}, {kernels!r})")
    env = {**os.environ, "XDG_CACHE_HOME": cache, "PYTHONDONTWRITEBYTECODE": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cache, env=env, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"the installed port's checks failed ({out.returncode}):\n"
                             f"{out.stdout[-4000:]}{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def installed_checks(target, kernels):
    """Run by `run_installed`: the port imported from ``target`` builds its
    libraries into ``$XDG_CACHE_HOME/spev_tpu_torch/build``.  The native
    I/O library's reader is held bit-equal to the Python reader on a seeded
    16-bit wav; with ``kernels`` (on the card) K1/K1b, K2 and K3 are built
    (timed) and each held against its plain version at the first case of
    phases 2, 2b, 3b and 3.  Prints one JSON line."""
    import spev_tpu_torch
    from spev_tpu_torch.utils import native, wavio

    loaded = {m.__file__ for name, m in sys.modules.items()
              if name.startswith("spev_tpu_torch") and getattr(m, "__file__", None)}
    outside = sorted(f for f in loaded if not f.startswith(target + os.sep))
    if outside:
        raise AssertionError(f"modules loaded from outside the install: {outside[:5]}")
    expected = os.path.join(os.environ["XDG_CACHE_HOME"], "spev_tpu_torch", "build")
    y = np.random.default_rng(20).uniform(-0.9, 0.9, 22050).astype(np.float32)
    wav = os.path.join(os.environ["XDG_CACHE_HOME"], "seeded.wav")
    wavio.write_wav(wav, y, 22050)
    t0 = time.perf_counter()
    (yc, src), (yp, srp) = native.read_wav(wav), wavio.read_wav(wav)
    io_s = time.perf_counter() - t0
    lib = native.library_path()
    if not (native._lib is not None and os.path.dirname(lib) == expected
            and os.path.exists(lib)):
        raise AssertionError(f"the native library is not built in the user cache: {lib}")
    if not (src == srp and yc.dtype == yp.dtype and np.array_equal(yc, yp)):
        raise AssertionError("the installed native reader differs from the Python reader")
    res = {"package": os.path.dirname(spev_tpu_torch.__file__), "build_dir": expected,
           "native_library": os.path.basename(lib), "native_build_and_read_s": io_s,
           "samples": int(yc.size)}
    if kernels:
        from spev_tpu_torch.diag.kernel_ab import durations
        from spev_tpu_torch.ops.cuda import build
        from spev_tpu_torch.ops.cuda.length_regulator_kernel import N_TRACKS
        from spev_tpu_torch.ops.length_regulator import regulate_lengths
        from spev_tpu_torch.ops.stft import hann_window

        if build.BUILD_DIR != expected:
            raise AssertionError(f"the kernels' build dir is {build.BUILD_DIR}")
        t0 = time.perf_counter()
        build.build_all()
        res["kernels_build_s"] = time.perf_counter() - t0
        res["kernel_libraries"] = sorted(f for f in os.listdir(expected) if f.endswith(".so"))
        g = torch.Generator().manual_seed(1)
        ends, _ = regulate_lengths(durations("mixed", 16, 128, g).cuda())
        x = torch.randn(16, 128, 256, generator=g).cuda()
        fpad = torch.randn(16, 128, N_TRACKS, generator=g).cuda()
        fpad[..., 5:] = 0.0
        res["k1"] = _k1_case(x, fpad, ends.contiguous(), 768)
        gx = torch.randn(16, 768, 256, generator=g).cuda()
        gf = torch.randn(16, 768, N_TRACKS, generator=g).cuda()
        res["k1b"] = _k1b_case(gx, gf, ends.contiguous(), 128)
        res["k2"] = _k2_case(torch.from_numpy(_k2_signal(221184, 5)).cuda())
        win = torch.from_numpy(hann_window(1024)).cuda()
        res["k3"] = _k3_case((torch.randn(2048, 1024, generator=g).cuda() * win), win, 256)
    print(json.dumps(res), flush=True)


def phase20a_installed(work):
    """F5 on the card: a wheel of the checkout, installed read-only; in a
    fresh process the installed port builds K1/K1b, K2, K3 and the native
    I/O library into the user cache and holds each against its plain
    version; nothing is written into the installed package."""
    t0 = time.perf_counter()
    wheel, names, target = install_read_only(work)
    missing = [s for s in WHEEL_SOURCES if s not in names]
    if missing:
        raise AssertionError(f"phase 20a: the wheel lacks {missing}")
    install_s = time.perf_counter() - t0
    before = tree_state(target)
    cache = os.path.join(work, "xdg")
    os.makedirs(cache)
    res = run_installed(target, cache, kernels=True)
    if tree_state(target) != before:
        raise AssertionError("phase 20a: the installed package was written to")
    res.update(wheel=os.path.basename(wheel), wheel_files=len(names),
               wheel_and_install_s=install_s, phase_s=time.perf_counter() - t0)
    log("phase 20a: " + json.dumps({k: v for k, v in res.items()
                                    if k not in ("k1", "k1b", "k2", "k3")}))
    for k in ("k1", "k1b", "k2", "k3"):
        log(f"phase 20a: the installed {k.upper()} against its plain version", json.dumps(res[k]))
    return res


def phase20b_gate(work):
    """``tools/torch_gate_calibration.py``'s run: the formant setup built on
    the card, `GATE_EPOCHS` epochs at the trainer's default 'mixed', the
    free-running pass, the summary; a bar of `GATING_BARS` that it breaks
    fails the phase, any other is printed."""
    from spev_tpu_torch.diag import convergence as cv

    t0 = time.perf_counter()
    s = cv.build_quality_setup(GATE_EPOCHS, device="cuda", work=os.path.join(work, "gate"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hist = cv.run_dashboard(s, GATE_EPOCHS, on_epoch=cv.progress(GATE_EPOCHS))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    errs = cv.freerun_frame_errors(s.trainer, s.ds, s.vocab, s.cfg, s.va_idx, device="cuda")
    t3 = time.perf_counter()
    summary = cv.gate_summary(hist, errs, GATE_EPOCHS, 1.0)
    failures = cv.gate_failures(summary)
    log(f"phase 20b: gate summary ({len(s.ds)} utterances, {s.trainer.step} steps, "
        f"{s.cfg.train.matmul_precision!r}; build {t1 - t0:.1f} s, training {t2 - t1:.1f} s, "
        f"free-running {t3 - t2:.1f} s) " + json.dumps(summary))
    log("phase 20b: free-running frame errors % " + json.dumps(errs))
    gating = [f for f in failures if f.split(":")[0] in GATING_BARS]
    if failures:
        log("phase 20b: bars broken " + json.dumps(failures)
            + (" (not gating: ROADMAP.md, section 4)" if not gating else ""))
    if gating:
        raise AssertionError("phase 20b: " + "; ".join(gating))
    return s, {"summary": summary, "failures": failures, "build_s": t1 - t0,
               "train_s": t2 - t1, "freerun_s": t3 - t2}


def phase20c_demo(setup, work, gan_checkpoint, gan_config):
    """``tools/torch_make_demo.py``'s page from 20b's trained setup, with
    ``gan_checkpoint`` as the GAN vocoder: every file written, finite audio,
    each utterance's frames and MCD printed."""
    from spev_tpu_torch.diag import convergence as cv
    from spev_tpu_torch.utils.wavio import read_wav

    t0 = time.perf_counter()
    out = os.path.join(work, "demo")
    metrics = cv.write_demo(setup, out, gan_checkpoint=gan_checkpoint, gan_config=gan_config)
    n = len(setup.va_idx[:3])
    for j in range(n):
        for kind in ("gt", "synth", "synth_gan"):
            y, _ = read_wav(os.path.join(out, f"val{j}_{kind}.wav"))
            if not (y.size and np.isfinite(y).all()):
                raise AssertionError(f"phase 20c: val{j}_{kind}.wav is empty or not finite")
    if len(metrics["utterances"]) != n or not os.path.exists(
            os.path.join(out, "demo_metrics.json")):
        raise AssertionError("phase 20c: the demo is incomplete")
    run_s = time.perf_counter() - t0
    log(f"phase 20c: demo page ({gan_config} GAN vocoder from {os.path.basename(gan_checkpoint)}) "
        f"in {run_s:.1f} s: " + json.dumps(metrics["utterances"]))
    return {"run_s": run_s, **metrics}


def phase20_quality_gate(tmp, gan_checkpoint, gan_config="v1"):
    """F5 on the card (20a), then the convergence gate (20b) and the demo
    page (20c) with the launch counts zeroed before and read after; then
    (20') K1, K1b, K2 and K3 on 20b/20c's inputs against their plain
    versions."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "p20")
    os.makedirs(work)
    installed = phase20a_installed(work)
    wrappers = _kernel_wrappers()
    with _keep_kernel_inputs() as kept, _count_evidence_calls() as counts:
        for w in wrappers.values():
            w.launches = 0
        setup, gate = phase20b_gate(work)
        demo = phase20c_demo(setup, work, gan_checkpoint, gan_config)
        launches = {name: w.launches for name, w in wrappers.items()}
    log("phase 20: launches " + json.dumps(launches) + " for " + json.dumps(counts))
    if launches != _expected_launches(counts) or min(launches.values()) == 0:
        raise AssertionError(f"phase 20: launches {launches}, expected "
                             f"{_expected_launches(counts)}")
    run_s = time.perf_counter() - t_phase
    k1, k1b = phase6b_training_inputs(kept, "phase 20'", "quality_gate")
    k2 = phase8b_extraction_inputs(kept, "phase 20'", "quality_gate")
    k3 = []
    for args, _ in kept["overlap_add"].values():
        k3.append({**_k3_case(*args), "main_path": "quality_gate"})
        log("phase 20': K3 bit-equal to plain on quality-gate inputs", json.dumps(k3[-1]))
    phase_s = time.perf_counter() - t_phase
    log(f"phase 20: {phase_s:.1f} s (cap {PHASE20_CAP_S:.0f}; 20a {installed['phase_s']:.1f}, "
        f"20b {gate['build_s'] + gate['train_s'] + gate['freerun_s']:.1f}, 20c "
        f"{demo['run_s']:.1f}, 20' {phase_s - run_s:.1f})")
    if phase_s > PHASE20_CAP_S:
        raise AssertionError(f"phase 20 took {phase_s:.1f} s, over its {PHASE20_CAP_S:.0f} s")
    return ({"launches": launches, "counts": counts, "phase_s": phase_s, "gate": gate,
             "demo": demo, "installed": installed, "setup": setup}, k1, k1b, k2, k3)


# -- phase 21: the GAN-vocoder evidence -------------------------------------------
PHASE21_CAP_S = 200.0
# 21a's V3 training (the JAX recipe's B=16, 32-frame crops) and 21b's arms
P21_ARGS = ["--config", "v3", "--batch_size", "16", "--segment_frames", "32"]
P21_STEPS = 400
P21_ARM_STEPS = 32
# the quality orderings phase 21 prints: GAN copy synthesis under
# Griffin-Lim's on every demo utterance (21a), the gta arm's mean
# predicted-mel MCD under the control arm's (21b).  One gates only once it
# held in at least five runs of tools/torch_phase21.py on the card; both
# held in all five at these step counts (and in six of six with 8-step
# arms; PERF.md, section 6).
ORDERINGS = ("gan_under_gl", "gta_under_control")
GATING_ORDERINGS = ORDERINGS


def _finite_wav(path, what):
    from spev_tpu_torch.utils.wavio import read_wav

    y, _ = read_wav(path)
    if not (y.size and np.isfinite(y).all()):
        raise AssertionError(f"phase 21: {what} {os.path.basename(path)} is empty or not finite")


def phase21a_copy_synthesis(work, setup, rec):
    """A V3 generator trained through ``cli.vocoder`` on phase 20's formant
    corpus (`P21_STEPS` steps, B=16), its steps timed, then
    ``tools/torch_gan_copysynth.py``'s copy synthesis of the demo's three
    held-out utterances with both columns."""
    from spev_tpu_torch.cli import vocoder as voc_cli
    from spev_tpu_torch.diag.vocoder_evidence import copy_synthesis, utterance_wavs

    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc = voc_cli.main(["--data_dir", setup.corpus_root, "--name", "v3", "--steps",
                           str(P21_STEPS), "--save_every", str(P21_STEPS), "--log_every", "100",
                           *P21_ARGS])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    gen = os.path.join(work, "checkpoints", "v3", f"gen_{P21_STEPS:08d}.spev")
    if rc != 0 or not os.path.exists(gen):
        raise AssertionError(f"phase 21a: cli.vocoder exited with {rc}")
    steps = rec["step_s"][-P21_STEPS:]
    step_ms = 1e3 * sum(steps[10:]) / len(steps[10:])
    # the demo page's utterances: the setup's first three held out
    wavs = utterance_wavs(setup.corpus_root, setup.ds.files, setup.va_idx[:3])
    out_dir = os.path.join(work, "copysynth")
    cs = copy_synthesis(gen, wavs, config="v3", out_dir=out_dir, device="cuda")
    rows = cs["per_utterance"]
    if len(rows) != 3 or not all(math.isfinite(v) for r in rows.values() for v in r.values()):
        raise AssertionError(f"phase 21a: copy synthesis incomplete or not finite: {rows}")
    for w in wavs:
        _finite_wav(os.path.join(out_dir, os.path.basename(w)[:-4] + "_copysynth_gan.wav"),
                    "the copy synthesis")
    orderings = {"gan_under_gl": all(r["mcd_gan_db"] < r["mcd_gl_db"] for r in rows.values())}
    run_s = time.perf_counter() - t0
    log(f"phase 21a: V3 generator, {P21_STEPS} steps at B=16 in {train_s:.1f} s (step "
        f"{step_ms:.2f} ms, mean of steps 11-{P21_STEPS}, each synchronised); copy synthesis "
        f"of {len(rows)} held-out utterances: " + json.dumps(cs))
    return {"run_s": run_s, "train_s": train_s, "step_ms": step_ms, "gen": gen,
            "copy_synthesis": cs, "orderings": orderings}


def phase21b_gta(work, setup, gen, rec):
    """``tools/torch_prep_gta_work.py``'s work dir from 20b's trained setup
    (its checkpoint, corpus and cache; the setup's own split), two arms of
    `P21_ARM_STEPS` steps from 21a's generator with fresh discriminators
    (``control`` on ground-truth mels, ``gta`` on teacher-forced ones),
    then ``evaluate_arms`` on the 12 held-out utterances."""
    from spev_tpu_torch.diag import vocoder_evidence as ve
    from spev_tpu_torch.infer import gta as gta_mod
    from spev_tpu_torch.utils.wavio import read_wav

    t0 = time.perf_counter()
    acoustic = setup.trainer.save("p21_acoustic", include_opt=False)
    gwork = os.path.join(work, "gta")
    meta = ve.prepare_gta_work(gwork, acoustic, setup.corpus_root, setup.cache,
                               val_fraction=0.1, seed=0, device="cuda")
    if meta["va_idx"] != list(setup.va_idx):
        raise AssertionError("phase 21b: the work dir's split is not the setup's")
    outputs = []
    orig = gta_mod.compute_gta_mels

    def keeping(checkpoint, ds, **kw):
        out = orig(checkpoint, ds, **kw)
        outputs.append((ds, out))
        return out

    gens, mel_calls = {}, {}
    gta_mod.compute_gta_mels = keeping
    try:
        for arm, gta in ve.ARMS:
            before = rec["mel_calls"]
            gens[arm] = ve.run_finetune(gwork, gen, P21_ARM_STEPS, gta, "v3", batch_size=16,
                                        segment_frames=32, device="cuda")
            mel_calls[arm] = rec["mel_calls"] - before
        out_path = os.path.join(gwork, "gta_metrics.json")
        wav_dir = os.path.join(gwork, "wavs")
        res = ve.evaluate_arms(gwork, gen, gens, out_path, "v3", wav_dir=wav_dir,
                               device="cuda")
    finally:
        gta_mod.compute_gta_mels = orig
    # the gta arm's crops are the teacher-forced mels (no ground-truth mel
    # was made), each frame-aligned to its waveform
    (ds, mels), _ = outputs
    if mel_calls["gta"] != 0 or mel_calls["control"] == 0 or not mels:
        raise AssertionError(f"phase 21b: log-mels made per arm {mel_calls}")
    wavs = ve.utterance_wavs(os.path.join(gwork, "corpus_train"), ds.files, list(mels))
    for (i, m), wav in zip(mels.items(), wavs):
        n = len(read_wav(wav)[0])
        if m.shape != ds.load_utterance(i)["mel"].shape or m.shape[0] != 1 + n // 256 \
                or not np.isfinite(m).all():
            raise AssertionError(f"phase 21b: GTA mel {i} {m.shape} against a {n}-sample wav")
    rows = res["per_utterance"]
    scored = [v for row in rows.values() for arm in row.values() for v in arm.values()]
    if res["n_val"] != len(setup.va_idx) or len(rows) != res["n_val"] \
            or any(set(row) != {"baseline", "gta", "control"} for row in rows.values()) \
            or not all(math.isfinite(v) for v in scored):
        raise AssertionError("phase 21b: an arm or an utterance is not scored: "
                             + json.dumps(res))
    with open(out_path) as f:
        if json.load(f) != res:
            raise AssertionError("phase 21b: gta_metrics.json differs from the result")
    for j in range(3):
        for arm in ("baseline", "gta", "control"):
            _finite_wav(os.path.join(wav_dir, f"val{j}_predmel_{arm}.wav"), "the arm's audio")
    summary = res["summary_mean_mcd_db"]
    orderings = {"gta_under_control":
                 summary["gta"]["pred_mcd"] < summary["control"]["pred_mcd"]}
    run_s = time.perf_counter() - t0
    log(f"phase 21b: GTA arms of {P21_ARM_STEPS} steps from 21a's generator, evaluated on "
        f"{res['n_val']} held-out utterances in {run_s:.1f} s: " + json.dumps(summary)
        + f"; GTA mels {len(mels)} (of {len(ds)} train utterances), frame-aligned; log-mels "
        "made per arm " + json.dumps(mel_calls))
    return {"run_s": run_s, "summary": summary, "per_utterance": rows,
            "orderings": orderings}


def phase21_vocoder_evidence(tmp, setup):
    """The GAN-vocoder evidence on phase 20's formant setup, with the launch
    counts zeroed before and read after (K2 once per utterance built or
    log-mel made, K1 once per GTA batch, K3 33 times per Griffin-Lim
    vocoding, no K1b): (21a) copy synthesis, (21b) the GTA demo; then (21')
    K1, K2 and K3 on this phase's inputs against their plain versions."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "p21")
    os.makedirs(work)
    wrappers = _kernel_wrappers()
    with _keep_kernel_inputs() as kept, _count_evidence_calls() as counts, \
            _vocoder_records() as rec:
        for w in wrappers.values():
            w.launches = 0
        a = phase21a_copy_synthesis(work, setup, rec)
        b = phase21b_gta(work, setup, a["gen"], rec)
        launches = {name: w.launches for name, w in wrappers.items()}
    log("phase 21: launches " + json.dumps(launches) + " for " + json.dumps(counts))
    expected = _expected_launches(counts)
    if launches != expected or launches["lr_fused_bwd"] != 0 or min(
            v for k, v in launches.items() if k != "lr_fused_bwd") == 0:
        raise AssertionError(f"phase 21: launches {launches}, expected {expected}")
    orderings = {**a["orderings"], **b["orderings"]}
    log("phase 21: orderings " + json.dumps(orderings) + f" (gating: {list(GATING_ORDERINGS)})")
    broken = [k for k in GATING_ORDERINGS if not orderings[k]]
    if broken:
        raise AssertionError(f"phase 21: orderings not met {broken}")
    run_s = time.perf_counter() - t_phase
    k1 = [{**_k1_case(*args), "main_path": "vocoder_evidence"}
          for args, _ in kept["lr_fused"].values()]
    for c in k1:
        log("phase 21': K1 bit-equal to plain on GTA inputs", json.dumps(c))
    k2 = phase8b_extraction_inputs(kept, "phase 21'", "vocoder_evidence")
    k3 = []
    for args, _ in kept["overlap_add"].values():
        k3.append({**_k3_case(*args), "main_path": "vocoder_evidence"})
        log("phase 21': K3 bit-equal to plain on Griffin-Lim inputs", json.dumps(k3[-1]))
    if not (k1 and k3):
        raise AssertionError("phase 21: the path called no K1 or no K3")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 21: {phase_s:.1f} s (cap {PHASE21_CAP_S:.0f}; 21a {a['run_s']:.1f}, 21b "
        f"{b['run_s']:.1f}, 21' {phase_s - run_s:.1f})")
    if phase_s > PHASE21_CAP_S:
        raise AssertionError(f"phase 21 took {phase_s:.1f} s, over its {PHASE21_CAP_S:.0f} s")
    return ({"launches": launches, "counts": counts, "phase_s": phase_s, "copy": a,
             "gta": b, "orderings": orderings}, k1, k2, k3)


# -- phase 22: the discriminator probes ---------------------------------------------
PHASE22_CAP_S = 60.0
# 22a: the profile's (precision, dtype) groups at the GAN recipe's B=16 and
# 8192 samples; 22b: the bf16 probe at V3, B=16, 32-frame crops, 'default'
P22_GROUPS = (("high", "f32"), ("default", "f32"), ("default", "bf16"))
P22_BATCH, P22_SEGMENT, P22_N_ITER = 16, 8192, 10
P22_STEPS = 50
P22_TIMES = ("fwd_ms", "fwd_bwd_ms", "fwd_host_ms", "fwd_bwd_host_ms", "fwd_graph_ms",
             "fwd_bwd_graph_ms")
# JAX's bar on bf16-D's first-step losses (8 % of max(1, |fp32|)); a bar gates
# only once it held in five runs of tools/torch_phase22.py on the card: this
# one held in six of six, the gaps ~2e-5 (PERF.md, section 6)
P22_GATING_BARS = ("first_step",)


def phase22a_disc_profile():
    """Each sub-discriminator timed alone, forward and forward+backward, in
    each of `P22_GROUPS`, and the roofline table against the H100's peaks;
    fails unless every time is finite and positive and every share is at
    most 105 %."""
    from spev_tpu_torch.diag.disc_profile import time_sub_discriminators
    from spev_tpu_torch.diag.disc_roofline import roofline, roofline_table

    t0 = time.perf_counter()
    rows = []
    for precision, dtype in P22_GROUPS:
        rows += time_sub_discriminators(P22_BATCH, P22_SEGMENT, P22_N_ITER, precision, dtype)
        log(f"phase 22a: {dtype} at '{precision}': " + json.dumps(
            {r["disc"]: [r[k] and round(r[k], 4) for k in P22_TIMES] for r in rows[-9:-1]})
            + f" (fwd, fwd+bwd ms: eager, the host's enqueue of the eager calls, a CUDA "
            f"graph's device time); eager totals {rows[-1]['total_fwd_ms']:.3f} / "
            f"{rows[-1]['total_fwd_bwd_ms']:.3f} ms")
    entries = roofline(rows, P22_BATCH, P22_SEGMENT)  # raises past 105 % or on a bad time
    log(f"phase 22a: roofline at B={P22_BATCH}, {P22_SEGMENT} samples, n_iter {P22_N_ITER} "
        f"({rows[-1]['card']}):\n" + roofline_table(rows, P22_BATCH, P22_SEGMENT))
    return {"rows": rows, "roofline": entries, "max_share": max(e["share"] for e in entries),
            "run_s": time.perf_counter() - t0}


def phase22b_bf16_probe():
    """`P22_STEPS` fused V3 steps with fp32 and with bf16 discriminators from
    one init over the JAX tool's batch pool; fails on a skipped step, a
    non-finite loss, or a master weight or AdamW moment that is not fp32.
    Prints the trajectories, the speed ratio and the first step's gaps
    against JAX's 8 % bar (gating as `P22_GATING_BARS` says)."""
    from spev_tpu_torch.diag import disc_bf16_probe as probe

    t0 = time.perf_counter()
    res = probe.bf16_probe(P22_STEPS, P22_BATCH, 32, "default", seed=0)
    for mode in probe.MODES:
        run = res[mode]
        log(f"phase 22b: {mode} D: " + json.dumps(
            {k: run[k] for k in ("traj", "steps_per_s", "skipped_steps", "finite",
                                 "fp32_state")}))
        if run["skipped_steps"] or not (run["finite"] and run["fp32_state"]):
            raise AssertionError(f"phase 22b: the {mode} run skipped {run['skipped_steps']} "
                                 f"steps, finite {run['finite']}, fp32 state {run['fp32_state']}")
    gaps = probe.first_step_gaps(res)
    bars = {"first_step": all(g < probe.BF16_BAR for g in gaps.values())}
    log(f"phase 22b: speed-up {res['summary']['speedup']:.4f} (bf16 over fp32 steps a second); "
        f"first step |bf16 - fp32| / max(1, |fp32|) " + json.dumps(gaps)
        + f" against {probe.BF16_BAR}: " + json.dumps(bars)
        + f" (gating: {list(P22_GATING_BARS)}); " + json.dumps(res["summary"]))
    broken = [k for k in P22_GATING_BARS if not bars[k]]
    if broken:
        raise AssertionError(f"phase 22b: bars not met {broken}")
    return {"probe": res, "gaps": gaps, "bars": bars, "run_s": time.perf_counter() - t0}


def phase22_disc_probes():
    """The discriminator probes, with the launch counts zeroed before and
    read after (none of K1-K3 is on this path: the GAN step's mel L1 is
    plain and the batches are synthetic): (22a) the profile and roofline,
    (22b) the bf16 probe.  Fails beyond `PHASE22_CAP_S`."""
    t_phase = time.perf_counter()
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    a = phase22a_disc_profile()
    b = phase22b_bf16_probe()
    launches = {name: w.launches for name, w in wrappers.items()}
    phase_s = time.perf_counter() - t_phase
    log(f"phase 22: launches {json.dumps(launches)} (expected 0 each); {phase_s:.1f} s (cap "
        f"{PHASE22_CAP_S:.0f}; 22a {a['run_s']:.1f}, 22b {b['run_s']:.1f})")
    if any(launches.values()):
        raise AssertionError(f"phase 22: launches {launches}, expected none")
    if phase_s > PHASE22_CAP_S:
        raise AssertionError(f"phase 22 took {phase_s:.1f} s, over its {PHASE22_CAP_S:.0f} s")
    return {"launches": launches, "phase_s": phase_s, "profile": a, "probe": b}


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    import spev_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = phase1_card_and_build()
    k1 = phase2_k1()
    k1b = phase2b_k1b()
    k3 = phase3_k3()
    k2 = phase3b_k2()
    with tempfile.TemporaryDirectory() as tmp:
        pt, hdir = _write_checkpoints(tmp)
        serving, kept = phase4_serving(pt, hdir, tmp)
        k1_main, k3_main = phase4b_main_path_inputs(kept)
        phase5_card_vs_cpu(pt, hdir)
        training, kept_train, _ = phase6_training(tmp)
        k1_train, k1b_train = phase6b_training_inputs(kept_train)
        phase7_train_step_card_vs_cpu(tmp)
        extraction, kept_fx, _, (corpus, tg) = phase8_extraction(tmp)
        k2_main = phase8b_extraction_inputs(kept_fx)
        phase9_extraction_card_vs_cpu(tmp, corpus, tg)
        advanced, kept_adv = phase10_advanced(pt, hdir, tmp)
        k1_adv, k3_adv = phase4b_main_path_inputs(kept_adv, "phase 10b")
        adv_train, kept_at, _ = phase11_advanced_training(tmp)
        k1_at, k1b_at = phase6b_training_inputs(kept_at, "phase 11b", "advanced_training")
        k2_at = phase8b_extraction_inputs(kept_at, "phase 11b", "advanced_training")
        phase12_advanced_step_card_vs_cpu(tmp)
        agent, kept_agent, _ = phase13_agent(os.path.join(tmp, "advanced.spev"), hdir, tmp)
        k1_ag, k3_ag = phase4b_main_path_inputs(kept_agent, "phase 13b")
        stack, kept_st, _ = phase14_serving_stack(os.path.join(tmp, "advanced.spev"), hdir, tmp,
                                                  card)
        k1_st, k3_st = phase4b_main_path_inputs(kept_st, "phase 14b")
        k2_st = phase8b_extraction_inputs(kept_st, "phase 14b", "evaluation")
        vocoder, kept_voc, _ = phase15_vocoder_training(tmp, pt, hdir)
        k1_voc, k2_voc = phase15b_vocoder_inputs(kept_voc)
        formant, k1_fm, k1b_fm, k2_fm = phase16_formant_training(tmp, corpus)
        p17, k1_tp, k1b_tp, k2_pb = phase17_extraction_and_model_axis(tmp, hdir)
        p18, k1_pr, k1b_pr = phase18_precision_and_remat(tmp)
        p19, k1_ev, k1b_ev, k2_ev, k3_ev = phase19_control_evidence(tmp)
        p20, k1_qg, k1b_qg, k2_qg, k3_qg = phase20_quality_gate(
            tmp, os.path.join(tmp, "vocoder", "checkpoints", "v1", "gen_00000006.spev"))
        p21, k1_ve, k2_ve, k3_ve = phase21_vocoder_evidence(tmp, p20["setup"])
    phase22_disc_probes()

    def entry(name, source, replaces, cases, by_path):
        head = cases[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "launch_floor_ms": LAUNCH_FLOOR_MS,
            "bound_ms": head["bound_ms"], "bound_by": head.get("bound_by", "bytes"),
            "library_ms": head["library_ms"],
            "cases": cases,
        }

    kernels = [
        entry("lr_fused", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:36",
              k1 + k1_main + k1_train + k1_adv + k1_at + k1_ag + k1_st + k1_voc + k1_fm + k1_tp
              + k1_pr + k1_ev + k1_qg + k1_ve,
              {"serving": serving["lr_fused"], "training": training["lr_fused"],
               "advanced": advanced["lr_fused"], "advanced_training": adv_train["lr_fused"],
               "agent": agent["lr_fused"], "serving_stack": stack["serving_stack"]["lr_fused"],
               "evaluation": stack["evaluation"]["lr_fused"],
               "vocoder_training": vocoder["lr_fused"],
               "formant_training": formant["formant_training"]["lr_fused"],
               "tensor_parallel": p17["launches"]["lr_fused"],
               "precision_remat": p18["launches"]["lr_fused"],
               "control_evidence": p19["launches"]["lr_fused"],
               "quality_gate": p20["launches"]["lr_fused"],
               "vocoder_evidence": p21["launches"]["lr_fused"]}),
        entry("lr_fused_bwd", "spev_tpu_torch/csrc/length_regulator.cu",
              "spev_tpu/ops/pallas/length_regulator_kernel.py:54",
              k1b + k1b_train + k1b_at + k1b_fm + k1b_tp + k1b_pr + k1b_ev + k1b_qg,
              {"training": training["lr_fused_bwd"],
               "advanced_training": adv_train["lr_fused_bwd"],
               "formant_training": formant["formant_training"]["lr_fused_bwd"],
               "tensor_parallel": p17["launches"]["lr_fused_bwd"],
               "precision_remat": p18["launches"]["lr_fused_bwd"],
               "control_evidence": p19["launches"]["lr_fused_bwd"],
               "quality_gate": p20["launches"]["lr_fused_bwd"]}),
        entry("log_mel", "spev_tpu_torch/csrc/log_mel.cu",
              "spev_tpu/ops/pallas/kernels.py:30",
              k2 + k2_main + k2_at + k2_st + k2_voc + k2_fm + k2_pb + k2_ev + k2_qg + k2_ve,
              {"features": extraction["fused_log_mel"],
               "advanced_training": adv_train["fused_log_mel"],
               "evaluation": stack["evaluation"]["fused_log_mel"],
               "vocoder_training": vocoder["fused_log_mel"],
               "formant_training": formant["formant_training"]["fused_log_mel"],
               "parallel_build_serial": p17["launches"]["fused_log_mel_serial"],
               "parallel_build_worker": p17["launches"]["fused_log_mel_worker"],
               "control_evidence": p19["launches"]["fused_log_mel"],
               "quality_gate": p20["launches"]["fused_log_mel"],
               "vocoder_evidence": p21["launches"]["fused_log_mel"]}),
        entry("overlap_add", "spev_tpu_torch/csrc/overlap_add.cu",
              "spev_tpu/ops/pallas/kernels.py:131",
              k3 + k3_main + k3_adv + k3_ag + k3_st + k3_ev + k3_qg + k3_ve,
              {"serving": serving["overlap_add"], "advanced": advanced["overlap_add"],
               "agent": agent["overlap_add"],
               "serving_stack": stack["serving_stack"]["overlap_add"],
               "control_evidence": p19["launches"]["overlap_add"],
               "quality_gate": p20["launches"]["overlap_add"],
               "vocoder_evidence": p21["launches"]["overlap_add"]}),
    ]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s from the build to the kernels line")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
