"""spev_tpu_torch — the SPEV-TTS serving path and acoustic training in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

A second package beside ``spev_tpu`` (the JAX reference, which it never
imports).  Module paths mirror the reference's, so each counterpart is where
a reader expects it:

    config / errors / text.*            own copies of the JAX-free modules
    models.modules / fastspeech2 / hifigan
    ops.length_regulator                LRFused: K1 forward, K1b backward
    ops.stft / griffin_lim
    ops.cuda.length_regulator_kernel    K1 and K1b: fused length regulation
                                        and its backward (CUDA)
    ops.cuda.kernels                    K2 log-mel, K3 windowed overlap-add (CUDA)
    infer.vocoder / synthesis           Vocoder, Synthesizer, infer_tts
    data.dataset / batching / prefetch  feature cache (K2), bucketed batches
    data.emotion                        emotion labels → VAD targets
    train.loss / trainer / checkpoint   acoustic training, .spev and .pt
    models.advanced / policy            VAD/speaker conditioning, BiLSTM policy
    agents.*                            events, prosody, breaths, EmbodiedAgent
    diag.metrics / quality              metrics log, MCD, duration error
    utils.params / msgpack              reference state-dict naming, .spev codec
    cli.*                               ``python -m spev_tpu_torch.cli.*``

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; there, each kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["Synthesizer", "EmbodiedAgent", "Trainer", "infer_tts", "__version__"]


def __getattr__(name):  # the top-level API, imported on first use
    if name == "Synthesizer":
        from spev_tpu_torch.infer.synthesis import Synthesizer

        return Synthesizer
    if name == "infer_tts":
        from spev_tpu_torch.infer.synthesis import infer_tts

        return infer_tts
    if name == "EmbodiedAgent":
        from spev_tpu_torch.agents.embodied import EmbodiedAgent

        return EmbodiedAgent
    if name == "Trainer":
        from spev_tpu_torch.train.trainer import Trainer

        return Trainer
    raise AttributeError(name)
