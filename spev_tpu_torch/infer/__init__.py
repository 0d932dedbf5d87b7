"""Serving: Synthesizer, infer_tts and the Vocoder."""
