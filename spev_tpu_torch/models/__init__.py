"""Acoustic model, vocoder and their neural-net primitives."""
