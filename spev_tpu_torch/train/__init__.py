"""Acoustic training: loss, trainer and checkpoints."""
