"""Checkpoints of the training path (``repro/checkpoint`` on torch)."""
