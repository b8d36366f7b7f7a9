"""Data pipeline of the training path (``repro/data`` on torch)."""
