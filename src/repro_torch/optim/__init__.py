"""Optimizers of the training path (``repro/optim`` on torch)."""
