"""Data pipeline: deterministic synthetic LM streams and host loading
with background prefetch — the reference's ``repro/data/pipeline.py``,
host code copied with its imports rewritten; the prefetcher copies
batches to a torch device.

Determinism contract (fault tolerance): batch(step) is a pure function of
(seed, step, shape) — a restart from step N reproduces the exact same
stream with no state handoff, which is what makes checkpoint-restart
bit-reproducible.  The batches are the reference's arrays, bit for bit.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_kind: str = "none"
    frontend_dim: int = 0
    frontend_tokens: int = 0
    encdec: bool = False


def spec_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0) -> DataSpec:
    fe = cfg.frontend
    return DataSpec(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        frontend_kind=fe.kind if fe else "none",
        frontend_dim=fe.embed_dim if fe else 0,
        frontend_tokens=fe.num_tokens if fe else 0,
        encdec=cfg.is_encdec,
    )


def synthetic_batch(spec: DataSpec, step: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens (learnable structure, so loss curves
    actually move in the examples), plus frontend stubs where needed."""
    rng = np.random.default_rng(spec.seed * 1_000_003 + step)
    b, s = spec.global_batch, spec.seq_len
    # mixture of a few "topics": each sequence walks a narrow band of ids
    base = rng.integers(0, spec.vocab_size, size=(b, 1))
    walk = rng.integers(-32, 33, size=(b, s)).cumsum(axis=1)
    tokens = (base + np.abs(walk)) % spec.vocab_size
    tokens = tokens.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    batch = {"tokens": tokens, "labels": labels.astype(np.int32)}
    if spec.frontend_kind == "vit_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (b, spec.frontend_tokens, spec.frontend_dim), dtype=np.float32)
    if spec.encdec:
        batch["frames"] = rng.standard_normal(
            (b, s, spec.frontend_dim), dtype=np.float32)
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Background thread producing batches a few steps ahead of the
    training loop (host-side input pipeline overlap); with ``device``,
    each batch is copied there as tensors."""

    def __init__(self, spec: DataSpec, start_step: int = 0, depth: int = 2,
                 device: Optional[torch.device] = None):
        self.spec = spec
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._device = device
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = synthetic_batch(self.spec, self._step)
            if self._device is not None:
                batch = to_device(batch, self._device)
            try:
                self._q.put((self._step, batch), timeout=1.0)
            except queue.Full:
                continue
            self._step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()


def tokenize_file(path: str, vocab_size: int) -> np.ndarray:
    """Byte-level 'tokenizer' for the real-text example paths: maps file
    bytes into [0, vocab) — enough substrate to train the quickstart LM
    on actual text without external deps."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return (data.astype(np.int32) * 997) % vocab_size


def batches_from_tokens(tokens: np.ndarray, batch: int, seq: int,
                        seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        x = np.stack([tokens[s:s + seq] for s in starts])
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield {"tokens": x.astype(np.int32), "labels": y.astype(np.int32)}
