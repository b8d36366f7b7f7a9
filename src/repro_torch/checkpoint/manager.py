"""Async checkpointing on the reference's on-disk layout
(``repro/checkpoint/manager.py``), so that a checkpoint written by
either package restores in the other, leaf for leaf:

    <dir>/step_<N>/
      manifest.json    step, and per leaf its path, file, shape, dtype, crc
      shard_<i>.npz    one leaf, array ``data``

* paths are the reference's (``repro_torch/tree.py``: dict keys sorted,
  jax's key strings), one ``shard_<i>.npz`` per leaf in that order;
* sub-fp32 floats (bfloat16) are widened to float32 on disk, the true
  dtype in the manifest, and narrowed back on restore;
* a crc32 per leaf of the bytes on disk, checked on restore;
* **async** — ``save()`` copies every leaf to the host, then writes in a
  background thread (one save in flight at a time); a step is written
  to ``.tmp_step_<N>`` and renamed to ``step_<N>`` (the commit), and
  only the last ``keep`` steps stay.

A mesh's training state is saved whole: the caller gathers the global
leaves (``convert.gather_train_state``) and one rank saves them, so the
checkpoint is the one a tp = 1 run writes.  ``restore(..., specs=,
coords=)`` re-shards it onto whatever mesh the new job has: each rank
reads the global leaves and keeps its part under each leaf's spec, as
the reference's ``restore(..., shardings=)`` places them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as numpy and jax name it (``bfloat16``, ``int32``)."""
    return str(dtype).replace("torch.", "")


def _crc(a: np.ndarray) -> int:
    """CRC-32 of the array's bytes, read in place (no copy)."""
    return zlib.crc32(np.ascontiguousarray(a))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot every leaf to the host, then write asynchronously."""
        self.wait()  # one in-flight save at a time
        flat = leaves_with_paths(tree)
        host, dtypes = [], []
        for _, leaf in flat:
            dtypes.append(_dtype_name(leaf.dtype))
            t = leaf.detach().cpu()
            if t.is_floating_point() and t.element_size() < 4:
                t = t.float()
            host.append(t.numpy())
        paths = [p for p, _ in flat]

        def _write():
            tmp = os.path.join(self.directory, f".tmp_step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (p, a, dt) in enumerate(zip(paths, host, dtypes)):
                fn = f"shard_{i}.npz"
                np.savez(os.path.join(tmp, fn), data=a)
                manifest["leaves"].append({
                    "path": p, "file": fn, "shape": list(a.shape),
                    "dtype": dt,
                    "crc": _crc(a),
                })
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                verify: bool = True, specs: Any = None,
                coords: Any = None) -> Tuple[Any, int]:
        """Restore into the structure of ``template`` (a tree of tensors):
        each leaf in its template's dtype, on its template's device.
        With ``specs`` (a tree of ``runtime/partition.py::Spec`` in the
        template's structure) and ``coords`` (axis name -> (index,
        size)), the template holds this rank's shards: each global leaf
        on disk is cut to this rank's part under its spec.  Returns
        (tree, step)."""
        from repro_torch.runtime.partition import shard_leaf
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {l["path"]: l for l in manifest["leaves"]}

        out = []
        spec_leaves = (leaves(specs) if specs is not None
                       else [None] * len(leaves(template)))
        for (p, tmpl), spec in zip(leaves_with_paths(template), spec_leaves):
            meta = by_path[p]
            arr = np.load(os.path.join(d, meta["file"]))["data"]
            if verify:
                if _crc(arr) != meta["crc"]:
                    raise IOError(f"checksum mismatch for {p} at step {step}")
            if spec is not None:
                arr = shard_leaf(torch.from_numpy(arr), spec, coords).numpy()
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(f"{p}: {arr.shape} on disk, template "
                                 f"{tuple(tmpl.shape)}")
            out.append(torch.from_numpy(arr).to(device=tmpl.device,
                                                dtype=tmpl.dtype))
        return unflatten(template, out), step
