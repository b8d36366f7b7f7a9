"""Build a CUDA source of ``csrc/`` into a shared library at first use.

Each kernel module compiles its own source with ``nvcc`` for ``sm_90a``
into ``build/kernels/`` at the repository root (listed in .gitignore)
and loads it with ``ctypes``.  The file name carries a hash of the
source, the headers of ``csrc/`` and the flags, so an edited source or
header never loads a stale build.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build output at the repository root (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(source: Path, flags: Sequence[str] = ()) -> Tuple[Path, str]:
    """Compile ``source`` with ``BASE_FLAGS + flags`` unless this source
    and these flags have been built already.

    Returns (library path, compiler log: ``-Xptxas -v`` lists each
    kernel's registers, shared memory and spills)."""
    flags = (*BASE_FLAGS, *flags)
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stderr
