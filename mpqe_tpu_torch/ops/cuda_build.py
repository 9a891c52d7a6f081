"""Build the port's CUDA sources into shared libraries and load them.

Each kernel source under ``mpqe_tpu_torch/csrc/`` exposes a plain C
interface and is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library, loaded with ``ctypes``.  Libraries are built at first
use, from the sources in the checkout only, into ``mpqe_tpu_torch/_build/``
(listed in ``.gitignore``), and named by a hash of source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# one loaded library per name for the life of the process
_LOADED: Dict[str, ctypes.CDLL] = {}
# the compiler's report (``-Xptxas -v``: registers, shared memory, spills)
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``_build/lib<name>-<hash>.so``
    (unless that file exists) and load it, once per process.  Raises on
    a failed build."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        # build to a private name, then rename: a concurrent build never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = lib
    return lib


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """``NotImplementedError`` for a call in grad mode on an input that
    requires grad: the forward-only kernels (K4a, K4b, K7), like the
    reference Pallas kernels they port, have no VJP."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward only: the reference Pallas kernel has no "
            "VJP (jax.grad through it fails); call it under torch.no_grad()")
