"""Builds the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, cached under ``_build/`` (listed in ``.gitignore``) by the hash
of the source and flags, and is loaded with ``ctypes``. The sources include
no PyTorch headers, so a build takes seconds, not minutes.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a``, and deliberately no
``--use_fast_math``: the parity with the plain PyTorch versions relies on
IEEE ``tanhf``, ``sqrtf``, division and ``rintf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["load_library", "nvcc_path", "CUDA_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Compiles ``csrc/<name>.cu`` (once per source hash) and loads it.
    ``verbose`` adds ``-Xptxas=-v`` and prints the compiler's report of
    registers, shared memory and spills."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CUDA_FLAGS).encode()
                                ).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(lib_path):
        cmd = [nvcc_path(), *CUDA_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o"]
        # compile to a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(cmd + [tmp, src], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src}:\n{proc.stdout}\n"
                    f"{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr, flush=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(lib_path)
    _LOADED[name] = lib
    return lib
