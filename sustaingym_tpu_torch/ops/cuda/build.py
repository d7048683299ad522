"""Builds the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, cached under ``_build/`` (listed in ``.gitignore``) by
the hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
and is loaded with ``ctypes``. The sources include no PyTorch headers, so
a build takes seconds, not minutes; ``load_libraries`` runs one ``nvcc``
per source, all at once.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a``, and deliberately no
``--use_fast_math``: the parity with the plain PyTorch versions relies on
IEEE ``tanhf``, ``sqrtf``, ``powf``, division and ``rintf``.
``cogen_rollout`` and ``dc_rollout`` also build with ``-fmad=false``, so
their float32 arithmetic rounds after every operation as their plain
versions' does; ``building_rollout`` rounds its env step with ``__fmul_rn``
/ ``__fadd_rn`` intrinsics instead and keeps the FMAs of its actor MLP.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["load_library", "load_libraries", "nvcc_path", "CUDA_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
_EXTRA_FLAGS = {"cogen_rollout": ("-fmad=false",),
                "dc_rollout": ("-fmad=false",)}

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


def _flags(name: str) -> tuple[str, ...]:
    return CUDA_FLAGS + _EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> str:
    """The cached library of ``name``, keyed by source, headers and
    flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def load_libraries(names, verbose: bool = False) -> dict[str, ctypes.CDLL]:
    """Compiles every ``csrc/<name>.cu`` of ``names`` that has no cached
    library, one ``nvcc`` process per source started together, and loads
    them. ``verbose`` adds ``-Xptxas=-v`` and prints the compiler's report
    of registers, shared memory and spills."""
    todo = [name for name in names if name not in _LOADED]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    try:
        for name in todo:
            lib_path = _lib_path(name)
            if os.path.exists(lib_path):
                continue
            # compile to a temporary name, then rename: a concurrent process
            # never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *_flags(name),
                   *(["-Xptxas=-v"] if verbose else []), "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            jobs.append((name, lib_path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for name, lib_path, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name}.cu:\n{out}\n"
                                   f"{err}")
            if verbose:
                print(f"{name}.cu:\n{out}{err}", flush=True)
            os.replace(tmp, lib_path)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    for name in todo:
        _LOADED[name] = ctypes.CDLL(_lib_path(name))
    return {name: _LOADED[name] for name in names}


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Compiles ``csrc/<name>.cu`` (once per source hash) and loads it."""
    return load_libraries([name], verbose)[name]
