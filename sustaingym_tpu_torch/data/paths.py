"""Data path resolution: the packed ``.npz`` artifacts and the raw tables.

The port reads the dense ``.npz`` packs that the JAX package ships under
``sustaingym_tpu/data/packed/``. They are data, so they are located by
file path and never through an import of ``sustaingym_tpu`` (which would
import JAX). ``SUSTAINGYM_PACKED`` overrides the directory, as it does for
the JAX package.

The raw SustainGym tables (ASHRAE HTM building tables, TMY3 EPW weather)
are read from the first existing raw-data root: ``SUSTAINGYM_RAW``, then
``sustaingym_tpu/data/raw`` (by path). Unlike ``sustaingym_tpu.data.paths``
it looks in no fixed checkout of the reference distribution: point
``SUSTAINGYM_RAW`` at that checkout's data directory.
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PACKED_DIR = os.environ.get(
    "SUSTAINGYM_PACKED",
    os.path.join(_REPO_ROOT, "sustaingym_tpu", "data", "packed"))

_DEFAULT_RAW_CANDIDATES = (
    os.environ.get("SUSTAINGYM_RAW", ""),
    os.path.join(_REPO_ROOT, "sustaingym_tpu", "data", "raw"),
)


def packed_path(*parts: str) -> str:
    """Path of a packed artifact; raises if it does not exist (the port
    has no raw-data ETL to build it)."""
    path = os.path.join(PACKED_DIR, *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"packed data file {path} not found. The PyTorch port reads the "
            f"packs shipped in sustaingym_tpu/data/packed/ (or the directory "
            f"named by SUSTAINGYM_PACKED) and cannot build them from raw "
            f"data; build them with the JAX package's data.ev_etl first.")
    return path


def raw_root() -> str:
    """Returns the first existing raw-data root."""
    for cand in _DEFAULT_RAW_CANDIDATES:
        if cand and os.path.isdir(cand):
            return cand
    raise FileNotFoundError(
        "No raw SustainGym data directory found. Set SUSTAINGYM_RAW to a "
        "directory with the reference data layout (building/, moer/, ...).")


def raw_path(*parts: str) -> str:
    return os.path.join(raw_root(), *parts)
