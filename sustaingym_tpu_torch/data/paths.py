"""Packed-data path resolution.

The port reads the dense ``.npz`` packs that the JAX package ships under
``sustaingym_tpu/data/packed/``. They are data, so they are located by
file path and never through an import of ``sustaingym_tpu`` (which would
import JAX). ``SUSTAINGYM_PACKED`` overrides the directory, as it does for
the JAX package.
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PACKED_DIR = os.environ.get(
    "SUSTAINGYM_PACKED",
    os.path.join(_REPO_ROOT, "sustaingym_tpu", "data", "packed"))


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
