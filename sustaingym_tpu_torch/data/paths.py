"""Data path resolution: the packed ``.npz`` artifacts and the raw tables.

The port reads the dense ``.npz`` packs that the JAX package ships under
``sustaingym_tpu/data/packed/``. They are data, so they are located by
file path and never through an import of ``sustaingym_tpu`` (which would
import JAX). ``SUSTAINGYM_PACKED`` overrides the directory, as it does for
the JAX package. A pack that is absent is built by the port's ETL
(``data/ev_etl.py``, ``data/cogen_etl.py``) from the raw inputs and
written there, under the JAX package's file name.

The raw SustainGym tables (ASHRAE HTM building tables, TMY3 EPW weather,
MOER monthly CSVs, ACN session CSVs, ERCOT and Henry Hub price files, NREL
wind) are read from the first existing raw-data root: ``SUSTAINGYM_RAW``,
then ``sustaingym_tpu/data/raw`` (by path). Unlike
``sustaingym_tpu.data.paths`` it looks in no fixed checkout of the
reference distribution: point ``SUSTAINGYM_RAW`` at that checkout's data
directory (the layout ``building/``, ``moer/``, ``cogen/``,
``evcharging/``).
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
    """Path of a pack under ``PACKED_DIR``, which it creates: where the
    ETL looks for a cached pack and writes a new one (the JAX package's
    ``packed_path``)."""
    os.makedirs(PACKED_DIR, exist_ok=True)
    return os.path.join(PACKED_DIR, *parts)


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


def raw_inputs(pack: str, *files: str) -> list[str]:
    """The paths of the raw ``files`` (relative to the raw-data root) that
    the ETL reads to build ``pack``. Without a raw-data root it raises
    FileNotFoundError naming the pack and every one of those files."""
    try:
        root = raw_root()
    except FileNotFoundError:
        raise FileNotFoundError(
            f"packed data file {os.path.join(PACKED_DIR, pack)} not found, "
            f"and the raw ETL inputs that build it are absent: "
            f"{', '.join(files)}. Set SUSTAINGYM_RAW to a directory with "
            f"the reference data layout (building/, moer/, cogen/, "
            f"evcharging/) holding them.") from None
    return [os.path.join(root, f) for f in files]
