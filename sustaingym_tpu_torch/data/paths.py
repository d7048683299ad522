"""Data path resolution: the packed ``.npz`` artifacts and the raw tables.

Packs live in two directories, each with one job:

- The port's pack directory, ``PACKED_DIR``: ``sustaingym_tpu_torch/data/
  packed/``, or ``SUSTAINGYM_PACKED`` where that is set (as it is for the
  JAX package). The port's ETL (``data/ev_etl.py``, ``data/cogen_etl.py``)
  writes a pack it builds here, under the JAX package's file name, and
  ``data/ev_gmm.export_gmm_npz`` writes its exports under ``gmm/`` here.
  The directory is created by the first write, never by a read; git
  ignores it.
- The packs the JAX package commits, ``COMMITTED_DIR``
  (``sustaingym_tpu/data/packed/``). The port only reads them, located by
  file path and never through an import of ``sustaingym_tpu`` (which
  would import JAX).

:func:`find_pack` looks in ``PACKED_DIR`` first, then in
``COMMITTED_DIR``. :func:`pack_out_path` gives where a pack is written: in
``PACKED_DIR`` always, and never under ``sustaingym_tpu/``, so that the
reference never reads what the port built.

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
_JAX_TREE = os.path.join(_REPO_ROOT, "sustaingym_tpu")

PACKED_DIR = os.environ.get(
    "SUSTAINGYM_PACKED", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "packed"))
COMMITTED_DIR = os.path.join(_JAX_TREE, "data", "packed")

_DEFAULT_RAW_CANDIDATES = (
    os.environ.get("SUSTAINGYM_RAW", ""),
    os.path.join(_JAX_TREE, "data", "raw"),
)


def pack_places(*parts: str) -> list[str]:
    """Every path :func:`find_pack` tries for the pack ``parts``, in
    order."""
    return [os.path.join(d, *parts) for d in (PACKED_DIR, COMMITTED_DIR)]


def find_pack(*parts: str) -> str | None:
    """Path of the pack ``parts`` (a file name, or a subdirectory and a
    file name): in ``PACKED_DIR``, else in ``COMMITTED_DIR``; None where
    neither holds it. Creates nothing."""
    for path in pack_places(*parts):
        if os.path.exists(path):
            return path
    return None


def pack_out_path(*parts: str) -> str:
    """Path to write the pack ``parts`` to, in ``PACKED_DIR``, whose
    directories it creates. Raises ValueError where that path resolves to
    anywhere under ``sustaingym_tpu/``, the reference's tree."""
    path = os.path.join(PACKED_DIR, *parts)
    jax_tree = os.path.realpath(_JAX_TREE)
    real = os.path.realpath(path)
    if os.path.commonpath((real, jax_tree)) == jax_tree:
        raise ValueError(
            f"refusing to write the pack {path}: it lies under the JAX "
            f"package's tree {jax_tree}, which the port only reads. Point "
            f"SUSTAINGYM_PACKED elsewhere.")
    os.makedirs(os.path.dirname(path), exist_ok=True)
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


def raw_inputs(pack: str, *files: str) -> list[str]:
    """The paths of the raw ``files`` (relative to the raw-data root) that
    the ETL reads to build ``pack``. Without a raw-data root it raises
    FileNotFoundError naming every place the pack was looked for and
    every one of those files."""
    try:
        root = raw_root()
    except FileNotFoundError:
        raise FileNotFoundError(
            f"packed data file {pack} not found in "
            f"{' or '.join(pack_places(pack))}, and the raw ETL inputs "
            f"that build it are absent: {', '.join(files)}. Set "
            f"SUSTAINGYM_RAW to a directory with the reference data layout "
            f"(building/, moer/, cogen/, evcharging/) holding them.") \
            from None
    return [os.path.join(root, f) for f in files]
