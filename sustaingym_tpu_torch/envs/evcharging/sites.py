"""EV charging-network site specifications (caltech / jpl).

A NumPy copy of ``sustaingym_tpu.envs.evcharging.sites`` (the port may not
import the JAX package). See that module for the provenance of every
constant: station ids are exact, the three-phase topology follows the
published ACN-Sim site structure, and the feeder/transformer limits are a
reconstruction that an extracted ``{site}_acn.json`` replaces.

Two EVSE families: AeroVironment (AV) pilots {0, 8, 16, 24, 32} (min pilot
8); ClipperCreek (CC) pilots {0} U {6..32} (min pilot 6).
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

PHASE_AB, PHASE_BC, PHASE_CA = 30.0, -90.0, 150.0

# extracted-constants JSONs live beside the JAX package's site module; they
# are data, read by path
_JAX_SITE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "sustaingym_tpu", "envs", "evcharging")
TURNS_RATIO = 120.0 / 277.0  # 208Y/120 secondary -> 480D/277 primary


class SiteSpec(NamedTuple):
    name: str
    station_ids: tuple[str, ...]
    phase_angles: np.ndarray      # (n,) degrees
    constraint_matrix: np.ndarray  # (m, n) real coefficients
    magnitudes: np.ndarray        # (m,) amps
    constraint_names: tuple[str, ...]
    min_pilots: np.ndarray        # (n,) 6 (CC) or 8 (AV)

    @property
    def num_stations(self) -> int:
        return len(self.station_ids)


_CALTECH_IDS = tuple(
    f"CA-{i}" for i in (148, 149, 212, 213, *range(303, 328),
                        *range(489, 514)))
_JPL_IDS = tuple(
    [f"AG-1F{i:02d}" for i in range(1, 15)]
    + [f"AG-3F{i:02d}" for i in range(15, 34)]
    + [f"AG-4F{i:02d}" for i in range(34, 53)])


def _three_phase_constraints(phases: np.ndarray, n: int,
                             transformer_kva: float
                             ) -> tuple[list[np.ndarray], list[float], list[str]]:
    """Secondary/primary per-phase line constraints from EVSE line
    assignments. Line currents combine as I_A = I_AB - I_CA,
    I_B = I_BC - I_AB, I_C = I_CA - I_BC."""
    on = {p: (phases == p) for p in (PHASE_AB, PHASE_BC, PHASE_CA)}
    rows, mags, names = [], [], []
    combos = [("A", PHASE_AB, PHASE_CA), ("B", PHASE_BC, PHASE_AB),
              ("C", PHASE_CA, PHASE_BC)]
    secondary_limit = transformer_kva * 1000.0 / 3.0 / 120.0
    primary_limit = transformer_kva * 1000.0 / 3.0 / 277.0
    for label, plus, minus in combos:
        row = np.zeros(n)
        row[on[plus]] = 1.0
        row[on[minus]] = -1.0
        rows.append(row)
        mags.append(secondary_limit)
        names.append(f"Secondary {label}")
    for label, plus, minus in combos:
        row = np.zeros(n)
        row[on[plus]] = TURNS_RATIO
        row[on[minus]] = -TURNS_RATIO
        rows.append(row)
        mags.append(primary_limit)
        names.append(f"Primary {label}")
    return rows, mags, names


def caltech_site() -> SiteSpec:
    ids = _CALTECH_IDS
    n = len(ids)
    phases = np.empty(n)
    min_pilots = np.full(n, 8.0)

    cc_pod = [ids.index(f"CA-{i}") for i in range(489, 497)]   # 8 ClipperCreek
    av_pod = [ids.index(f"CA-{i}") for i in range(497, 505)]   # 8 AeroVironment
    rest = [i for i in range(n) if i not in cc_pod + av_pod]

    phases[cc_pod] = PHASE_AB
    phases[av_pod] = PHASE_BC
    for k, i in enumerate(rest):
        phases[i] = (PHASE_AB, PHASE_BC, PHASE_CA)[k % 3]
    min_pilots[cc_pod] = 6.0

    rows, mags, names = [], [], []
    row = np.zeros(n); row[cc_pod] = 1.0
    rows.append(row); mags.append(80.0); names.append("CC Pod")
    row = np.zeros(n); row[av_pod] = 1.0
    rows.append(row); mags.append(160.0); names.append("AV Pod")
    r2, m2, n2 = _three_phase_constraints(phases, n, transformer_kva=150.0)
    rows += r2; mags += m2; names += n2

    return SiteSpec("caltech", ids, phases, np.asarray(rows),
                    np.asarray(mags), tuple(names), min_pilots)


def jpl_site() -> SiteSpec:
    ids = _JPL_IDS
    n = len(ids)
    phases = np.empty(n)
    min_pilots = np.full(n, 8.0)

    banks = {
        "1F": [i for i, s in enumerate(ids) if s.startswith("AG-1F")],
        "3F": [i for i, s in enumerate(ids) if s.startswith("AG-3F")],
        "4F": [i for i, s in enumerate(ids) if s.startswith("AG-4F")],
    }
    for bank, phase in zip(banks.values(), (PHASE_AB, PHASE_BC, PHASE_CA)):
        phases[bank] = phase
    min_pilots[banks["1F"]] = 6.0  # ClipperCreek bank

    rows, mags, names = [], [], []
    for label, idx in banks.items():
        row = np.zeros(n); row[idx] = 1.0
        rows.append(row)
        mags.append(np.ceil(len(idx) * 32 * 0.6))  # bank feeder limit
        names.append(f"Bank {label}")
    r2, m2, n2 = _three_phase_constraints(phases, n, transformer_kva=200.0)
    rows += r2; mags += m2; names += n2

    return SiteSpec("jpl", ids, phases, np.asarray(rows),
                    np.asarray(mags), tuple(names), min_pilots)


def load_site(site: str, json_path: str | None = None) -> SiteSpec:
    """Returns a site spec, preferring an extracted-constants JSON
    (the JAX package's extraction tool writes it) over the built-in reconstruction.
    ``json_path`` overrides the default package-dir location (tests)."""
    if json_path is None:
        json_path = os.path.join(_JAX_SITE_DIR, f"{site}_acn.json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            d = json.load(f)
        return SiteSpec(
            site, tuple(d["station_ids"]), np.asarray(d["phase_angles"]),
            np.asarray(d["constraint_matrix"]), np.asarray(d["magnitudes"]),
            tuple(d.get("constraint_names", [])),
            np.asarray(d["min_pilots"]))
    if site == "caltech":
        return caltech_site()
    if site == "jpl":
        return jpl_site()
    raise KeyError(f"unknown site {site!r}")
