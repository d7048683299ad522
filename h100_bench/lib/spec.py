"""Finds each piece of the benchmark by the name ``BENCHMARK.json`` gives
it, so that a new cell, configuration, traffic mix or per-layer metric is
a new file and a new entry, never an edit:

- ``configs/<config>.json``: the configuration as it is run (the env, its
  make arguments, the policy, the reference module that mirrors it);
- ``traffic/<traffic>.json``: a traffic mix's parameters, with the name
  of the driver module ``traffic/<driver>.py`` that runs it;
- ``limits/<workload>.json``: each compared number's limit, with the
  readings it was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``bounds/<metric>.json``: an end-to-end metric's bound and the sets'
  spreads it was set from (read by the tests);
- ``reference/<name>.py``: a configuration's plain reference;
- ``small/<workload>.json``: the sizes the harness's CPU tests run a cell
  at, and what its per-layer metrics read there.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def read_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(root, "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return read_json(HERE, "configs", f"{_checked(name)}.json")


def traffic(name: str) -> dict:
    return read_json(HERE, "traffic", f"{_checked(name)}.json")


def limits(name: str) -> dict:
    """{number: limit} of a workload's comparison."""
    return {k: v["limit"] for k, v in
            read_json(HERE, "limits", f"{_checked(name)}.json").items()}


def small(name: str) -> dict:
    """A workload's CPU sizes: ``small`` and ``tiny`` (traffic mix
    overrides) and ``cpu_reads`` ({per-layer metric: its reading at the
    tiny size, None for none})."""
    return read_json(HERE, "small", f"{_checked(name)}.json")


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder: a
    driver or a reference as ``h100_bench.<kind>.<name>``, a metric's
    reader (whose name may hold dots) loaded from its file."""
    _checked(name)
    if kind != "metrics":
        return importlib.import_module(f"h100_bench.{kind}.{name}")
    full = f"h100_bench_metric_{name}"
    if full in sys.modules:
        return sys.modules[full]
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics that ``cell`` reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics that ``cell`` reports: those that list it,
    and those without a list whose moved metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name
