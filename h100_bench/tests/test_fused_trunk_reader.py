"""CPU test of ``learner.fused_trunk_launches_per_step``, the reader of the
program's ``ppo_trunk`` launch count (``lib/program.py``): launches over
the traced pass's units, None where the program has no such wrapper (a
checkout older than it) or no traced pass.

    python -m pytest h100_bench/tests -q
"""
from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from h100_bench.lib import spec  # noqa: E402

BENCH = spec.benchmark(ROOT)
METRIC = "learner.fused_trunk_launches_per_step"


def _ctx(launches):
    return {"extras": {}, "program": {
        "units": 2, "pool_bytes": None, "profiled": None,
        "light": {"spans": [], "counters": {}, "launches": launches}}}


@pytest.mark.parametrize("launches,want", [
    ({"ppo_trunk": 3076, "ppo_gauss_loss": 768}, 1538.0),
    ({"ppo_gauss_loss": 768, "ev_policy_segment": 2}, None),
    ({}, None)])
def test_reader_counts_the_wrapper_and_none_without_it(launches, want):
    read = spec.module("metrics", METRIC).read
    assert read(_ctx(launches)) == want
    assert read({"extras": {}}) is None
    assert read({"extras": {}, "program": None}) is None


def test_entry_reads_the_train_cell():
    entry = {m["name"]: m for m in BENCH["per_layer"]}[METRIC]
    assert entry["workloads"] == ["ev-ppo-train"]
    assert entry["moves"] == "train_env_steps_per_s"
    assert entry["layer"] == "Learner (parallel/ppo.py)"
