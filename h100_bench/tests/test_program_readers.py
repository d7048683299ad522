"""CPU tests of the per-layer metrics that read the program's own spans
and counters (``lib/program.py``): each reader's number from a fixture
``ctx``, None where the run has no ``program``; the cells' own traced
window and untraced window run with tracing off, and the program's pass
after them, while a program without a tracer gives None and no error.

    python -m pytest h100_bench/tests -q
"""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from h100_bench.lib import cell, program, spec  # noqa: E402

BENCH = spec.benchmark(ROOT)
CPU = torch.device("cpu")
TINY = {"ev-ppo-train": dict(num_envs=8, minibatches=2, epochs=1,
                             check_steps=1, trace_steps=1),
        "ev-sim": dict(batch=8, check_episodes=1, trace_episodes=1)}


def _span(name, parent, host_ms, device_ms=None):
    return {"name": name, "parent": parent, "step": 0, "tag": None,
            "t0_ns": 0, "t1_ns": 1, "host_ms": host_ms,
            "self_ms": host_ms, "device_ms": device_ms}


def _snap(spans, counters):
    return {"spans": spans, "counters": counters, "launches": {}}


@pytest.fixture
def ctx():
    """A run's ``ctx`` holding the program's pass of two units."""
    light = _snap(
        [_span("ppo.step", None, 520.0, 530.0),
         _span("ppo.update", 0, 470.0, 480.0),
         _span("ppo.update", None, 900.0, 910.0),    # outside a step
         _span("ppo.step", None, 540.0, 550.0),
         _span("ppo.update", 3, 490.0, 500.0),
         _span("ev.fused_rollout", None, 11.0, 10.5),
         _span("ev.prelaunch", 5, 0.2),
         _span("ev.prelaunch", 5, 0.4)],
        {"graphs.replays.update": 768, "graphs.replays.score": 2,
         "host_syncs.kernel_seed": 2, "host_syncs.ev_days_min": 2,
         "host_syncs.ev_days_max": 2})
    profiled = _snap([], {"graphs.replays.update": 384,
                          "graphs.replays.score": 1})
    return {"extras": {}, "program": {
        "units": 2, "light": light, "pool_bytes": 3 * 2 ** 29,
        "profiled": {"units": 1, "snapshot": profiled,
                     "graph_launches": 385,
                     "idle_ms": {"ppo.update": [17.0],
                                 "ppo.step": [40.0]}}}}


WANT = {"learner.update_device_ms": 490.0,
        "learner.update_enqueue_ms": 480.0,
        "learner.update_idle_ms": 17.0,
        "graphs.replays_per_step": 385.0,
        "learner.host_syncs_per_step": 3.0,
        "graphs.pool_gib": 1.5,
        "sim.host_syncs_per_episode": 3.0,
        "sim.prelaunch_ms": 0.3}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_gives_its_number_and_none_without_the_program(metric, ctx):
    reader = spec.module("metrics", metric)
    assert reader.read(ctx) == pytest.approx(WANT[metric])
    assert reader.read({"extras": {}}) is None
    assert reader.read({"extras": {}, "program": None}) is None


def test_idle_is_withheld_where_the_profiler_lost_graph_launches(ctx):
    reader = spec.module("metrics", "learner.update_idle_ms")
    ctx["program"]["profiled"]["graph_launches"] = 384
    assert reader.read(ctx) is None


def test_each_new_reader_has_its_entry():
    names = {m["name"]: m for m in BENCH["per_layer"]}
    for metric in WANT:
        m = names[metric]
        assert m["workloads"] == (["ev-sim"] if metric.startswith("sim.")
                                  else ["ev-ppo-train"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_windows_run_untraced_and_the_program_pass_after(name, monkeypatch):
    """The driver's traced pass and its measured window see tracing off;
    the program's pass comes after them and reads the counters the CPU
    path has (one kernel seed read a step or an episode: the range check
    is the card's)."""
    from sustaingym_tpu_torch.core import trace
    mix = spec.traffic(spec.workload(BENCH, name)["traffic"])
    Driver = spec.module("traffic", mix["driver"]).Driver
    seen = []
    for method in ("window", "traced"):
        real = getattr(Driver, method)

        def checked(self, seconds, real=real, method=method):
            seen.append((method, trace.active()))
            return real(self, seconds)
        monkeypatch.setattr(Driver, method, checked)
    for traced in (False, True):
        line = cell.run_cell(BENCH, name, 2 ** 31 + 3, 0.1, traced, CPU,
                             time.perf_counter(), overrides=TINY[name],
                             log=lambda m: None)
    assert seen == [("window", None), ("traced", None)]
    syncs = ("sim.host_syncs_per_episode" if name == "ev-sim"
             else "learner.host_syncs_per_step")
    assert line["metrics"][syncs]["value"] == 1.0
    # CPU runs give no device number
    assert "learner.update_idle_ms" not in line["metrics"]
    assert "learner.update_device_ms" not in line["metrics"]


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    import sustaingym_tpu_torch.core as core
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "sustaingym_tpu_torch.core.trace",
                        None)
    line = cell.run_cell(BENCH, "ev-sim", 5, 0.1, True, CPU,
                         time.perf_counter(), overrides=TINY["ev-sim"],
                         log=lambda m: None)
    assert line["correct"]
    assert not set(line["metrics"]) & {"sim.host_syncs_per_episode",
                                       "sim.prelaunch_ms"}
    assert program.of({"extras": {}}) is None
