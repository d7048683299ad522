"""CPU tests of the per-layer metrics that read the program's own spans
and counters (``lib/program.py``): each reader's number from a fixture
``ctx``, None where the run has no ``program``; each cell's untraced
window and its driver's profiled window run with tracing off, and the
program's pass inside the driver's ``traced()`` after its profiled
window, while a program without a tracer gives None and no error.

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
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")


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


@pytest.mark.parametrize("name", CELLS)
def test_windows_run_untraced_and_the_program_pass_after(name, monkeypatch):
    """The driver's measured window and its profiled window see tracing
    off; the program's pass runs inside ``traced()`` after that profiled
    window, over the mix's count of units, and the traced line reads what
    the cell's ``small/<cell>.json`` says the CPU path reads (None: no
    number off a card)."""
    import torch.profiler
    from sustaingym_tpu_torch.core import trace
    sizes = spec.small(name)
    mix = dict(spec.traffic(spec.workload(BENCH, name)["traffic"]),
               **sizes["tiny"])
    Driver = spec.module("traffic", mix["driver"]).Driver
    seen, passes = [], []

    def wrap(owner, attr, out=None):
        real = getattr(owner, attr)

        def called(*args, **kwargs):
            seen.append((attr, trace.active()))
            got = real(*args, **kwargs)
            seen.append(("/" + attr, None))
            if out is not None:
                out.append(got)
            return got
        monkeypatch.setattr(owner, attr, called)
    for method in ("window", "traced"):
        wrap(Driver, method)
    wrap(program, "run", passes)
    wrap(torch.profiler, "profile")
    for traced in (False, True):
        line = cell.run_cell(BENCH, name, 2 ** 31 + 3, 0.1, traced, CPU,
                             time.perf_counter(), overrides=sizes["tiny"],
                             log=lambda m: None)
    calls = [tag for tag, _ in seen if tag != "/profile"]
    assert calls == ["window", "/window", "traced", "profile", "run",
                     "profile", "/run", "/traced"], calls
    assert all(rec is None for _, rec in seen), seen
    assert passes[0]["units"] == mix[Driver.UNITS]
    for metric, want in sizes["cpu_reads"].items():
        if want is None:
            assert metric not in line["metrics"], metric
        else:
            assert line["metrics"][metric]["value"] == want, metric


@pytest.fixture
def no_tracer(monkeypatch):
    """The program as a checkout without ``core/trace.py`` has it."""
    import sustaingym_tpu_torch.core as core
    from sustaingym_tpu_torch.core import trace  # noqa: F401
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "sustaingym_tpu_torch.core.trace",
                        None)


def test_a_driver_without_the_tracer_gives_no_program(no_tracer):
    """A driver whose program has no tracer: its pass is None, so its
    traced run returns ``"program": None``, and every reader of the
    program's pass returns None."""

    class Stub:
        UNITS, mix, device, graphs = "n", {"n": 2}, CPU, None

        def unit(self):
            raise AssertionError("a unit ran without a tracer")
    assert program.run(Stub()) is None
    readers = [spec.module("metrics", m["name"]) for m in BENCH["per_layer"]]
    readers = [r for r in readers if getattr(r, "program", None) is program]
    assert readers
    for reader in readers:
        assert reader.read({"extras": {}, "program": None}) is None


def test_a_program_without_the_tracer_gives_none(no_tracer):
    line = cell.run_cell(BENCH, "ev-sim", 5, 0.1, True, CPU,
                         time.perf_counter(),
                         overrides=spec.small("ev-sim")["tiny"],
                         log=lambda m: None)
    assert line["correct"]
    assert not set(line["metrics"]) & {"sim.host_syncs_per_episode",
                                       "sim.prelaunch_ms"}
    assert program.of({"extras": {}}) is None
