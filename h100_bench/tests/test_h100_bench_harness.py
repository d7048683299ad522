"""CPU tests of the benchmark harness (``h100_bench/``): discovery by name,
the names' and units' characters, which cell reports which metric, the
result line, the imports, and the comparison against the program's CPU
path (the plain versions of its kernels) at each cell's small size
(``small/<cell>.json``): sound runs pass, the lower-precision control and
each planted fault fail.

    python -m pytest h100_bench/tests -q              # here, on the CPU
    python -m pytest h100_bench/tests -q -m gpu       # on the card
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from h100_bench.lib import cell, spec  # noqa: E402

BENCH = spec.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
CPU = torch.device("cpu")


def run_small(name, seed=11, faults=(), trace=False):
    return cell.run_cell(BENCH, name, seed, 0.2, trace, CPU,
                         time.perf_counter(),
                         overrides=spec.small(name)["small"],
                         faults=faults, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_discovery_by_name(name):
    w = spec.workload(BENCH, name)
    config = spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    driver = spec.module("traffic", mix["driver"])
    assert hasattr(driver, "Driver") and driver.FAULTS
    assert spec.module("reference", config["reference"]).Reference
    assert set(spec.limits(name))
    assert mix["driver"] in config["controls"]
    small = os.path.join(HERE, "small", f"{name}.json")
    assert os.path.exists(small), (
        f"cell {name} has no CPU sizes: add h100_bench/small/{name}.json "
        "with 'small' and 'tiny' overrides of its traffic mix and its "
        "'cpu_reads'")
    assert {"small", "tiny", "cpu_reads"} <= set(spec.small(name))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_readers_found(metric):
    reader = spec.module("metrics", metric)
    assert callable(reader.read)
    assert reader.read({"extras": {}}) is None     # nothing to read


def test_names_units_and_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS + [
        m["name"] for m in BENCH["end_to_end"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert spec.NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("h100_bench/")
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_what_its_metrics_move(name):
    e2e = {m["name"] for m in spec.end_to_end(BENCH, name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, name)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (name, m["name"])


def test_imports_name_neither_jax_nor_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in cell.FORBIDDEN, (f, n)


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from h100_bench.lib import cell, spec\n"
            "line = cell.run_cell(spec.benchmark(%r), 'ev-sim', 3, 0.1, False,"
            " torch.device('cpu'), time.perf_counter(),"
            " overrides=spec.small('ev-sim')['tiny'], log=lambda m: None)\n"
            "print(line['correct'], cell.forbidden_modules())\n"
            ) % (ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.split() == ["True", "[]"], out.stderr[-2000:]


def test_result_line_keys_and_checks_last():
    line = run_small("ev-sim")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {
        m["name"] for m in spec.end_to_end(BENCH, "ev-sim")}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                          "--workload", "ev-sim", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder
    gives no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "ev-sim", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_programs_cpu_path(name):
    line = run_small(name, seed=2 ** 31 + 5)
    assert line["correct"], line["checks"]


def control_against_limits(name, device, sizes, seed=7):
    """(the program's numbers, the control's) at ``sizes``, the reference
    computed at the control's lower precision standing in the program's
    place. Every driver runs as a run runs it: set-up, then a short
    ``window`` (a driver that samples its answers from the window draws
    them there; one that records them in set-up runs on past them), then
    ``release`` and the comparison."""
    w = spec.workload(BENCH, name)
    config = spec.config(w["config"])
    mix = dict(spec.traffic(w["traffic"]), **sizes)
    driver = spec.module("traffic", mix["driver"]).Driver(config, mix, seed,
                                                          device)
    driver.setup(False)
    driver.window(0.2)
    driver.release()
    numbers, _ = driver.check(spec.module("reference", config["reference"]))
    return numbers, driver.stand_in(prec=config["controls"][mix["driver"]])


def test_control_in_the_programs_place_is_not_correct():
    """On the CPU at a small size where the control shows: the PPO cell
    (the fp8 actor). The simulation tier's TF32 control shows only at the
    cell's own size (a quantised pilot that flips in a few of 65536 env
    episodes), so it is the card's test below."""
    numbers, control = control_against_limits(
        "ev-ppo-train", CPU, spec.small("ev-ppo-train")["small"])
    limits = spec.limits("ev-ppo-train")
    assert all(v <= limits[k] for k, v in numbers.items()), numbers
    assert any(v > limits[k] for k, v in control.items()), control


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    numbers, control = control_against_limits(name, torch.device("cuda"),
                                              {}, seed=2 ** 31 + 77)
    limits = spec.limits(name)
    assert all(v <= limits[k] for k, v in numbers.items()), numbers
    assert any(v > limits[k] for k, v in control.items()), control


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS
    for f in spec.module("traffic", spec.traffic(
        spec.workload(BENCH, n)["traffic"])["driver"]).FAULTS])
def test_each_fault_in_the_program_is_caught(name, fault):
    line = run_small(name, seed=21, faults=(fault,))
    assert not line["correct"], line["checks"]


def copy_of_the_benchmark(tmp_path):
    """(the copy's folder, its BENCHMARK.json as a dict): the benchmark
    copied into ``tmp_path`` beside links to the packages it reads."""
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for pkg in ("sustaingym_tpu", "sustaingym_tpu_torch"):
        os.symlink(os.path.join(ROOT, pkg), tmp_path / pkg)
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    return tmp_path / "h100_bench", bench


def run_in_copy(tmp_path, bench, name, overrides=None):
    """Runs cell ``name`` traced in the copy, in a process of its own;
    prints the result line (``null`` for none) and the forbidden modules
    loaded."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json, torch; sys.path.insert(0, %r)\n"
            "from h100_bench.lib import cell, spec\n"
            "line = cell.run_cell(spec.benchmark(%r), %r, 3, 0.1, "
            "True, torch.device('cpu'), time.perf_counter(), "
            "overrides=%r, log=lambda m: None)\n"
            "print(json.dumps(cell.forbidden_modules()))\n"
            "print(json.dumps(line))\n") % (str(tmp_path), str(tmp_path),
                                             name, overrides)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, line = out.stdout.strip().splitlines()[-2:]
    return json.loads(loaded), json.loads(line)


def test_a_module_loaded_after_the_window_withholds_the_result(tmp_path):
    """A per-layer metric's reader, read after the window and the
    comparison, that imports a module named ``sustaingym_tpu`` (a stub):
    the run gives no result line."""
    base, bench = copy_of_the_benchmark(tmp_path)
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "sustaingym_tpu.py").write_text("LOADED = True\n")
    (base / "metrics" / "dummy.loads_jax_package.py").write_text(
        "import sys\n"
        "def read(ctx):\n"
        "    sys.path.insert(0, %r)\n"
        "    import sustaingym_tpu\n"
        "    return 1.0 if sustaingym_tpu.LOADED else None\n" % str(stub))
    bench["per_layer"].append({"name": "dummy.loads_jax_package",
                               "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "sim_env_steps_per_s",
                               "workloads": ["ev-sim"]})
    loaded, line = run_in_copy(tmp_path, bench, "ev-sim",
                               spec.small("ev-sim")["tiny"])
    assert loaded == ["sustaingym_tpu"] and line is None


# a new driver: the simulation tier's episodes, each unit of the
# program's pass inside a span of the driver's own
DUMMY_DRIVER = '''"""Traffic driver dummy_episodes (a test's)."""
from sustaingym_tpu_torch.core import trace

from h100_bench.traffic import sim_episodes

FAULTS = STAND_IN_FAULTS = sim_episodes.FAULTS


class Driver(sim_episodes.Driver):
    def unit(self):
        with trace.span("dummy.unit"):
            super().unit()
'''
# its reader: the span's mean host time over the program's pass
DUMMY_READER = '''from h100_bench.lib import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.mean([s["host_ms"] for s in
                         program.spans(p["light"], "dummy.unit")])
'''


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A dummy configuration, cell, traffic mix with a new driver, limits
    file, CPU sizes and a per-layer metric that reads the driver's own
    program span, added to a copy as new files and new entries: the cell
    runs traced there and the metric reads a number, and the copy's own
    tests, parametrised by cell and metric, take the dummy with no edit."""
    base, bench = copy_of_the_benchmark(tmp_path)
    (base / "traffic" / "dummy_episodes.py").write_text(DUMMY_DRIVER)
    mix = dict(spec.traffic("sim-32768x288"), driver="dummy_episodes")
    (base / "traffic" / "dummy-32768x288.json").write_text(json.dumps(mix))
    config = spec.config("ev-caltech")
    config["controls"]["dummy_episodes"] = config["controls"]["sim_episodes"]
    (base / "configs" / "dummy-ev.json").write_text(json.dumps(config))
    (base / "limits" / "dummy-cell.json").write_text(
        (base / "limits" / "ev-sim.json").read_text())
    sizes = dict(spec.small("ev-sim"), cpu_reads={})
    (base / "small" / "dummy-cell.json").write_text(json.dumps(sizes))
    (base / "metrics" / "dummy.unit_ms.py").write_text(DUMMY_READER)
    bench["configs"].append(dict(bench["configs"][0], name="dummy-ev",
                                 file="h100_bench/configs/dummy-ev.json"))
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-ev",
                               "traffic": "dummy-32768x288", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy.unit_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["dummy-cell"]})
    loaded, line = run_in_copy(tmp_path, bench, "dummy-cell", sizes["tiny"])
    assert loaded == []
    assert line["correct"] and line["metrics"]["dummy.unit_ms"]["value"] > 0
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "h100_bench/tests", "-v",
         "-p", "no:cacheprovider", "-m", "not gpu",
         "-k", "dummy and not new_files_only"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-3000:]
    passed = {ln.split("::")[-1].split(" ")[0]
              for ln in out.stdout.splitlines() if " PASSED" in ln}
    faults = [f"test_each_fault_in_the_program_is_caught[dummy-cell-{f}]"
              for f in spec.module("traffic", "sim_episodes").FAULTS]
    assert passed >= {
        "test_discovery_by_name[dummy-cell]",
        "test_metric_readers_found[dummy.unit_ms]",
        "test_each_cell_reports_what_its_metrics_move[dummy-cell]",
        "test_reference_agrees_with_the_programs_cpu_path[dummy-cell]",
        "test_windows_run_untraced_and_the_program_pass_after[dummy-cell]",
        *faults}, out.stdout[-3000:]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_each_bound_is_the_one_its_readings_set(metric):
    """Each end-to-end bound is the one ``bounds/<metric>.json`` keeps
    with the sets' spreads it was set from, at the benchmark's
    ``run_seconds``: at least twice the widest
    (so that runs of one code never read too tight) and at most eight
    times it or 1%; PERF.md's table of end-to-end metrics gives the
    same bound."""
    bound = next(m["bound"] for m in BENCH["end_to_end"]
                 if m["name"] == metric)
    rec = spec.read_json(HERE, "bounds", f"{metric}.json")
    assert rec["bound"] == bound and rec["seconds"] == BENCH["run_seconds"]
    reporting = {w for w in CELLS if any(
        m["name"] == metric for m in spec.end_to_end(BENCH, w))}
    assert rec["sets"] and set(rec["sets"]) <= reporting
    widest = max(s["spread"] for sets in rec["sets"].values()
                 for s in sets)
    if metric != "setup_s":
        assert bound == 0.01 or 2 * widest <= bound <= 8 * widest
    rows = [line for line in open(os.path.join(ROOT, "PERF.md"))
            if line.startswith(f"| `{metric}` |")]
    assert len(rows) == 1 and f"| {bound} |" in rows[0], rows


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                          "--workload", name, "--seed", "123456789",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
