"""``train.py --profile`` of the port: a torch.profiler Chrome trace of
iterations 2-4 of the run (after the first train step), clamped into the
run, in ``<log-dir>/profile/trace_rank0.json``; the JAX CLI's span
(sustaingym_tpu/train.py:296-309). The program's trace recording over the
same iterations: its spans in the trace, its snapshot in
``spans_rank0.json``."""
import json

from sustaingym_tpu_torch import train

ARGS = ["--env", "cogen", "--device", "cpu", "--num-envs", "8",
        "--hidden", "16", "--minibatches", "2", "--epochs", "1",
        "--rollout-len", "8", "--save-every", "2"]


def _iterations(path) -> list[str]:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("ph") == "X" for e in events)
    return sorted({e["name"] for e in events
                   if str(e.get("name", "")).startswith("iteration ")})


def test_profile_traces_iterations_1_and_2(tmp_path, capsys):
    """The trace holds the program's spans as ranges, and their snapshot
    is written beside it: the two traced iterations' train steps."""
    train.main(ARGS + ["--profile", "--iterations", "3",
                       "--log-dir", str(tmp_path)])
    path = tmp_path / "profile" / "trace_rank0.json"
    assert _iterations(path) == ["iteration 1", "iteration 2"]
    assert "profiler trace of iterations 1-2" in capsys.readouterr().out
    rows = (tmp_path / "train_results.csv").read_text().splitlines()
    assert len(rows) == 4
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = {e.get("name") for e in events}
    assert {"ppo.step", "ppo.rollout", "ppo.score", "ppo.update"} <= names
    with open(tmp_path / "profile" / "spans_rank0.json") as f:
        snap = json.load(f)
    steps = [s for s in snap["spans"] if s["name"] == "ppo.step"]
    assert [s["step"] for s in steps] == [0, 1]
    assert {"spans", "counters", "launches"} == set(snap)


def test_profile_skips_a_one_iteration_run(tmp_path, capsys):
    train.main(ARGS + ["--profile", "--iterations", "1",
                       "--log-dir", str(tmp_path)])
    assert "profiler: skipped (needs --iterations >= 2)" in \
        capsys.readouterr().out
    assert not (tmp_path / "profile").exists()


def test_profile_span_clamps_into_a_restored_run(tmp_path, capsys):
    """A run restored at iteration 2 for 2 iterations (2 and 3) traces
    iteration 3 alone: the span starts one past the restored iteration
    and stops at the run's last."""
    train.main(ARGS + ["--iterations", "2", "--log-dir", str(tmp_path)])
    log = tmp_path / "resumed"
    train.main(ARGS + ["--profile", "--iterations", "2", "--log-dir",
                       str(log), "--restore", str(tmp_path / "checkpoints")])
    assert _iterations(log / "profile" / "trace_rank0.json") == \
        ["iteration 3"]
    assert "profiler trace of iterations 3-3" in capsys.readouterr().out
