"""The port's examples (``python -m sustaingym_tpu_torch.examples.<name>``)
on the CPU at small sizes, and the EV plot helpers
(sustaingym_tpu_torch.envs.evcharging.plot_utils) over the CSVs they
write, drawn with matplotlib's Agg backend."""
import math

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from sustaingym_tpu.envs.evcharging import plot_utils as jplot  # noqa: E402
from sustaingym_tpu_torch.envs.evcharging import plot_utils  # noqa: E402
from sustaingym_tpu_torch.examples import (run_baselines,  # noqa: E402
                                           train_multiagent_cogen,
                                           train_ppo, validate_envs)

SMALL = ["--device", "cpu", "--num-envs", "8", "--hidden", "16",
         "--minibatches", "2", "--epochs", "1", "--rollout-len", "8"]


@pytest.fixture(scope="module")
def train_log(tmp_path_factory):
    log = tmp_path_factory.mktemp("train_ppo")
    train_ppo.main(["--env", "cogen", *SMALL, "--iterations", "2",
                    "--log-dir", str(log)])
    return str(log)


def test_train_ppo(train_log):
    df = plot_utils.read_train_log(train_log)
    assert list(df["iteration"]) == [0, 1]
    assert np.isfinite(df["mean_reward"]).all()


def test_train_multiagent_cogen(tmp_path, capsys):
    train_multiagent_cogen.main([*SMALL, "--iterations", "2",
                                 "--log-dir", str(tmp_path)])
    df = plot_utils.read_train_log(str(tmp_path))
    assert len(df) == 2 and np.isfinite(df["mean_reward"]).all()
    assert "iter 1:" in capsys.readouterr().out


def test_validate_envs(tmp_path):
    stats = validate_envs.main(
        ["--device", "cpu", "--batch", "4", "--plots", "--out-dir",
         str(tmp_path / "png"), "--building-tables", str(tmp_path / "t")])
    assert [s["env"] for s in stats] == sorted(validate_envs.EPISODE_LEN)
    for s in stats:
        assert s["episodes"] == 4 and math.isfinite(s["return_mean"])
        assert (tmp_path / "png" / f"{s['env']}.png").stat().st_size > 0


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("results")
    run_baselines.main(["--device", "cpu", "--algorithms", "greedy",
                        "random", "--num-seeds", "2", "--results-dir",
                        str(out)])
    return str(out)


def test_run_baselines_csvs(results, capsys):
    for algo in ("greedy", "random"):
        df = plot_utils.read_baseline("caltech", "Summer 2021", algo,
                                      results)
        assert list(df["seed"]) == [0, 1]
        assert np.isfinite(df["return"]).all()
        for col in plot_utils.BREAKDOWN_COLS:
            assert col in df.columns


def test_run_baselines_building(tmp_path):
    run_baselines.main(["--env", "building", "--device", "cpu",
                        "--algorithms", "random", "--num-seeds", "1",
                        "--results-dir", str(tmp_path),
                        "--building-tables", str(tmp_path / "tables")])
    df = plot_utils.read_baseline("OfficeSmall", "hot_dry", "random",
                                  str(tmp_path))
    assert len(df) == 1 and np.isfinite(df["return"]).all()


def test_plot_returns_and_breakdown(results):
    ax = plot_utils.plot_returns("caltech", "Summer 2021",
                                 ["greedy", "random"], results)
    assert [t.get_text() for t in ax.get_xticklabels()] == ["greedy",
                                                            "random"]
    plt.close(ax.figure)
    ax = plot_utils.plot_reward_breakdown("caltech", "Summer 2021",
                                          ["greedy", "random"], results)
    assert len(ax.patches) == 2 * len(plot_utils.BREAKDOWN_COLS)
    plt.close(ax.figure)


def test_plot_train_curves_default_metric(train_log):
    """The default draws ``mean_reward`` of the port's train_results.csv.
    The JAX helper's default ``mean_return`` is no column of that CSV, so
    its default call draws no line: the divergence pinned."""
    ax = plot_utils.plot_train_curves({"ppo": train_log})
    (line,) = ax.lines
    df = plot_utils.read_train_log(train_log)
    np.testing.assert_array_equal(line.get_ydata(), df["mean_reward"])
    plt.close(ax.figure)
    ax = jplot.plot_train_curves({"ppo": train_log})
    assert len(ax.lines) == 0
    plt.close(ax.figure)
    with pytest.raises(KeyError, match="mean_return"):
        plot_utils.plot_train_curves({"ppo": train_log},
                                     metric="mean_return")
