"""Plotting and reporting helpers over the port's run CSVs: the port of
``sustaingym_tpu.envs.evcharging.plot_utils``.

Mirrors the reference's EV plot utilities (its
``sustaingym/envs/evcharging/plot_utils.py:15-45``): CSV readers keyed by
(site, period, algorithm), per-period return plots, and reward-breakdown
summaries, over the CSVs this package writes:
``python -m sustaingym_tpu_torch.examples.run_baselines``'s
``results/<site>/<period>/<algorithm>.csv`` and ``train.py``'s
``<log-dir>/train_results.csv``.

pandas is imported with the module, as in the JAX package; matplotlib and
seaborn inside the functions that draw, so headless or eval-only installs
never pay for them. No package module imports this one.

Divergence from the JAX module: its ``plot_train_curves`` defaults to a
``mean_return`` column that ``train_results.csv`` does not have and skips
a run that lacks the metric, so its default call draws an empty plot.
Here the default is ``mean_reward`` (the column ``train.py`` writes), and
a run without the metric raises KeyError naming its columns.
"""
from __future__ import annotations

import os

import pandas as pd

__all__ = ["read_baseline", "read_train_log", "plot_returns",
           "plot_reward_breakdown", "plot_train_curves"]

DEFAULT_RESULTS_DIR = "results"

# reward-breakdown columns produced by the EV env's info dict
# (mirroring info['reward_breakdown'], reference env.py:160-165)
BREAKDOWN_COLS = ("profit", "carbon_cost", "excess_charge")


def _baseline_path(results_dir: str, site: str, period: str,
                   algorithm: str) -> str:
    period_slug = period.replace(" ", "_").lower()
    return os.path.join(results_dir, site, period_slug, f"{algorithm}.csv")


def read_baseline(site: str, period: str, algorithm: str,
                  results_dir: str = DEFAULT_RESULTS_DIR) -> pd.DataFrame:
    """Reads one baseline run CSV (columns: seed, return, info...)."""
    return pd.read_csv(_baseline_path(results_dir, site, period, algorithm))


def read_train_log(log_dir: str) -> pd.DataFrame:
    """Reads a ``train.py`` metrics CSV (one row per train step)."""
    return pd.read_csv(os.path.join(log_dir, "train_results.csv"))


def plot_returns(site: str, period: str, algorithms: list[str],
                 results_dir: str = DEFAULT_RESULTS_DIR, ax=None):
    """Violin plot of episode returns per algorithm for one site/period
    (the reference's ``plot_violins``, plot_utils.py:45)."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    frames = []
    for algo in algorithms:
        df = read_baseline(site, period, algo, results_dir)
        df = df.assign(algorithm=algo)
        frames.append(df[["algorithm", "return"]])
    data = pd.concat(frames, ignore_index=True)
    if ax is None:
        _, ax = plt.subplots(figsize=(1.2 * len(algorithms) + 2, 3.2))
    sns.violinplot(data=data, x="algorithm", y="return", ax=ax, cut=0)
    ax.set_title(f"{site} — {period}")
    ax.set_ylabel("episode return ($)")
    return ax


def plot_reward_breakdown(site: str, period: str, algorithms: list[str],
                          results_dir: str = DEFAULT_RESULTS_DIR, ax=None):
    """Per-component mean rewards (profit / carbon / violation)."""
    import matplotlib.pyplot as plt

    rows = []
    for algo in algorithms:
        df = read_baseline(site, period, algo, results_dir)
        row = {"algorithm": algo}
        for col in BREAKDOWN_COLS:
            if col in df.columns:
                row[col] = float(df[col].mean())
        rows.append(row)
    data = pd.DataFrame(rows).set_index("algorithm")
    if ax is None:
        _, ax = plt.subplots(figsize=(1.2 * len(algorithms) + 2, 3.2))
    data.plot.bar(stacked=False, ax=ax)
    ax.set_ylabel("mean $ per episode")
    ax.set_title(f"{site} — {period} reward breakdown")
    return ax


def plot_train_curves(log_dirs: dict[str, str], metric: str = "mean_reward",
                      ax=None):
    """Training-curve overlay across runs (the reference's
    ``reward_curve_all``, plot_utils.py:172): ``metric`` of each run's
    ``train_results.csv`` against its ``iteration``. A run without the
    column raises KeyError."""
    import matplotlib.pyplot as plt

    frames = {}
    for label, log_dir in log_dirs.items():
        df = read_train_log(log_dir)
        if metric not in df.columns:
            raise KeyError(
                f"{os.path.join(log_dir, 'train_results.csv')} has no "
                f"column {metric!r}; its columns: {list(df.columns)}")
        frames[label] = df
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3.2))
    for label, df in frames.items():
        ax.plot(df["iteration"], df[metric], label=label)
    ax.set_xlabel("train step")
    ax.set_ylabel(metric)
    ax.legend()
    return ax
