"""Environment validation sweep: the port of the JAX package's
``examples/validate_envs.py``, the script analogue of the reference's
env-validation notebook (``examples/evcharging/env_validation.ipynb``).

For every env: roll a batch of random-policy episodes
(``core.batch_rollout``) on the device, check that every reward is finite
and that every episode terminates at its last step and not before, print
reward statistics, and (with ``--plots``) write a reward histogram and an
episode trace of each env to PNG (matplotlib, the Agg backend).

    python -m sustaingym_tpu_torch.examples.validate_envs --building-tables tables/
    python -m sustaingym_tpu_torch.examples.validate_envs --envs cogen \
        --batch 4096 --plots --out-dir validation/
"""
from __future__ import annotations

import argparse
import os

EPISODE_LEN = {"building": 288, "cogen": 96, "evcharging": 288,
               "electricitymarket": 288, "datacenter": 672}


def validate(name: str, batch: int, plots: bool, out_dir: str,
             device="cuda", tables: str | None = None) -> dict:
    """The stats of ``batch`` random-policy episodes of env ``name`` on
    ``device``; the building on the synthetic tables written into
    ``tables`` when it is given, else on the raw tables."""
    import numpy as np
    import torch

    from sustaingym_tpu_torch import make
    from sustaingym_tpu_torch.bench import make_env
    from sustaingym_tpu_torch.core import batch_rollout, random_policy

    if name == "building" and tables is None:
        env, params = make(name, device=device)
    else:
        if tables is not None:
            os.makedirs(tables, exist_ok=True)
        env, params = make_env(name, device, tables)
    steps = EPISODE_LEN[name]
    gen = torch.Generator(device=params.device).manual_seed(0)
    traj = batch_rollout(env, params, random_policy(env, params, batch),
                         None, gen, batch, steps)
    rewards = traj.reward.float().cpu().numpy()     # (steps, batch)
    terms = traj.terminated.cpu().numpy()
    returns = rewards.sum(axis=0)

    assert np.all(np.isfinite(rewards)), f"{name}: non-finite rewards"
    assert terms[-1].all(), f"{name}: episodes must terminate at step {steps}"
    assert not terms[:-1].any(), f"{name}: early termination"

    stats = {
        "env": name,
        "episodes": batch,
        "return_mean": float(returns.mean()),
        "return_std": float(returns.std()),
        "reward_min": float(rewards.min()),
        "reward_max": float(rewards.max()),
    }
    if plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.2))
        ax1.hist(returns, bins=30)
        ax1.set_title(f"{name}: episode returns (n={batch})")
        ax2.plot(rewards[:, :8])
        ax2.set_title("per-step rewards (8 episodes)")
        fig.tight_layout()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        stats["plot"] = path
    return stats


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--envs", nargs="+", default=sorted(EPISODE_LEN))
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--plots", action="store_true")
    parser.add_argument("--out-dir", default="validation")
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda (default) or cpu")
    parser.add_argument("--building-tables", default=None,
                        help="write the synthetic 6-zone office and Tucson "
                             "weather tables into this directory and "
                             "validate the building on them (the raw "
                             "OfficeSmall tables are not shipped)")
    args = parser.parse_args(argv)

    out = []
    for name in args.envs:
        stats = validate(name, args.batch, args.plots, args.out_dir,
                         args.device, args.building_tables)
        print(" ".join(f"{k}={v}" for k, v in stats.items()), flush=True)
        out.append(stats)
    return out


if __name__ == "__main__":
    main()
