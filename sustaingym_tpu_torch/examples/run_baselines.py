"""Batch-evaluates baseline controllers and writes per-run CSVs: the port
of the JAX package's ``examples/run_baselines.py``.

The reference's ``examples/evcharging/run_baselines.py:91-142`` fans a
process pool over (site, period, baseline) combinations; here each
algorithm runs its seeds through ``algorithms.BaseAlgorithm.run`` over a
Gymnasium adapter (``compat/gym.py``), so no process pool is needed. Needs
gymnasium, as the JAX script does.

Outputs ``<results-dir>/<site>/<period>/<algorithm>.csv`` with columns
[seed, return, <info columns>], which
``sustaingym_tpu_torch.envs.evcharging.plot_utils`` reads.

    python -m sustaingym_tpu_torch.examples.run_baselines --env evcharging \
        --site caltech --period "Summer 2021" --algorithms greedy random \
        --num-seeds 14
    python -m sustaingym_tpu_torch.examples.run_baselines --env building \
        --algorithms mpc random --building-tables tables/
"""
from __future__ import annotations

import argparse
import os


def ev_algorithms(names, site, period, project_action=True, device="cuda"):
    """(name, algorithm) of each of ``names`` (greedy, random,
    offline_optimal, mpc<lookahead>) on one EV adapter."""
    from sustaingym_tpu_torch.algorithms.evcharging import (
        MPC, GreedyAlgorithm, OfflineOptimal, RandomAlgorithm)
    from sustaingym_tpu_torch.compat.gym import EVChargingGymEnv
    env = EVChargingGymEnv(site=site, date_period=period,
                           project_action=project_action, device=device)
    table = {
        "greedy": lambda: GreedyAlgorithm(env),
        "random": lambda: RandomAlgorithm(env),
        "offline_optimal": lambda: OfflineOptimal(env),
    }
    for name in names:
        if name.startswith("mpc"):
            lookahead = int(name[3:]) if len(name) > 3 else 12
            yield f"mpc{lookahead}", MPC(env, lookahead=lookahead)
        else:
            yield name, table[name]()


def building_algorithms(names, building, weather, location, device="cuda",
                        **kwargs):
    """(name, algorithm) of each of ``names`` (random, mpc) on one
    building adapter; ``kwargs`` go to the building's ``make_env``."""
    from sustaingym_tpu_torch.algorithms.base import RandomAlgorithm
    from sustaingym_tpu_torch.algorithms.building import MPCAgent
    from sustaingym_tpu_torch.compat.gym import BuildingGymEnv
    env = BuildingGymEnv(building=building, weather=weather,
                         location=location, device=device, **kwargs)
    table = {
        "random": lambda: RandomAlgorithm(env),
        "mpc": lambda: MPCAgent(env),
    }
    for name in names:
        yield name, table[name]()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="evcharging",
                        choices=["evcharging", "building"])
    parser.add_argument("--site", default="caltech")
    parser.add_argument("--period", default="Summer 2021")
    parser.add_argument("--building", default="OfficeSmall")
    parser.add_argument("--weather", default="Hot_Dry")
    parser.add_argument("--location", default="Tucson")
    parser.add_argument("--building-tables", default=None,
                        help="write the synthetic 6-zone office and Tucson "
                             "weather tables into this directory and run "
                             "the building on them (the raw OfficeSmall "
                             "tables are not shipped)")
    parser.add_argument("--algorithms", nargs="+",
                        default=["greedy", "random"])
    parser.add_argument("--num-seeds", type=int, default=14,
                        help="seeds 0..n-1 map to distinct episode days")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.env == "evcharging":
        runs = ev_algorithms(args.algorithms, args.site, args.period,
                             device=args.device)
        subdir = os.path.join(args.results_dir, args.site,
                              args.period.replace(" ", "_").lower())
    else:
        building, weather, location, kw = (args.building, args.weather,
                                           args.location, {})
        if args.building_tables:
            from sustaingym_tpu_torch.envs.building import BUILDINGS
            from sustaingym_tpu_torch.envs.building.synthetic import (
                write_building_tables)
            os.makedirs(args.building_tables, exist_ok=True)
            building, weather = write_building_tables(args.building_tables)
            location = "Tucson"
            kw = dict(root=args.building_tables,
                      u_wall=BUILDINGS["OfficeSmall"][1])
        runs = building_algorithms(args.algorithms, building, weather,
                                   location, device=args.device, **kw)
        subdir = os.path.join(args.results_dir, args.building,
                              args.weather.lower())

    os.makedirs(subdir, exist_ok=True)
    for name, algo in runs:
        df = algo.run(args.num_seeds)
        out = os.path.join(subdir, f"{name}.csv")
        df.to_csv(out, index=False)
        print(f"{name}: mean return {df['return'].mean():.3f} "
              f"(+-{df['return'].std():.3f}) -> {out}")


if __name__ == "__main__":
    main()
