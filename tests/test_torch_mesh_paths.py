"""Every PPO path's rows under a mesh, against one rank on the same global
batch: the stacked per-agent policies (MA cogen: rows (t, env) carrying
the agent axis) at dp = 2 and at mp = 2, the agent axis as batch (MA-EV
with a delay: rows (t, env, agent), so each rank's rows of a global
minibatch map through the agent axis) and the categorical head (discrete
MA-EV), each on the generic rollout over one group of 2 gloo processes."""
import numpy as np
import pytest

from sustaingym_tpu_torch.bench_scaling import rank_run
from sustaingym_tpu_torch.parallel import spawn

CASES = {
    "stacked dp2": ("cogen-multiagent", {"forecast_horizon": 2}, 1,
                    {"num_envs": 8, "rollout_len": 100,
                     "reward_scale": 1e-4}),
    "stacked mp2": ("cogen-multiagent", {"forecast_horizon": 2}, 2,
                    {"num_envs": 8, "rollout_len": 100,
                     "reward_scale": 1e-4}),
    "agent axis dp2": ("evcharging-multiagent",
                       {"periods_delay": 1, "project_action": False}, 1,
                       {"num_envs": 4, "rollout_len": 8}),
    "categorical dp2": ("evcharging-multiagent",
                        {"discrete_bins": 3, "project_action": False}, 1,
                        {"num_envs": 4, "rollout_len": 8}),
}


def _run(case, mp):
    """Two train steps of ``case`` on this rank's mesh (``mp`` 1 in the
    test's own process)."""
    name, make_kwargs, _, cfg = CASES[case]
    cfg = {"hidden": 32, "epochs": 2, "minibatches": 4, **cfg}
    return rank_run(name, "ppo", cfg, mp, 1, 7, "cpu", make_kwargs)


def _every_case():
    return {case: _run(case, CASES[case][2]) for case in CASES}


@pytest.fixture(scope="module")
def ranks():
    """Each case on one group of 2 ranks (a mesh a case)."""
    return spawn(_every_case, 2, device="cpu", timeout=120)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_path_matches_one_rank(ranks, case):
    """Two train steps (the first crossing the cogen episode's end):
    metrics within rtol 1e-3 / atol 1e-5 of one rank's (the sums'
    order differs, and Adam carries it into the second step), every
    rank's parameters and generator equal."""
    one = _run(case, 1)
    two = [r[case] for r in ranks]
    assert one["path"] == two[0]["path"] == "generic"
    assert two[0]["params"] == two[1]["params"]
    assert two[0]["generator"] == two[1]["generator"] == one["generator"]
    for r in two:
        for a, b in zip(one["metrics"], r["metrics"]):
            for key in a:
                np.testing.assert_allclose(b[key], a[key], rtol=1e-3,
                                           atol=1e-5, err_msg=key)
