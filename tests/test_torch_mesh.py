"""The port's mesh beyond plain dp (``parallel/mesh.py``): a dp2 x mp2
mesh of 4 gloo processes, and the SAC learner at dp = 2, each against one
rank on the same global batch (``bench_scaling.equivalence``)."""
import numpy as np
import pytest

from sustaingym_tpu_torch.bench_scaling import equivalence


@pytest.mark.parametrize("ranks,mp,algo", [(4, 2, "ppo"), (2, 1, "sac")])
def test_mesh_matches_one_rank(ranks, mp, algo):
    """Two train steps at dp2 x mp2 (PPO: trunk1 column-, trunk2
    row-parallel) or dp = 2 (SAC: the env batch and the ring's env axis
    split, gradients all-reduced before each Adam step) equal one rank's
    to float32 reassociation (< 1e-4; measured below 1e-6), with every
    rank's parameters (gathered) and generator equal."""
    eq = equivalence(ranks, "evcharging", 8, 16, mp=mp, steps=2, algo=algo,
                     hidden=32, device="cpu")
    assert eq["devices"] == ranks and eq["mp"] == mp
    assert np.isfinite(eq["dp1_vs_dpN_metrics_max_abs_diff"])
    assert eq["dp1_vs_dpN_metrics_max_abs_diff"] < 1e-4, eq
    assert eq["params_equal_across_ranks"]
    assert eq["generator_equal_across_ranks"]
    assert eq["generator_equal_to_one_rank"]
