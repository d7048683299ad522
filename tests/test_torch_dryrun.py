"""``sustaingym_tpu_torch.dryrun.dryrun_multichip``, the counterpart of
``__graft_entry__.py::dryrun_multichip``: one train step of every sharded
learner on a 2- and a 4-rank gloo mesh (mp = 2) on the CPU."""
import math

import pytest

from sustaingym_tpu_torch.dryrun import dryrun_multichip


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_multichip(ranks, capsys):
    cases = dryrun_multichip(ranks, device="cpu")
    labels = [c[0] for c in cases]
    assert labels == ["ppo/building", "sac/building",
                      "ppo/evcharging-multiagent",
                      "ppo/evcharging-multiagent (uniform-obs path)",
                      "ppo/cogen-multiagent (per-agent stacked)",
                      "dqn/electricitymarket", "ddpg/electricitymarket"]
    for _, metrics, shape in cases:
        assert shape == {"dp": ranks // 2, "mp": 2}
        assert all(math.isfinite(v) for v in metrics.values())
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip ") == len(cases)
