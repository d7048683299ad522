"""Per-agent-policy training on the multi-agent cogen view: the analogue
of the reference's per-agent RLLib PolicySpec setup (its
``examples/cogen/train_rllib.py:99-157``: one PPO policy per GT1 / GT2 /
GT3 / ST agent, per-agent rewards of own fuel + ramp + cv plus a shared
non-delivery / 4 term).

The four policies are stacked weights trained by one learner
(``parallel/ppo.py``'s ``StackedActorCritic``); the agents' action dims
(4 / 4 / 4 / 3) ride a padded (4, 4) layout whose unused slot is masked
out of the log-prob.

    python -m sustaingym_tpu_torch.examples.train_multiagent_cogen \
        --iterations 100 --num-envs 1024 --log-dir runs/cogen_ma

Fixes ``--env cogen-multiagent --gamma 0.5 --lr 1e-3``; every other
argument is ``sustaingym_tpu_torch.train``'s.
"""
from __future__ import annotations

import sys

from sustaingym_tpu_torch.train import main as train_main


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    train_main(["--env", "cogen-multiagent", "--gamma", "0.5",
                "--lr", "1e-3", *argv])


if __name__ == "__main__":
    main()
