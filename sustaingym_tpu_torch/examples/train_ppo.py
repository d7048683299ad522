"""Thin wrapper over the training CLI: the analogue of the reference's
``examples/evcharging/train_rllib.py`` / ``train_stable_baselines.py``
entry points (the RLLib / SB3 roles are played by the port's PPO learner,
its train steps CUDA graphs on the card).

    python -m sustaingym_tpu_torch.examples.train_ppo --env cogen \
        --iterations 100 --num-envs 1024 --log-dir runs/cogen

Every argument is ``sustaingym_tpu_torch.train``'s.
"""
from __future__ import annotations

from sustaingym_tpu_torch.train import main as train_main


def main(argv: list[str] | None = None) -> None:
    train_main(argv)


if __name__ == "__main__":
    main()
