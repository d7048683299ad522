"""Runnable examples of the port, the counterparts of the JAX package's
``examples/`` scripts, each run as ``python -m
sustaingym_tpu_torch.examples.<name>`` and each a ``main(argv=None)``:

- ``train_ppo``: the training CLI (``sustaingym_tpu_torch.train``);
- ``train_multiagent_cogen``: per-agent PPO on the multi-agent cogen view;
- ``run_baselines``: baseline controllers over the Gymnasium adapters,
  one CSV per algorithm (needs gymnasium);
- ``validate_envs``: a random-policy episode batch of each env, checked
  and summarised.
"""
