"""The generic rollouts' reset schedule (``core.env.reset_schedule``,
``phased_autoreset_step``): PPO's generic rollout and the off-policy
rollout reset the envs only at the steps that end every episode, as the
reference's ``lax.cond(any(done))`` skips the reset where no env ended
(sustaingym_tpu/core/env.py:126-175); the draws this gives, pinned
against a plain loop; and the guard that raises when an env ends off
the schedule."""
import numpy as np
import pytest
import torch

from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import (Box, FunctionalEnv, TimeStep,
                                       dataclass, reset_schedule,
                                       tree_select)
from sustaingym_tpu_torch.parallel import (PPOConfig, SACConfig,
                                           make_sac_train_step,
                                           make_train_step)
from sustaingym_tpu_torch.parallel.ppo import _sampler


def test_reset_schedule():
    assert reset_schedule(288, 0, 64) == [False] * 64
    s = reset_schedule(288, 256, 64)
    assert [k for k, r in enumerate(s) if r] == [31]
    assert reset_schedule(4, 1, 8) == [k in (2, 6) for k in range(8)]
    assert reset_schedule(None, 5, 3) == [True] * 3


class _Counting:
    """An env's functions, counting its resets."""

    def __init__(self, env):
        self.env, self.resets = env, []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, params, generator, batch):
        self.resets.append(batch)
        return self.env.reset(params, generator, batch)


def test_generic_rollout_draws_a_reset_only_at_episode_ends():
    """EV at 8 envs, rollout 64 from the clock at 256 of 288: one reset,
    at step 31; the rows equal a plain loop that draws the policy's noise
    every step and one whole-batch reset at step 31 (the new draws)."""
    base, params = make("evcharging", device="cpu")
    env = _Counting(base)
    cfg = PPOConfig(num_envs=8, hidden=16, minibatches=2, epochs=1,
                    rollout_len=64)
    init_state, train_step = make_train_step(env, params, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    for _ in range(4):                      # to the clock at 256
        carry, _ = train_step(carry, gen)
    assert env.resets == [8] and int(carry["env_phase"]) == 256
    state, obs = carry["env_states"], carry["obs"]
    state = type(state)(**{k: v.clone() for k, v in vars(state).items()})
    obs = {k: v.clone() for k, v in obs.items()}
    ref_gen = torch.Generator()
    ref_gen.set_state(gen.get_state())
    out = train_step.rollout(carry["policy"], gen, carry)
    assert env.resets == [8, 8]
    assert int(carry["env_phase"]) == (256 + 64) % 288
    assert int(carry["reset_guard"]) == 0
    # the plain loop
    from sustaingym_tpu_torch.core import flatten
    from sustaingym_tpu_torch.core.env import replace
    from sustaingym_tpu_torch.parallel.ppo import (_apply_f32,
                                                   default_act_transform)
    space = base.observation_space(params)
    sample = _sampler(lambda o: flatten(space, o, batch_dims=1), _apply_f32,
                      default_act_transform(base, params), 0)
    rewards, dones = [], []
    with torch.no_grad():
        for k in range(64):
            _, u, action = sample(carry["policy"], obs, ref_gen)
            state, ts = base.step(params, state, action, ref_gen)
            if k == 31:
                rs, rts = base.reset(params, ref_gen, 8)
                state = tree_select(ts.done, rs, state)
                ts = replace(ts, obs=tree_select(ts.done, rts.obs, ts.obs))
            obs = ts.obs
            rewards.append(ts.reward)
            dones.append(ts.done)
    assert torch.equal(out["reward"], torch.stack(rewards))
    assert torch.equal(out["done"], torch.stack(dones))
    assert bool(out["done"][31].all()) and int(out["done"].sum()) == 8
    assert torch.equal(gen.get_state(), ref_gen.get_state())


@dataclass
class _ToyState:
    x: torch.Tensor
    t: torch.Tensor


class _EarlyEnd(FunctionalEnv):
    """A 4-step episode, except that env 0 ends at its second step: off
    the schedule ``episode_steps`` declares."""
    name = "early-end"

    def episode_steps(self, params):
        return 4

    def observation_space(self, params):
        return Box(-10.0, 10.0, (2,))

    def action_space(self, params):
        return Box(-1.0, 1.0, (1,))

    def reset(self, params, generator, batch):
        x = torch.rand((batch, 2), generator=generator)
        return (_ToyState(x, torch.zeros(batch, dtype=torch.long)),
                self._ts(x, torch.zeros(batch, dtype=torch.bool)))

    def step(self, params, state, action, generator=None):
        t = state.t + 1
        x = state.x + 0.1 * action
        done = t >= 4
        done[0] = done[0] | (t[0] == 2)
        return _ToyState(x, t), self._ts(x, done)

    @staticmethod
    def _ts(x, done):
        return TimeStep(obs=x, reward=-(x ** 2).sum(-1), terminated=done,
                        truncated=torch.zeros_like(done), info={})


class _Params:
    device = torch.device("cpu")


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_guard_raises_when_an_env_ends_off_phase(algo):
    """The guard counts the off-schedule done (and the schedule's step
    where env 0, reset early, does not end) on the device; the read one
    train step late (or ``check``) raises and names the env."""
    env = _EarlyEnd()
    if algo == "ppo":
        cfg = PPOConfig(num_envs=4, hidden=8, minibatches=1, epochs=1,
                        rollout_len=3)
        init_state, train_step = make_train_step(env, _Params(), cfg)
    else:
        cfg = SACConfig(num_envs=4, hidden=8, rollout_len=3, capacity=12,
                        updates=1)
        init_state, train_step = make_sac_train_step(env, _Params(), cfg)
    gen = torch.Generator().manual_seed(0)
    carry = init_state(gen)
    carry, _ = train_step(carry, gen)      # step 2 ends env 0 off phase
    assert int(carry["reset_guard"]) >= 1
    with pytest.raises(RuntimeError, match="early-end"):
        train_step(carry, gen)             # reads the previous step's
    with pytest.raises(RuntimeError, match="episode_steps=4"):
        train_step.check(carry)


def test_guard_stays_zero_on_the_schedule():
    env, params = make("cogen", device="cpu")
    cfg = PPOConfig(num_envs=4, hidden=8, minibatches=2, epochs=1,
                    rollout_len=40, reward_scale=1e-4)
    init_state, train_step = make_train_step(env, params, cfg)
    gen = torch.Generator().manual_seed(1)
    carry = init_state(gen)
    dones = 0
    for _ in range(3):                     # 120 steps: one end at 96
        carry, m = train_step(carry, gen)
        dones += float(m["episode_done_frac"]) * 40 * 4
    train_step.check(carry)
    assert int(carry["reset_guard"]) == 0 and np.isclose(dones, 4)
