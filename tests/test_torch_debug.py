"""The port's debug checks (sustaingym_tpu_torch.utils.debug) against the
JAX package's checkify checks (sustaingym_tpu.utils.debug).

The same corrupted TimeStep (numpy, from fixed values) goes through both
packages' ``check_timestep``; both must name the same first failure
(checkify appends " (`check` failed)" to a message). The envs' checked
rollouts must give the same verdict in both packages. The JAX
``validate_batch_rollout`` cannot run the market (checkify does not take a
batched while loop), so the market's verdict comes from the JAX
``checked_reset`` and unbatched ``checked_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from sustaingym_tpu import make as jmake
from sustaingym_tpu.core import spaces as jspaces
from sustaingym_tpu.core.env import FunctionalEnv as JFunctionalEnv
from sustaingym_tpu.core.env import TimeStep as JTimeStep
from sustaingym_tpu.envs import building as jb
from sustaingym_tpu.envs import multiagent as jma
from sustaingym_tpu.utils import debug as jdebug
from sustaingym_tpu_torch import bench
from sustaingym_tpu_torch.core import (Box, DictSpace, Discrete,
                                       FunctionalEnv, MultiDiscrete,
                                       TimeStep)
from sustaingym_tpu_torch.core.graph import tree_leaves
from sustaingym_tpu_torch.envs.building import synthetic
from sustaingym_tpu_torch.utils import debug


class _NaNEnv(FunctionalEnv):
    """The JAX test's env (tests/test_debug_distributed.py:27-50) batched:
    a NaN reward after step 3."""

    name = "nan-test"

    def reset(self, params, generator, batch):
        dev = generator.device
        return (torch.zeros(batch, dtype=torch.int32, device=dev),
                TimeStep(obs=torch.zeros((batch, 2), device=dev),
                         reward=torch.zeros(batch, device=dev),
                         terminated=torch.zeros(batch, dtype=torch.bool,
                                                device=dev),
                         truncated=torch.zeros(batch, dtype=torch.bool,
                                               device=dev),
                         info={}))

    def step(self, params, state, action, generator=None):
        t = state + 1
        reward = torch.where(t > 3, torch.nan, 1.0)
        return t, TimeStep(obs=torch.zeros((t.shape[0], 2), device=t.device),
                           reward=reward, terminated=torch.zeros_like(
                               t, dtype=torch.bool),
                           truncated=torch.zeros_like(t, dtype=torch.bool),
                           info={})

    def observation_space(self, params):
        return Box(-1.0, 1.0, (2,))

    def action_space(self, params):
        return Box(-1.0, 1.0, (1,))


class _JaxNaNEnv(JFunctionalEnv):
    name = "nan-test"

    def reset(self, params, key):
        return jnp.int32(0), JTimeStep(
            obs=jnp.zeros(2, jnp.float32), reward=jnp.float32(0),
            terminated=jnp.bool_(False), truncated=jnp.bool_(False), info={})

    def step(self, params, state, action, key):
        t = state + 1
        reward = jnp.where(t > 3, jnp.float32(jnp.nan), jnp.float32(1.0))
        return t, JTimeStep(obs=jnp.zeros(2, jnp.float32), reward=reward,
                            terminated=jnp.bool_(False),
                            truncated=jnp.bool_(False), info={})


def _jax_msg(err) -> str | None:
    msg = err.get()
    if msg is None:
        return None
    suffix = " (`check` failed)"
    assert msg.endswith(suffix), msg
    return msg[:-len(suffix)]


def test_checked_step_flags_nan_reward_at_step_4():
    """Steps 1-3 clean, step 4 "non-finite reward", in both packages."""
    env, jenv = _NaNEnv(), _JaxNaNEnv()
    gen = torch.Generator().manual_seed(0)
    (state, _), err = debug.checked_reset(env)(None, gen, 4)
    err.throw()
    jstate, _ = jenv.reset(None, jax.random.PRNGKey(0))
    step, jstep = debug.checked_step(env), jax.jit(jdebug.checked_step(jenv))
    for t in range(1, 6):
        (state, _), err = step(None, state, torch.zeros((4, 1)), gen)
        (jstate, _), jerr = jstep(None, jstate, jnp.zeros(1, jnp.float32),
                                  jax.random.PRNGKey(0))
        want = "non-finite reward" if t >= 4 else None
        assert err.get() == _jax_msg(jerr) == want, t
    with pytest.raises(debug.CheckError, match="non-finite reward"):
        err.throw()


def test_validate_batch_rollout_raises_on_nan():
    with pytest.raises(debug.CheckError, match="non-finite reward"):
        debug.validate_batch_rollout(_NaNEnv(), None,
                                     torch.Generator().manual_seed(0),
                                     batch=4, steps=8)
    # three steps stay clean: the sum of the rewards comes back
    total = debug.validate_batch_rollout(
        _NaNEnv(), None, torch.Generator().manual_seed(0), batch=4, steps=3)
    assert float(total) == 12.0


# (name, obs, reward, terminated, info, space): one corruption a case;
# every array unbatched (the JAX TimeStep's shapes), the port's takes a
# leading batch of one
_NAN = np.float32(np.nan)
_CASES = {
    "clean": ({"b": [0.5, 0.25], "a": [1.0]}, 0.0, False, {"x": 1.0},
              "dict"),
    "obs leaf": ({"b": [0.5, _NAN], "a": [1.0], "c": np.int32([3])}, 0.0,
                 False, {}, None),
    "obs leaf first": ({"b": [0.5, 0.25], "a": [np.inf]}, 0.0, False, {},
                       None),
    "reward": ([0.5, 0.25], _NAN, False, {}, None),
    "info key": ([0.5, 0.25], 0.0, False, {"z": 1.0, "m": _NAN, "a": 2.0},
                 None),
    "non-boolean flag": ([0.5, 0.25], 0.0, np.int32(2), {}, None),
    "Box": ({"b": [0.5, 3.0], "a": [1.0]}, 0.0, False, {}, "dict"),
    "Box slack": ({"b": [0.5, 1.0 + 1e-5], "a": [1.0]}, 0.0, False, {},
                  "dict"),
    "MultiDiscrete": (np.int32([1, 4]), 0.0, False, {}, "multidiscrete"),
    "Discrete": (np.int32(8), 0.0, False, {}, "discrete"),
    "unsupported space": ([0.5, 0.25], 0.0, False, {}, "unsupported"),
}


def _spaces(kind):
    if kind is None:
        return None, None
    if kind == "dict":
        return (jspaces.DictSpace({"b": jspaces.Box(-1.0, 1.0, (2,)),
                                   "a": jspaces.Box(0.0, 2.0, (1,))}),
                DictSpace({"b": Box(-1.0, 1.0, (2,)),
                           "a": Box(0.0, 2.0, (1,))}))
    if kind == "multidiscrete":
        return jspaces.MultiDiscrete([3, 4]), MultiDiscrete([3, 4])
    if kind == "discrete":
        return jspaces.Discrete(5, start=3), Discrete(5, start=3)
    return object(), object()


def _timesteps(obs, reward, flag, info):
    def arr(x):
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype == np.float64 else x

    def obs_map(fn):
        if isinstance(obs, dict):
            return {k: fn(arr(v)) for k, v in obs.items()}
        return fn(arr(obs))

    jts = JTimeStep(obs=obs_map(jnp.asarray), reward=jnp.float32(reward),
                    terminated=jnp.asarray(flag), truncated=jnp.bool_(False),
                    info={k: jnp.float32(v) for k, v in info.items()})
    tts = TimeStep(obs=obs_map(lambda x: torch.from_numpy(x[None].copy())),
                   reward=torch.tensor([reward], dtype=torch.float32),
                   terminated=torch.from_numpy(np.asarray(flag)[None].copy()),
                   truncated=torch.zeros(1, dtype=torch.bool),
                   info={k: torch.tensor([v], dtype=torch.float32)
                         for k, v in info.items()})
    return jts, tts


@pytest.mark.parametrize("case", list(_CASES))
def test_check_timestep_messages_match_jax(case):
    """One corrupted TimeStep through both packages' check_timestep: the
    same first message, or the same TypeError for a space neither walk
    can read. "obs leaf" numbers the leaves as jax.tree.flatten does (dict
    keys sorted: a, b, c; the int leaf unchecked)."""
    obs, reward, flag, info, kind = _CASES[case]
    jts, tts = _timesteps(obs, reward, flag, info)
    jspace, tspace = _spaces(kind)
    if kind == "unsupported":
        with pytest.raises(TypeError, match="unsupported"):
            checkify.checkify(lambda: jdebug.check_timestep(jts, jspace),
                              errors=checkify.user_checks)()
        with pytest.raises(TypeError, match="unsupported"):
            debug.check_timestep(tts, tspace)
        return

    def run():
        jdebug.check_timestep(jts, jspace)
        return jnp.float32(0)

    jerr, _ = checkify.checkify(run, errors=checkify.user_checks)()
    err = debug.check_timestep(tts, tspace)
    assert err.code.dtype == torch.int32 and err.code.shape == ()
    want = {"clean": None, "obs leaf": "non-finite value in obs leaf 1",
            "obs leaf first": "non-finite value in obs leaf 0",
            "reward": "non-finite reward", "info key": "non-finite info[m]",
            "non-boolean flag": "terminated/truncated not boolean",
            "Box": "obs[b] outside declared observation-space bounds",
            "Box slack": None,
            "MultiDiscrete": "obs outside MultiDiscrete range",
            "Discrete": "obs outside Discrete range"}[case]
    assert err.get() == _jax_msg(jerr) == want


def test_first_failure_wins():
    """Two failing checks in one TimeStep report the first in the JAX
    order in both packages; across steps, ``merge`` keeps the earlier
    step's failure, whatever the later one's table."""
    jts, tts = _timesteps({"a": [_NAN]}, _NAN, np.int32(3), {"k": _NAN})
    jerr, _ = checkify.checkify(
        lambda: (jdebug.check_timestep(jts), jnp.float32(0))[1],
        errors=checkify.user_checks)()
    err = debug.check_timestep(tts)
    assert err.get() == _jax_msg(jerr) == "non-finite value in obs leaf 0"
    _, clean = _timesteps({"a": [1.0]}, 0.0, False, {})
    _, late = _timesteps([1.0], 0.0, False, {"q": _NAN})
    first = debug.check_timestep(clean)
    assert first.merge(debug.check_timestep(late)).get() == \
        "non-finite info[q]"
    assert err.merge(debug.check_timestep(late)).get() == \
        "non-finite value in obs leaf 0"
    assert debug.check_timestep(late).merge(err).get() == \
        "non-finite info[q]"


def test_checked_outputs_bit_equal_unchecked():
    """A checked reset and step return the env's own outputs, and draw
    nothing: from the same generator state every tensor is bit-equal to
    the unchecked calls'; an armed rollout's reward sum equals the
    unarmed one's."""
    env, p = bench.make_env("cogen", "cpu", None)
    space = env.action_space(p)
    outs = []
    for checked in (True, False):
        gen = torch.Generator().manual_seed(3)
        if checked:
            (state, ts), err = debug.checked_reset(env, True)(p, gen, 8)
            err.throw()
            action = space.sample_batch(gen, 8)
            (state, ts), err = debug.checked_step(env, True)(p, state,
                                                             action, gen)
            err.throw()
        else:
            state, ts = env.reset(p, gen, 8)
            action = space.sample_batch(gen, 8)
            state, ts = env.step(p, state, action, gen)
        outs.append((tree_leaves((state, ts)), gen.get_state()))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])
    totals = [debug.validate_batch_rollout(
        env, p, torch.Generator().manual_seed(5), batch=8, steps=20,
        armed=armed) for armed in (True, False)]
    assert torch.equal(totals[0], totals[1])


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("building_tables"))
    htm, epw = synthetic.write_building_tables(root)
    return root, htm, epw


def _jax_env(name, tables):
    if not name.startswith("building"):
        return jmake(name)
    root, htm, epw = tables
    d = jb.generate_building_params(htm, epw, "Tucson",
                                    u_wall=jb.BUILDINGS["OfficeSmall"][1],
                                    root=root)
    p = jb.make_params(d, dtype=jnp.float32)
    return (jb.BuildingEnv() if name == "building"
            else jma.MultiAgentBuildingEnv()), p


def _verdict(fn):
    try:
        fn()
    except TypeError:
        return "TypeError"
    except Exception as e:            # checkify's JaxRuntimeError, CheckError
        msg = str(e)
        return msg[:msg.index(" (`check`")] if "(`check`" in msg else msg
    return None


# (env, steps, check_bounds, verdict): a whole episode of each env (the
# building's bounds fail within one), the views' bounds walk a DictSpace
# over a flat obs array, which neither package's walk can read
_VERDICTS = [
    ("cogen", 96, False, None), ("cogen", 96, True, None),
    ("datacenter", 672, False, None), ("datacenter", 672, True, None),
    ("evcharging", 288, False, None), ("evcharging", 288, True, None),
    ("building", 288, False, None),
    ("building", 288, True,
     "obs outside declared observation-space bounds"),
    ("building-multiagent", 288, True,
     "obs outside declared observation-space bounds"),
    ("evcharging-multiagent", 4, True, "TypeError"),
    ("cogen-multiagent", 4, True, "TypeError"),
]


@pytest.mark.parametrize("name,steps,bounds,want", _VERDICTS)
def test_validate_batch_rollout_verdict_matches_jax(tables, name, steps,
                                                    bounds, want):
    jenv, jp = _jax_env(name, tables)
    env, p = bench.make_env(name, "cpu", tables[0])
    jv = _verdict(lambda: jdebug.validate_batch_rollout(
        jenv, jp, jax.random.PRNGKey(0), batch=4, steps=steps,
        check_bounds=bounds))
    tv = _verdict(lambda: debug.validate_batch_rollout(
        env, p, torch.Generator().manual_seed(0), batch=4, steps=steps,
        check_bounds=bounds))
    assert jv == tv == want


@pytest.mark.parametrize("bounds", [False, True])
def test_market_checked_reset_and_steps_match_jax(bounds):
    """The market clean in both packages: the JAX checked_reset and three
    unbatched checked steps, the port's checked_reset and a whole episode
    of validate_batch_rollout."""
    jenv, jp = jmake("electricitymarket")
    (js, _), jerr = jax.jit(jdebug.checked_reset(jenv, bounds))(
        jp, jax.random.PRNGKey(0))
    verdicts = [_jax_msg(jerr)]
    jstep = jax.jit(jdebug.checked_step(jenv, bounds))
    for i in range(3):
        a = jenv.action_space(jp).sample(jax.random.PRNGKey(10 + i))
        (js, _), jerr = jstep(jp, js, a, jax.random.PRNGKey(i))
        verdicts.append(_jax_msg(jerr))
    assert verdicts == [None] * 4
    env, p = bench.make_env("electricitymarket", "cpu", None)
    _, err = debug.checked_reset(env, bounds)(
        p, torch.Generator().manual_seed(0), 4)
    assert err.get() is None
    debug.validate_batch_rollout(env, p, torch.Generator().manual_seed(0),
                                 batch=4, steps=288, check_bounds=bounds)
