"""BuildingEnv in PyTorch — multi-zone thermal RC control.

The port of ``sustaingym_tpu.envs.building.env``, with the batch axis
written out (every state tensor has a leading (B,) env axis). A step is
the discrete LTI update ``x' = A_d x + BD_d y`` of the zone temperatures,
with ``y = [occupant heat, ground temp, outdoor temp, HVAC action (n),
GHI]``, the occupant sensible-heat polynomial, and the reward
``-(q_rate ||a||_p + beta ||(x' - target) ac||_p)``. An episode starts at
an epoch of the year-long weather series and runs ``episode_len`` steps.

The exogenous rows ``[out, ground, ghi, metabolism]`` are read by direct
indexing ``exog[epoch]`` from a table padded with its own first
``episode_len`` rows, so an episode's rows are one contiguous slice: the
JAX package's chunked one-hot row select exists only for the TPU's
gathers. Whole episodes run through the CUDA kernels of ``ops/cuda`` in
:meth:`BuildingEnv.batch_unroll` (the per-episode slice gather),
:meth:`BuildingEnv.fused_rollout` (the episode kernel) and
:meth:`BuildingEnv.fused_policy_unroll` (the episode kernel with the PPO
actor inside). Random draws come from a ``torch.Generator``.

Sums over zones are sequential (:func:`_seq_sum`), as in the JAX package,
so that the generic step and the lockstep paths agree bit for bit.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch

from ...core import (Box, FunctionalEnv, MultiDiscrete, TimeStep, dataclass,
                     draw_env_rows, env_offset, kernel_seed, random_policy,
                     resolve_device, tree_map, tree_stack)
from ...core.graph import device_const
from ...core.rollout import episode_loop, join_episodes

# Occupancy sensible-heat polynomial coefficients, EnergyPlus engineering
# reference p.1299.
OCCU_COEF = (6.461927, 0.946892, 0.0000255737, 0.0627909, 0.0000589172,
             0.19855, 0.000940018, 0.00000149532)
OCCU_COEF_LINEAR = 7.139322
DISCRETE_LENGTH = 100
SCALING_FACTOR = 24
MAX_KERNEL_ZONES = 8


@dataclass
class BuildingParams:
    """Parameter pack (compiled once on the host)."""
    # dynamics
    A_d: torch.Tensor            # (n, n)
    BD_d: torch.Tensor           # (n, n+4); (n, n+7) when data_driven
    # exogenous year-long series at time_res resolution
    out_temp: torch.Tensor       # (T,)
    ground_temp: torch.Tensor    # (T,)
    ghi: torch.Tensor            # (T,) normalized [0, 1]
    metabolism: torch.Tensor     # (T,)
    # [out, ground, ghi, metabolism] per epoch, padded with its own first
    # episode_len rows so that an episode that wraps the year reads the
    # rows of epochs 0, 1, ... without a modulo
    exog: torch.Tensor           # (T + episode_len, 4)
    # zone config
    target: torch.Tensor         # (n,)
    ac_map: torch.Tensor         # (n,)
    # reward
    q_rate: torch.Tensor         # 0-d
    error_rate: torch.Tensor     # 0-d
    n: int
    episode_len: int
    length_of_weather: int
    reward_pnorm: float
    max_power: float
    time_resolution: int
    temp_min: float
    temp_max: float
    is_continuous_action: bool = True
    # data-driven dynamics: BD_d has n+7 input columns [avg^2, avg, meta^2,
    # meta, ground, out, action(n), ghi] instead of the physics model's n+4
    data_driven: bool = False

    @property
    def device(self) -> torch.device:
        return self.A_d.device


@dataclass
class BuildingState:
    x: torch.Tensor              # (B, n) zone temperatures
    occupower: torch.Tensor      # (B,) occupant heat, W
    epoch: torch.Tensor          # (B,) int64 index into the weather rows
    steps: torch.Tensor          # (B,) int64 steps taken this episode


def make_params(p: dict[str, Any], device="cuda",
                dtype=torch.float32) -> BuildingParams:
    """Packs the host compiler's dict (``params.generate_building_params``)
    into tensors on ``device`` (the card unless the caller asks for the
    CPU), precomputing the zero-order-hold discretisation."""
    from .params import discretize
    device = resolve_device(device)
    A_d, BD_d = discretize(np.asarray(p["A"]), np.asarray(p["B"]),
                           np.asarray(p["D"]), p["time_resolution"])
    beta = p["reward_beta"]
    episode_len = int(p["episode_len"])
    exog = np.stack([np.asarray(p["out_temp"], np.float64),
                     np.asarray(p["ground_temp"], np.float64),
                     np.asarray(p["ghi"], np.float64),
                     np.asarray(p["metabolism"], np.float64)], axis=1)
    exog = np.concatenate([exog, exog[:episode_len]], axis=0)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=device).contiguous()

    return BuildingParams(
        A_d=t(A_d), BD_d=t(BD_d), out_temp=t(p["out_temp"]),
        ground_temp=t(p["ground_temp"]), ghi=t(p["ghi"]),
        metabolism=t(p["metabolism"]), exog=t(exog), target=t(p["target"]),
        ac_map=t(p["ac_map"]), q_rate=t((1 - beta) * SCALING_FACTOR),
        error_rate=t(beta), n=int(p["n"]), episode_len=episode_len,
        length_of_weather=int(len(p["out_temp"])),
        reward_pnorm=float(p["reward_pnorm"]),
        max_power=float(p["max_power"]),
        time_resolution=int(p["time_resolution"]),
        temp_min=float(p["temp_range"][0]),
        temp_max=float(p["temp_range"][1]),
        is_continuous_action=bool(p["is_continuous_action"]))


def div(x: torch.Tensor, k: float) -> torch.Tensor:
    """``x / k`` as an IEEE division on every device (CUDA PyTorch divides
    by a Python scalar as a multiply by its reciprocal)."""
    return x / device_const(k, x.device, x.dtype)


def calc_occupower(temp: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Occupant sensible heat gain (W).

    Precision contract (as in the JAX package): products involving
    ``temp`` are evaluated at ``temp.dtype`` before being widened by
    ``meta``'s type.
    """
    wdt = torch.promote_types(temp.dtype, meta.dtype)
    c = OCCU_COEF
    t2 = temp * temp
    meta2 = meta * meta
    return (c[0] + c[1] * meta + c[2] * meta2
            - (c[3] * temp).to(wdt) * meta
            + (c[4] * temp).to(wdt) * meta2
            - (c[5] * t2).to(wdt)
            + (c[6] * t2).to(wdt) * meta
            - (c[7] * t2).to(wdt) * meta2)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Strictly sequential sum over the last axis (``torch.sum`` promises
    no order; numpy and the JAX package sum short vectors in order)."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _pnorm(x: torch.Tensor, p: float) -> torch.Tensor:
    if p == 2:
        return torch.sqrt(_seq_sum(x * x))
    if p == 1:
        return _seq_sum(torch.abs(x))
    return _seq_sum(torch.abs(x) ** p) ** (1.0 / p)


def kernel_config(params: BuildingParams) -> bool:
    """Whether the episode kernels compute this configuration: continuous
    actions, physics dynamics, the p = 2 reward, at most 8 zones, float32
    (the JAX package's gate without its TPU-only terms)."""
    return (params.is_continuous_action and not params.data_driven
            and params.reward_pnorm == 2 and params.n <= MAX_KERNEL_ZONES
            and params.A_d.dtype == torch.float32)


class BuildingEnv(FunctionalEnv[BuildingParams, BuildingState]):
    """Functional BuildingEnv over a batch of buildings.

    ``reset(params, generator, batch)`` draws starting epochs uniformly in
    [0, T-2]; deterministic seeded resets go through
    :meth:`reset_at_epoch` and :meth:`epoch_from_seed`.
    """

    name = "building"

    # ---- seeding --------------------------------------------------------
    @staticmethod
    def epoch_from_seed(params: BuildingParams, seed: int) -> int:
        num_days_normalizer = (
            (params.episode_len * params.time_resolution) // 86_400) * 365
        epoch = int((seed / num_days_normalizer) * params.length_of_weather)
        return min(epoch, params.length_of_weather - 1)

    # ---- API ------------------------------------------------------------
    @staticmethod
    def draw_epochs(params: BuildingParams, generator: torch.Generator,
                    batch: int) -> torch.Tensor:
        """(batch,) starting epochs, uniform in [0, T-2]."""
        if generator is None:
            raise ValueError("pass reset `epochs` or a torch.Generator")
        return draw_env_rows(lambda b: torch.randint(
            params.length_of_weather - 1, (b,), generator=generator,
            device=generator.device), batch)

    def reset(self, params: BuildingParams, generator: torch.Generator,
              batch: int) -> tuple[BuildingState, TimeStep]:
        return self.reset_at_epoch(params,
                                   self.draw_epochs(params, generator, batch))

    def reset_at_epoch(self, params: BuildingParams, epoch,
                       t_initial=None) -> tuple[BuildingState, TimeStep]:
        """Envs at ``epoch`` ((B,) or a scalar) with zone temperatures
        ``t_initial`` ((n,) or (B, n); default the target)."""
        dev, n, dtype = params.device, params.n, params.A_d.dtype
        epoch = torch.as_tensor(epoch, dtype=torch.long,
                                device=dev).reshape(-1)
        B = epoch.shape[0]
        row = params.exog[epoch]
        x0 = params.target if t_initial is None else torch.as_tensor(
            t_initial, device=dev)
        x0 = x0.expand(B, n)
        occupower = calc_occupower(div(_seq_sum(x0), n), row[:, 3])
        state = BuildingState(
            x=x0.to(dtype).clone(), occupower=occupower, epoch=epoch,
            steps=torch.zeros(B, dtype=torch.long, device=dev))
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        zero = torch.zeros(B, dtype=dtype, device=dev)
        ts = TimeStep(
            obs=self._obs(params, state, row), reward=zero, terminated=no,
            truncated=no.clone(),
            info={"zone_temperature": torch.zeros((B, n), dtype=dtype,
                                                  device=dev),
                  "comfort_level": zero, "power_consumption": zero})
        return state, ts

    def step(self, params: BuildingParams, state: BuildingState, action,
             generator: torch.Generator | None = None
             ) -> tuple[BuildingState, TimeStep]:
        """One step of every env (the dynamics are deterministic); the
        epoch wraps to 0 at the end of the weather year."""
        x_new, occupower, reward, obs, info = self._step_exog(
            params, state.x, action, params.exog[state.epoch])
        nxt = state.epoch + 1
        next_epoch = torch.where(nxt >= params.length_of_weather,
                                 torch.zeros_like(nxt), nxt)
        steps = state.steps + 1
        done = steps >= params.episode_len
        return (BuildingState(x=x_new, occupower=occupower, epoch=next_epoch,
                              steps=steps),
                TimeStep(obs=obs, reward=reward, terminated=done,
                         truncated=done.clone(), info=info))

    def _step_exog(self, params: BuildingParams, x: torch.Tensor, action,
                   row: torch.Tensor):
        """Dynamics, reward and obs given each env's exogenous row
        ``[out, ground, ghi, metabolism]`` (B, 4). Shared by :meth:`step`
        (which reads the row by epoch) and :meth:`batch_unroll` (which
        reads it from the gathered episode block)."""
        dtype, n = params.A_d.dtype, params.n
        action = torch.as_tensor(action, device=params.device)
        if not params.is_continuous_action:
            # MultiDiscrete {0..2*100*ac} -> continuous [-ac, ac]
            action = div(action.to(dtype) - params.ac_map * DISCRETE_LENGTH,
                         DISCRETE_LENGTH)
        # the action norm in the reward is evaluated at the caller's dtype
        action_in = action
        action = action.to(dtype)
        out_t, ground_t, ghi_t, meta = row.unbind(-1)
        # the zone temperatures enter at float32 precision, and so do the
        # average and the polynomial's temperature products
        x32 = x.to(torch.float32)
        avg_temp32 = div(_seq_sum(x32), n)
        occupower = calc_occupower(avg_temp32, meta).to(dtype)
        if params.data_driven:
            avg = avg_temp32.to(dtype)
            y = torch.cat([torch.stack([avg * avg, avg, meta * meta, meta,
                                        ground_t, out_t], -1),
                           action, ghi_t[:, None]], -1)
        else:
            y = torch.cat([torch.stack([occupower, ground_t, out_t], -1),
                           action, ghi_t[:, None]], -1)
        x_new = x32.to(dtype) @ params.A_d.T + y @ params.BD_d.T
        error = x_new * params.ac_map - params.target * params.ac_map
        p = params.reward_pnorm
        power_cost = (_pnorm(action_in, p)
                      * params.q_rate.to(action_in.dtype)).to(dtype)
        comfort_cost = _pnorm(error, p) * params.error_rate
        reward = -(power_cost + comfort_cost)
        obs = torch.cat([x_new, out_t[:, None], ground_t[:, None],
                         ghi_t[:, None], div(occupower, 1000.0)[:, None]],
                        -1).to(torch.float32)
        info = {"zone_temperature": x_new, "comfort_level": -comfort_cost,
                "power_consumption": -power_cost}
        return x_new, occupower, reward, obs, info

    def episode_steps(self, params: BuildingParams) -> int:
        return int(params.episode_len)

    # ---- lockstep episode paths -------------------------------------------
    def _episode_epochs(self, params: BuildingParams, ep: int, batch: int,
                        generator, epochs) -> torch.Tensor:
        """Starting epochs of episode ``ep``: prescribed by ``epochs``
        ((episodes, B) or (B,)), else drawn as :meth:`reset` draws them."""
        if epochs is None:
            return self.draw_epochs(params, generator, batch)
        epochs = torch.as_tensor(epochs, dtype=torch.long,
                                 device=params.device).reshape(-1, batch)
        if ep >= epochs.shape[0]:
            raise ValueError(f"need reset epochs for {ep + 1} episodes, got "
                             f"{epochs.shape[0]}")
        return epochs[ep]

    def batch_unroll(self, params: BuildingParams, policy, policy_params,
                     batch: int, num_steps: int,
                     generator: torch.Generator | None = None,
                     epochs=None, graphs=None) -> TimeStep:
        """Lockstep rollout with one exogenous-row gather per episode: each
        env's ``episode_len`` rows are one contiguous slice of the padded
        table, fetched with the slice-gather kernel
        (``ops/cuda/exog_gather.py``) and stepped time-major by
        :meth:`_step_exog`. ``policy(policy_params, obs, generator)``
        returns (B, n) actions. At each episode boundary the last step's
        obs is the next episode's reset obs (autoreset). Resets are drawn
        from ``generator`` in the order the generic autoreset path draws
        them, or prescribed by ``epochs`` ((num_steps // L + 1, B)).

        Each episode starts eagerly (the reset draws and the gather, whose
        range check waits on the host); its step loop
        (:meth:`_episode_steps`) is one replay of a CUDA graph in
        ``graphs`` when given (:func:`core.rollout.episode_loop`), which
        the result then holds until the graph's next replay."""
        from ...ops.cuda.exog_gather import episode_slice_gather

        L = params.episode_len
        e0 = self._episode_epochs(params, 0, batch, generator, epochs)
        state, ts = self.reset_at_epoch(params, e0)
        x, obs, parts = state.x, ts.obs, []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            block = episode_slice_gather(params.exog, state.epoch,
                                         seg).transpose(0, 1)  # (seg, B, 4)
            traj = episode_loop(
                graphs, partial(self._episode_steps, params, policy,
                                policy_params, generator),
                x, obs, block, generator=generator,
                clone=t0 + seg < num_steps)
            if seg == L:
                state, ts_r = self.reset_at_epoch(params, self._episode_epochs(
                    params, ep + 1, batch, generator, epochs))
                x, obs = state.x, ts_r.obs
                traj.obs[-1] = obs
            parts.append(traj)
        return join_episodes(parts)

    def _episode_steps(self, params: BuildingParams, policy, policy_params,
                       generator, x, obs, block) -> TimeStep:
        """The steps of an episode from zone temperatures ``x`` and reset
        ``obs`` over its gathered exogenous ``block`` (seg, B, 4): the part
        of :meth:`batch_unroll` that a CUDA graph captures."""
        L = params.episode_len
        no = torch.zeros(x.shape[0], dtype=torch.bool, device=params.device)
        traj = []
        for t in range(block.shape[0]):
            actions = policy(policy_params, obs, generator)
            x, _, reward, obs, info = self._step_exog(params, x, actions,
                                                      block[t])
            done = no | (t == L - 1)
            traj.append(TimeStep(obs=obs, reward=reward, terminated=done,
                                 truncated=done.clone(), info=info))
        return tree_stack(traj)

    def fused_rollout(self, params: BuildingParams, batch: int,
                      num_steps: int,
                      generator: torch.Generator | None = None,
                      actions: torch.Tensor | None = None,
                      epochs=None) -> TimeStep:
        """Simulation tier: one launch of the episode kernel
        (``ops/cuda/building_rollout.py::building_segment``) per episode,
        which writes the obs, zone temperatures, rewards and info of every
        step; then the autoreset splice of the last obs.

        Actions are drawn U(-ac, ac) in the kernel from a Philox stream
        seeded from ``generator``, or prescribed as ``actions``
        (num_steps, B, n). Resets as in :meth:`batch_unroll`. A
        configuration the kernel does not compute (:func:`kernel_config`)
        runs :meth:`batch_unroll` with the random policy instead, and then
        refuses prescribed actions.

        Memory: per step and env (2n + 7) floats of output and a done flag
        (~12 GB at 524288 x 288 for n = 6)."""
        from ...ops.cuda.building_rollout import building_segment

        if not kernel_config(params):
            if actions is not None:
                raise ValueError("fused_rollout with explicit actions needs "
                                 "a configuration the episode kernel "
                                 "computes (kernel_config)")
            return self.batch_unroll(params, random_policy(self, params,
                                                           batch), None,
                                     batch, num_steps, generator, epochs)
        L, dev = params.episode_len, params.device
        e0 = self._episode_epochs(params, 0, batch, generator, epochs)
        parts = []
        for ep, t0 in enumerate(range(0, num_steps, L)):
            seg = min(L, num_steps - t0)
            if actions is None:
                acts, seed = None, kernel_seed(generator)
            else:
                acts = actions[t0:t0 + seg].to(torch.float32).contiguous()
                seed = 0
            out = building_segment(params, e0, seg, actions=acts, seed=seed)
            done = torch.zeros((seg, batch), dtype=torch.bool, device=dev)
            obs = out["obs"]
            if seg == L:
                done[-1] = True
                e0 = self._episode_epochs(params, ep + 1, batch, generator,
                                          epochs)
                obs[-1] = self.reset_at_epoch(params, e0)[1].obs
            parts.append(TimeStep(
                obs=obs, reward=out["reward"], terminated=done,
                truncated=done.clone(),
                info={"zone_temperature": out["zone_temperature"],
                      "comfort_level": out["comfort_level"],
                      "power_consumption": out["power_consumption"]}))
        if len(parts) == 1:
            return parts[0]
        return tree_map(lambda *xs: torch.cat(xs), *parts)

    # ---- policy-in-kernel path (parallel.ppo fused protocol) --------------
    def fused_layout(self, params: BuildingParams) -> dict:
        """Learner-block layout of :meth:`fused_policy_unroll`."""
        from ...ops.cuda.building_rollout import building_fused_layout
        return building_fused_layout(params.n)

    def fused_policy_unroll_supported(self, params: BuildingParams,
                                      batch: int) -> bool:
        """Whether :meth:`fused_policy_unroll` computes this configuration
        (:func:`kernel_config`); any batch works."""
        return kernel_config(params)

    def fused_policy_unroll(self, params: BuildingParams, policy, batch: int,
                            num_steps: int, epochs=None,
                            generator: torch.Generator | None = None,
                            noise: torch.Tensor | None = None) -> dict:
        """PPO rollout of one episode with the actor inside the episode
        kernel (``ops/cuda/building_rollout.py::building_policy_segment``):
        obs assembly, the 2-layer tanh actor in bf16, Gaussian sampling,
        the ``tanh(u) * ac`` squash and the RC step. ``policy`` is a
        ``parallel.ppo.ActorCritic``.

        Returns ``lrn`` (T, B, 2n + 4) bf16 — the obs the policy saw, then
        the pre-squash draws u (see :meth:`fused_layout`) — plus ``reward``
        / ``comfort_cost`` / ``power_cost`` / ``done`` (T, B) and the reset
        ``epochs`` (B,). ``noise`` (T, B, n) prescribes the normal draws;
        otherwise the kernel draws Box–Muller normals from a Philox stream
        seeded from ``generator``, keyed by the global env index
        (``core.env_offset`` under a data-parallel mesh)."""
        from ...ops.cuda.building_rollout import building_policy_segment
        from ...ops.cuda.ev_rollout import pack_policy_weights

        L = params.episode_len
        if num_steps != L:
            raise ValueError(f"fused_policy_unroll runs exactly one episode "
                             f"({L} steps)")
        if not kernel_config(params):
            raise ValueError("fused_policy_unroll needs a configuration the "
                             "episode kernel computes (kernel_config)")
        e0 = self._episode_epochs(params, 0, batch, generator, epochs)
        seed = kernel_seed(generator) if noise is None else 0
        out, lrn = building_policy_segment(params, pack_policy_weights(policy),
                                           e0, L, noise=noise, seed=seed,
                                           env_offset=env_offset())
        done = torch.zeros((L, batch), dtype=torch.bool, device=params.device)
        done[-1] = True
        return {"lrn": lrn, "reward": out[..., 0], "done": done,
                "comfort_cost": out[..., 1], "power_cost": out[..., 2],
                "epochs": e0}

    @staticmethod
    def _obs(params: BuildingParams, state: BuildingState,
             row: torch.Tensor | None = None) -> torch.Tensor:
        """(B, n + 4) = [zone temps (n), out temp, ground temp, ghi,
        occupower / 1000]."""
        if row is None:
            row = params.exog[state.epoch]
        return torch.cat([state.x, row[:, 0:3],
                          div(state.occupower, 1000.0)[:, None]],
                         -1).to(torch.float32)

    # ---- metadata -------------------------------------------------------
    def observation_space(self, params: BuildingParams) -> Box:
        """obs = [temps(n), out, ground, ghi, occupower/1000].

        As in the JAX package, the bounds match the obs layout and
        occupower is two-sided (the reference's bound vector has GHI and
        ground swapped and a positive lower bound for occupower, whose
        values are negative).
        """
        n = params.n
        min_t, max_t = params.temp_min, params.temp_max
        heat_max = 1000.0
        low = np.concatenate([np.full(n + 2, min_t), [0], [-heat_max]])
        high = np.concatenate([np.full(n + 2, max_t), [heat_max], [heat_max]])
        return Box(low, high)

    def action_space(self, params: BuildingParams) -> Box | MultiDiscrete:
        ac = params.ac_map.detach().cpu().double().numpy()
        if params.is_continuous_action:
            return Box(-ac, ac)
        return MultiDiscrete((2 * ac * DISCRETE_LENGTH).astype(np.int64))
