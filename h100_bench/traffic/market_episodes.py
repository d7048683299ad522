"""Traffic driver ``market_episodes``: back-to-back batched episodes of the
electricity market, as an evaluation or a policy sweep runs them.

Each call is one whole episode of ``batch`` envs through the path users
run, ``core.batch_rollout(env, params, random_policy(env, params, batch),
None, generator, batch, episode_steps, graphs=graphs)``: the episode starts
eagerly (the reset days drawn from the benchmark's generator), and its
steps are one replay of the CUDA graph that set-up captured, the bids
(uniform on [0, 1000] $/MWh) drawn on the card inside it and every
step's SCED solved by one ``pdhg_solve_paired`` launch. Set-up builds the
kernel, captures the graph with one episode and then runs the mix's
``warm_episodes`` more, back to back: an H100 runs this workload ~8%
slower for its first 0.6-36 s (PERF.md, the market cell's findings), and
set-up's time counts them. The window calls episodes back to back, each
synchronised, until ``--seconds`` have passed; each call's wall time is a
sample of the episode latency. A reservoir drawn from the seed keeps
``check_episodes`` of the window's episodes, with the generator's state
before each, for the comparison.

The traced run profiles ``trace_episodes`` episodes: the device's busy
time, and the solve kernel's launches and device time in that window (the
graph replays' kernels, as the profiler's trace sees them). The
profiler's trace can come back short of kernel records (one traced run on
an H100 held fewer solve launches than its episodes' steps), so on a card
a window whose trace holds fewer is profiled again, at most
``TRACE_TRIES`` windows in all, and the last is kept; the readers
withhold their numbers where even that one is short. Then as many
episodes again, from which the reservoir draws, and the program's pass
(``lib/program.py``) of as many more.
"""
from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from h100_bench.lib import compare, devtime, program
from h100_bench.reference.market import ALTERED   # one reward's change, $

FAULTS = ("half_warm_budget", "unshifted_warm_start", "frozen_energy",
          "half_batch", "altered_output")
STAND_IN_FAULTS = FAULTS
KERNEL = "pdhg_paired_kernel"      # the solve kernel's name in the trace
TRACE_TRIES = 3     # profiled windows at most, until one holds every solve
OUTPUTS = ("revenue", "carbon_value", "terminal_cost", "price",
           "dispatch_mwh", "energy_level")


class Driver:
    UNITS = "trace_episodes"    # the mix's count of episodes a pass

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 faults=()):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.faults = tuple(faults)
        self.kept: list = []         # (index, generator state, outputs)
        self.pick = random.Random(seed)
        self.graphs = None

    def setup(self, trace: bool) -> None:
        from sustaingym_tpu_torch import make
        from sustaingym_tpu_torch.core import random_policy
        from sustaingym_tpu_torch.core.graph import Graphs
        cfg, dev = self.config, self.device
        self.env, self.params = make(cfg["env"], device=dev, **cfg["make"])
        self.policy = random_policy(self.env, self.params, self.mix["batch"])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        self.graphs = Graphs(dev)
        self._plant()
        for _ in range(1 + self.mix["warm_episodes"]):
            self._episode()
            _sync(dev)

    def _plant(self) -> None:
        """Breaks the program underneath for the faults asked for."""
        from sustaingym_tpu_torch.core.struct import replace
        p, dev = self.params, self.device
        if "half_warm_budget" in self.faults:
            p = replace(p, lp_warm_iters=p.lp_warm_iters // 2)
        if "unshifted_warm_start" in self.faults:
            op = p.op
            p = replace(p, warm_perm_x=torch.arange(op.n, device=dev),
                        warm_perm_y=torch.arange(op.me, device=dev),
                        warm_perm_z=torch.arange(op.mi, device=dev))
        self.params = p
        if "frozen_energy" in self.faults:
            real = self.env._apply_cleared

            def frozen(params, state, action, cleared):
                new, ts = real(params, state, action, cleared)
                ts.info["energy_level"] = state.energy
                return replace(new, energy=state.energy), ts
            self.env._apply_cleared = frozen

    def _episode(self):
        """One synchronisable episode call; its outputs are the graph's,
        rewritten by the next call."""
        from sustaingym_tpu_torch.core import batch_rollout
        mix = self.mix
        ts = batch_rollout(self.env, self.params, self.policy, None,
                           self.gen, mix["batch"], mix["episode_steps"],
                           graphs=self.graphs)
        if "half_batch" in self.faults:
            half = ts.reward.shape[1] // 2
            for v in [ts.reward] + [ts.info[k] for k in OUTPUTS]:
                v[:, half:] = 0.0
        if "altered_output" in self.faults:
            ts.reward[100 % ts.reward.shape[0], 0] += ALTERED
        return ts

    def _keep(self, i: int, state, ts) -> None:
        """Reservoir sampling: after episode ``i`` every episode so far is
        kept with the same chance. A kept episode's outputs are copied out
        of the graph's (the next replay rewrites those)."""
        k = self.mix["check_episodes"]
        j = i if len(self.kept) < k else self.pick.randrange(i + 1)
        if j >= k:
            return
        out = {key: ts.info[key].clone() for key in OUTPUTS}
        out["reward"] = ts.reward.clone()
        # the bids of step t are step t's prev_action (the last step's is
        # overwritten by the next episode's reset)
        out["bids"] = ts.obs["prev_action"][:-1].clone()
        _sync(self.device)
        if len(self.kept) < k:
            self.kept.append((i, state, out))
        else:
            self.kept[j] = (i, state, out)

    def window(self, seconds: float) -> dict:
        dev, times = self.device, []
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            state = self.gen.get_state()
            t = time.perf_counter()
            ts = self._episode()
            _sync(dev)
            t1 = time.perf_counter()
            times.append(t1 - t)
            self._keep(len(times) - 1, state, ts)
            if t1 - t0 >= seconds:
                break
        mix = self.mix
        steps = len(times) * mix["batch"] * mix["episode_steps"]
        return {"attempted": len(times), "step_s": times,
                "samples": {"sim_episode_p95_ms": len(times)},
                "metrics": {"sim_env_steps_per_s": steps / (t1 - t0),
                            "sim_episode_p95_ms": float(np.percentile(
                                np.asarray(times) * 1e3, 95))}}

    def unit(self) -> None:
        """One episode, synchronised as the window calls it (the
        program's pass)."""
        self._episode()
        _sync(self.device)

    def traced(self, seconds: float) -> dict:
        dev, n = self.device, self.mix["trace_episodes"]
        want = n * self.mix["episode_steps"]
        for tries in range(1, TRACE_TRIES + 1):
            trace, solves = self._profiled(n)
            if dev.type != "cuda" or len(solves) >= want:
                break
            print(f"market_episodes: traced window {tries} held "
                  f"{len(solves)} of {want} solve launches",
                  file=sys.stderr, flush=True)
        for i in range(n):
            state = self.gen.get_state()
            self._keep(i, state, self._episode())
        return {"attempted": (tries + 1) * n, "trace": trace,
                "solve": {"episodes": n, "launches": len(solves),
                          "ms": sum(e - s for s, e in solves) * 1e-3},
                "graphs": {"warmup_s": self.graphs.warmup_s,
                           "capture_s": self.graphs.capture_s},
                "program": program.run(self)}

    def _profiled(self, n: int) -> tuple[dict, list]:
        """``n`` episodes under the profiler: the window's breakdown and
        the solve kernel's (start, end) intervals in it."""
        from torch.profiler import profile, record_function
        with profile(activities=devtime.activities(self.device)) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    self._episode()
                _sync(self.device)
        window = [e for e in devtime.host_intervals(prof)
                  if e[2] == "bench.window"][0]
        trace = devtime.breakdown(prof, window[0], window[1])
        solves = [(s, e) for s, e, name in devtime.kernel_intervals(prof)
                  if KERNEL in name and window[0] <= s and e <= window[1]]
        return trace, solves

    def release(self) -> None:
        self.env = self.params = self.gen = self.policy = None
        self.graphs = None

    def check(self, ref_module) -> tuple[dict, dict]:
        """(numbers, extras) over the kept episodes: the program's outputs
        against the reference's on the same days and bids, replayed from
        the generator's state before each episode, which :meth:`stand_in`
        reuses."""
        ref = self.ref = ref_module.Reference(self.config, self.device)
        B, T = self.mix["batch"], self.mix["episode_steps"]
        prec = self.config["precision"]["lp_prec"]
        extras = {"n": ref.n, "me": ref.me, "ms": ref.ms, "batch": B,
                  "solve_iters": ref.solve_iters(T)}
        self.wanted, got = [], []
        for _, state, out in self.kept:
            days, bids = ref.episode_draws(state, B, T)
            want = ref.episode(days, bids, prec)
            self.wanted.append((days, bids, dict(want, bids=bids[:-1])))
            got.append(out)
        self.kept = []
        return self._numbers(got), extras

    def stand_in(self, prec: dict | None = None,
                 fault: str | None = None) -> dict:
        """The numbers with the reference, at the control's precisions
        ``prec`` or with a ``fault`` of ``episode``, standing in the
        program's place (after :meth:`check`)."""
        lp_prec = dict(self.config["precision"], **(prec or {}))["lp_prec"]
        got = []
        for days, bids, _ in self.wanted:
            out = self.ref.episode(days, bids, lp_prec, fault=fault)
            got.append(dict(out, bids=bids[:-1]))
        return self._numbers(got)

    def _numbers(self, got: list) -> dict:
        """``return_gap``: the widest gap of an env's episode total of
        reward, revenue and carbon value over the column's mean
        (``compare.return_gap``); ``price_gap_q99``: the 99th percentile
        over steps and envs of the clearing price's gap, over the mean
        |price|; ``energy_gap``: the widest gap of an env's final battery
        energy, over the capacity; ``bids_gap``: the widest gap between
        the bids the program cleared and those the reference replayed,
        over the largest bid (0: the reference's inputs are the
        program's). Step by step, from the outputs' own price, dispatch
        and energy (``Reference.recompute``): ``reward_step_gap``, the
        widest gap of a step's reward, revenue, carbon value or terminal
        cost to what the env's rules make of them, over that value's size
        plus the column's mean size (at least the reward's);
        ``energy_step_gap``, the widest distance of a step's energy from
        the range that the previous energy and the step's dispatch allow,
        over the capacity."""
        pairs = [(g, days, w) for g, (days, _, w) in zip(got, self.wanted)]

        def cols(o):
            return torch.stack([o["reward"], o["revenue"],
                                o["carbon_value"]], -1)

        def price_q99(g, w):
            ref = w["price"].double()
            gap = (g["price"].double().to(ref.device) - ref).abs()
            return float(torch.quantile(gap.flatten(), 0.99)
                         / ref.abs().mean().clamp_min(1e-30))

        def energy(g, w):
            ref = w["energy_level"][-1].double()
            gap = g["energy_level"][-1].double().to(ref.device) - ref
            return float(gap.abs().max()) / self.ref.capacity

        def bids(g, w):
            ref = w["bids"].double()
            return float((g["bids"].double().to(ref.device) - ref).abs()
                         .max()) / self.ref.max_bid

        steps = [(g, self.ref.recompute(days, g)) for g, days, _ in pairs]

        def reward_steps(g, rec):
            scale = rec["reward"].abs().mean()
            gaps = []
            for key in ("reward", "revenue", "carbon_value",
                        "terminal_cost"):
                r = rec[key]
                gap = (g[key].to(r.device, r.dtype) - r).abs()
                size = r.abs() + torch.maximum(r.abs().mean(), scale)
                gaps.append(float((gap / size.clamp_min(1e-30)).max()))
            return compare.worst(gaps)

        def energy_steps(g, rec):
            e = g["energy_level"].to(rec["energy_lo"].device,
                                     rec["energy_lo"].dtype)
            out = ((rec["energy_lo"] - e).clamp_min(0.0)
                   + (e - rec["energy_hi"]).clamp_min(0.0))
            return compare.worst([float(out.max()) / self.ref.capacity])
        return {"return_gap": compare.worst(compare.return_gap(cols(g),
                                                                cols(w))
                                            for g, _, w in pairs),
                "price_gap_q99": compare.worst(price_q99(g, w)
                                               for g, _, w in pairs),
                "energy_gap": compare.worst(energy(g, w)
                                            for g, _, w in pairs),
                "bids_gap": compare.worst(bids(g, w) for g, _, w in pairs),
                "reward_step_gap": compare.worst(reward_steps(g, rec)
                                                 for g, rec in steps),
                "energy_step_gap": compare.worst(energy_steps(g, rec)
                                                 for g, rec in steps)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
