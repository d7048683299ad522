"""Traffic driver ``sim_episodes``: back-to-back batched episodes of the
simulation tier, as an evaluation or a policy sweep runs them.

Each call is one whole episode of ``batch`` envs with in-kernel random
actions (``env.fused_rollout``), reset days and the kernel's seed drawn
from the benchmark's generator. Set-up runs one episode to build and warm
the kernel. The window calls episodes back to back, each synchronised,
until ``--seconds`` have passed; each call's wall time is a sample of the
episode latency. A reservoir drawn from the seed keeps ``check_episodes``
of the window's episodes, with the generator's state before each, for the
comparison.

The traced run profiles ``trace_episodes`` episodes, then times as many
with CUDA events around the kernel's C entry point, and the reservoir
draws from those; then the program's pass (``lib/program.py``) of as
many episodes, which the reservoir does not draw from.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from h100_bench.lib import compare, devtime, program

FAULTS = ("frozen_state", "half_batch", "altered_output")
STAND_IN_FAULTS = FAULTS
LAUNCH = ("ev_segment", "ev_segment_launch")


class Driver:
    UNITS = "trace_episodes"    # the mix's count of episodes a pass
    graphs = None               # the tier captures no CUDA graph

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 faults=()):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.faults = tuple(faults)
        self.kept: list = []         # (index, generator state, outputs)
        self.pick = random.Random(seed)

    def setup(self, trace: bool) -> None:
        from sustaingym_tpu_torch import make
        cfg, dev = self.config, self.device
        self.env, self.params = make(cfg["env"], device=dev, **cfg["make"])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        self._plant()
        self._episode()
        _sync(dev)

    def _plant(self) -> None:
        """Breaks the program underneath for the faults asked for."""
        if "frozen_state" in self.faults:
            from sustaingym_tpu_torch.ops.cuda import ev_rollout
            real = ev_rollout.advance

            def frozen(params, state, action, row):
                return (state,) + tuple(real(params, state, action, row)[1:])
            ev_rollout.advance = frozen
            self.restore = lambda: setattr(ev_rollout, "advance", real)
        real_roll = self.env.fused_rollout

        def broken(*args, **kwargs):
            ts = real_roll(*args, **kwargs)
            if "half_batch" in self.faults:
                half = ts.reward.shape[1] // 2
                for v in (ts.reward, ts.info["profit"],
                          ts.info["carbon_cost"], ts.info["excess_charge"]):
                    v[:, half:] = 0.0
            if "altered_output" in self.faults:
                ts.reward[100, 0] += 1.0
            return ts
        if {"half_batch", "altered_output"} & set(self.faults):
            self.env.fused_rollout = broken

    def _episode(self):
        ts = self.env.fused_rollout(self.params, self.mix["batch"],
                                    self.mix["episode_steps"],
                                    generator=self.gen)
        return (ts.reward, ts.info["profit"], ts.info["carbon_cost"],
                ts.info["excess_charge"])

    def _keep(self, i: int, state, out) -> None:
        """Reservoir sampling: after episode ``i`` every episode so far is
        kept with the same chance."""
        k = self.mix["check_episodes"]
        if len(self.kept) < k:
            self.kept.append((i, state, out))
        else:
            j = self.pick.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, state, out)

    def window(self, seconds: float) -> dict:
        dev, times = self.device, []
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            state = self.gen.get_state()
            t = time.perf_counter()
            out = self._episode()
            _sync(dev)
            t1 = time.perf_counter()
            times.append(t1 - t)
            self._keep(len(times) - 1, state, out)
            del out
            if t1 - t0 >= seconds:
                break
        mix = self.mix
        steps = len(times) * mix["batch"] * mix["episode_steps"]
        return {"attempted": len(times),
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
        from torch.profiler import profile, record_function
        dev, n = self.device, self.mix["trace_episodes"]
        with profile(activities=devtime.activities(dev)) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    with record_function("sim.episode"):
                        self._episode()
                _sync(dev)
        window = [e for e in devtime.host_intervals(prof)
                  if e[2] == "bench.window"][0]
        trace = devtime.breakdown(prof, window[0], window[1])
        spans = []
        with devtime.timed_launches(LAUNCH[1], spans, dev):
            for i in range(n):
                state = self.gen.get_state()
                self._keep(i, state, self._episode())
        return {"attempted": 2 * n, "trace": trace,
                "kernel_ms": {LAUNCH[0]: devtime.span_ms(spans)},
                "program": program.run(self)}

    def release(self) -> None:
        getattr(self, "restore", lambda: None)()
        self.env = self.params = self.gen = None

    def check(self, ref_module) -> tuple[dict, dict]:
        """(numbers, extras) over the kept episodes: the program's outputs
        against the reference's on the same days and kernel seed, which
        :meth:`stand_in` reuses."""
        ref = self.ref = ref_module.Reference(self.config, self.device)
        B = self.mix["batch"]
        prec = self.config["precision"]["env_prec"]
        extras = {"matvecs": {}, "n": ref.n, "m2": 2 * ref.m,
                  "n_days": ref.n_days, "batch": B}
        self.wanted, got = [], []
        for i, state, out in self.kept:
            days, seed, _ = ref.episode_draws(state, B)
            count = torch.zeros((), dtype=torch.long, device=self.device)
            self.wanted.append((days, seed, ref.sim_episode(days, seed, prec,
                                                            count)))
            extras["matvecs"][i] = int(count)
            got.append(torch.stack(out, -1))
        self.kept = []
        return self._numbers(got), extras

    def stand_in(self, prec: dict | None = None,
                 fault: str | None = None) -> dict:
        """The numbers with the reference, at the control's precisions
        ``prec`` or with a ``fault`` of ``sim_episode``, standing in the
        program's place (after :meth:`check`)."""
        env_prec = dict(self.config["precision"], **(prec or {}))["env_prec"]
        return self._numbers([self.ref.sim_episode(days, seed, env_prec,
                                                   fault=fault)
                              for days, seed, _ in self.wanted])

    def _numbers(self, got: list) -> dict:
        return {"return_gap": compare.worst(
            compare.return_gap(g, want)
            for g, (_, _, want) in zip(got, self.wanted))}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
