"""Traffic driver ``ppo_train``: back-to-back PPO train steps of one
trainer, as a training run makes them.

Set-up builds the program's train step (``make_train_step``), loads the
benchmark's initial weights into its policy, and drives it through the
mix's ``check_steps`` first steps with the window's own call and
generator; the comparison follows those steps. The measured window runs
further steps of the same object until ``--seconds`` have passed, each
synchronised, and counts ``num_envs x rollout_len`` env-steps a step.

The traced run drives the step's three phases apart, each synchronised
(``train_step.rollout``, ``.score``, ``.update``, as the program exposes
them), under ``torch.profiler``; then the program's pass
(``lib/program.py``) of whole train steps on the same trainer.
"""
from __future__ import annotations

import time

import torch

from h100_bench.lib import compare, devtime, program
from h100_bench.reference import ppo as ref_ppo

FAULTS = ("frozen_state", "half_batch", "altered_reward")
# a state left unchanged reads 1 in change_gap by its definition: no run
STAND_IN_FAULTS = ("half_batch", "altered_reward")
# the kernel the fused rollout launches, and its C entry point
LAUNCH = ("ev_policy_segment", "ev_policy_segment_launch")


class Driver:
    UNITS = "trace_steps"       # the mix's count of train steps a pass

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 faults=()):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.faults = tuple(faults)
        self.hp = dict(config["learner"], num_envs=mix["num_envs"],
                       epochs=mix["epochs"], minibatches=mix["minibatches"])
        self.kernel_spans: list = []

    # ---- set-up ---------------------------------------------------------
    def setup(self, trace: bool) -> None:
        from sustaingym_tpu_torch import make
        from sustaingym_tpu_torch.core import flatdim
        from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step
        from sustaingym_tpu_torch.parallel import ppo as prog_ppo
        cfg, mix, dev = self.config, self.mix, self.device
        env, params = make(cfg["env"], device=dev, **cfg["make"])
        self.env = env
        pcfg = PPOConfig(num_envs=mix["num_envs"],
                         rollout_len=mix["rollout_len"],
                         hidden=cfg["policy"]["hidden"], epochs=mix["epochs"],
                         minibatches=mix["minibatches"],
                         obs_bf16=mix["obs_bf16"], **cfg["learner"])
        real_loss = prog_ppo.loss_fn
        if "half_batch" in self.faults:

            def half_loss(policy, batch, *a, **k):
                rows = batch["logp"].shape[0] // 2
                return real_loss(policy, {key: v[:rows] for key, v in
                                          batch.items()}, *a, **k)
            prog_ppo.loss_fn = half_loss
        init_state, step = make_train_step(env, params, pcfg, path="fused")
        self.step = step
        carry = init_state(_generator(dev, self.seed + 1))
        policy = carry["policy"]
        self.w0 = ref_ppo.init_weights(
            flatdim(env.observation_space(params)),
            int(env.action_space(params).shape[-1]), cfg["policy"]["hidden"],
            self.seed, dev)
        with torch.no_grad():
            for name, p in policy.named_parameters():
                p.copy_(self.w0[name])
        if "frozen_state" in self.faults:
            carry["opt"].step = lambda *a, **k: None
        self.carry = carry
        self.gen = _generator(dev, self.seed + 2)
        self.record = {"u": [], "reward": [], "loss": []}
        self.gen_states = []
        layout = env.fused_layout(params)
        u_lo, n = layout["u_lo"], int(env.action_space(params).shape[-1])
        real_unroll = env.fused_policy_unroll

        def recording(*args, **kwargs):
            out = real_unroll(*args, **kwargs)
            if "altered_reward" in self.faults:
                out["reward"][100, 0] += 1.0
            self.record["u"].append(_host(out["lrn"][..., u_lo:u_lo + n]))
            self.record["reward"].append(_host(out["reward"]))
            return out

        env.fused_policy_unroll = recording
        try:
            for k in range(mix["check_steps"]):
                self.gen_states.append(self.gen.get_state())
                with devtime.timed_launches(LAUNCH[1],
                                            self.kernel_spans,
                                            dev if trace and k else None):
                    _, metrics = step(carry, self.gen)
                self.record["loss"].append(
                    [float(metrics[key]) for key in
                     ("pg_loss", "vf_loss", "entropy")])
                if k == 0:
                    opt = carry["opt"]
                    self.record["m1"] = {
                        name: _host(opt.state[p].get("exp_avg",
                                                     torch.zeros_like(p)))
                        for name, p in policy.named_parameters()}
        finally:
            del env.fused_policy_unroll
            prog_ppo.loss_fn = real_loss
        self.record["w_end"] = {name: _host(p) for name, p in
                                policy.named_parameters()}
        self.kernel_ms = devtime.span_ms(self.kernel_spans)
        self.kernel_spans = []
        _sync(dev)

    # ---- the measured window --------------------------------------------
    def window(self, seconds: float) -> dict:
        carry, gen, step, dev = self.carry, self.gen, self.step, self.device
        mix = self.mix
        _sync(dev)
        times, t0 = [], time.perf_counter()
        t1 = t0
        while True:
            step(carry, gen)
            _sync(dev)
            t, t1 = t1, time.perf_counter()
            times.append(t1 - t)
            if t1 - t0 >= seconds:
                break
        rate = len(times) * mix["num_envs"] * mix["rollout_len"] / (t1 - t0)
        return {"attempted": len(times), "step_s": times,
                "metrics": {"train_env_steps_per_s": rate}}

    def unit(self) -> None:
        """One train step, synchronised as the window calls it (the
        program's pass)."""
        self.step(self.carry, self.gen)
        _sync(self.device)

    @property
    def graphs(self):
        """The train step's ``Graphs`` (None where it captures none)."""
        return self.step.graphs

    def traced(self, seconds: float) -> dict:
        """``trace_steps`` steps, phase by phase, under the profiler; then
        the program's pass of as many whole steps."""
        from torch.profiler import profile, record_function
        carry, gen, step, dev = self.carry, self.gen, self.step, self.device
        policy, opt = carry["policy"], carry["opt"]
        spans = {"rollout": [], "score": [], "update": []}

        def phase(name, fn, *args):
            with record_function(f"train_step.{name}"):
                _sync(dev)
                t = time.perf_counter()
                out = fn(*args)
                _sync(dev)
                spans[name].append(time.perf_counter() - t)
            return out

        _sync(dev)
        with profile(activities=devtime.activities(dev)) as prof:
            with record_function("bench.window"):
                for _ in range(self.mix["trace_steps"]):
                    out = phase("rollout", step.rollout, policy, gen, carry)
                    samples = phase("score", step.score, policy, out)
                    phase("update", step.update, policy, opt, samples, gen)
                    del out, samples
                _sync(dev)
        window = [e for e in devtime.host_intervals(prof)
                  if e[2] == "bench.window"][0]
        trace = devtime.breakdown(prof, window[0], window[1])
        graphs = step.graphs
        return {"attempted": self.mix["trace_steps"], "spans": spans,
                "trace": trace,
                "graphs": None if graphs is None else {
                    "warmup_s": graphs.warmup_s,
                    "capture_s": graphs.capture_s},
                "kernel_ms": {LAUNCH[0]: self.kernel_ms},
                "program": program.run(self)}

    def release(self) -> None:
        """Drops the program's state before the reference runs."""
        for name in ("carry", "step", "env", "gen"):
            setattr(self, name, None)

    # ---- the comparison -------------------------------------------------
    def check(self, ref_module) -> tuple[dict, dict]:
        """(numbers, extras): the gaps between the program's recorded
        steps and the reference's, which :meth:`stand_in` reuses."""
        self.env_ref = ref_module.Reference(self.config, self.device)
        self.ref = ref_ppo.follow(self.env_ref, self.hp, self.w0,
                                  self.gen_states, **self.config["precision"])
        prog = self._prog()
        er = self.env_ref
        extras = {"matvecs": [int(c) for c in self.ref["count"]],
                  "obs_dim": er.obs_dim, "n": er.n, "m2": 2 * er.m,
                  "n_days": er.n_days}
        return self._numbers(prog), extras

    def _prog(self) -> dict:
        return dict(self.record, delta={
            k: self.record["w_end"][k].to(self.device).float() - self.w0[k]
            for k in self.w0})

    def stand_in(self, prec: dict | None = None,
                 fault: str | None = None) -> dict:
        """The numbers with the reference, at the control's precisions
        ``prec`` or with a ``fault`` of ``ref_ppo.follow``, standing in
        the program's place (after :meth:`check`)."""
        prog = ref_ppo.follow(self.env_ref, self.hp, self.w0,
                              self.gen_states,
                              **dict(self.config["precision"], **(prec or {})),
                              fault=fault)
        self.last_stand_in = prog
        return self._numbers(prog)

    def _numbers(self, prog: dict) -> dict:
        """The rollout of the first step (the same weights and draws on
        both sides), the value loss of the first step alone (the steadiest
        from seed to seed) and of every step, Adam's first moment after
        the first step and each leaf's change over all of them (worst
        leaf)."""
        ref = self.ref
        return {
            "u_gap": compare.mean_abs_gap(prog["u"][0], ref["u"][0]),
            "return_gap": compare.return_gap(prog["reward"][0],
                                             ref["reward"][0]),
            "vf_loss1_gap": compare.loss_gap(prog["loss"][:1],
                                             ref["loss"][:1], 1),
            "vf_loss_gap": compare.loss_gap(prog["loss"], ref["loss"], 1),
            "adam_m1_gap": compare.leaf_norm_gap(prog["m1"], ref["m1"]),
            "change_gap": compare.leaf_norm_gap(prog["delta"], ref["delta"],
                                                ref["m1"]),
        }

    def diagnostics(self, prog: dict | None = None) -> dict:
        """Per step and per leaf readings behind the numbers."""
        prog, ref = prog or self._prog(), self.ref
        return {
            "u_gap_steps": [compare.mean_abs_gap(p, r) for p, r in
                            zip(prog["u"], ref["u"])],
            "return_gap_steps": [compare.return_gap(p, r) for p, r in
                                 zip(prog["reward"], ref["reward"])],
            "loss_steps": {"program": prog["loss"], "reference": ref["loss"]},
            "m1_leaves": compare.leaf_gaps(prog["m1"], ref["m1"]),
            "change_leaves": compare.leaf_gaps(prog["delta"], ref["delta"]),
        }


def _host(x: torch.Tensor) -> torch.Tensor:
    """A copy in host memory (a copy on the CPU too: the program goes on
    writing its tensors in place)."""
    return x.detach().to("cpu", copy=True)


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
