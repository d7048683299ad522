"""The port's tracer (``sustaingym_tpu_torch/core/trace.py``): with tracing
off the traced paths give the same bits and record nothing; on, the spans
nest as named with their parents and steps, self times add up to the
parent's duration, each counter fires at its site and the snapshot is
JSON. The card-only sites (the kernel wrappers' range check, graph
replays, the spans' CUDA events) are the ``gpu`` test's:

    python -m pytest tests/test_torch_trace.py -q -m gpu
"""
import contextlib
import json
import warnings

import pytest
import torch

from sustaingym_tpu_torch import make
from sustaingym_tpu_torch.core import kernel_seed, trace
from sustaingym_tpu_torch.core import graph as graph_mod
from sustaingym_tpu_torch.core.graph import Graphs
from sustaingym_tpu_torch.parallel import PPOConfig, make_train_step

N_ENVS = 8


def _trainer(path, device="cpu", **kw):
    env, params = make("evcharging", site="caltech", device=device)
    cfg = PPOConfig(num_envs=N_ENVS, hidden=16, minibatches=2, epochs=1,
                    obs_bf16=path == "fused", **kw)
    init_state, step = make_train_step(env, params, cfg, path=path)
    return env, params, cfg, init_state, step


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _train(path, traced: bool):
    """Two train steps from seed 0: the policy's weights and each step's
    metrics."""
    env, params, cfg, init_state, step = _trainer(path)
    gen = _gen(0)
    carry = init_state(gen)
    metrics = []
    with (trace.recording() if traced else contextlib.nullcontext()):
        for _ in range(2):
            metrics.append(step(carry, gen)[1])
    return dict(carry["policy"].state_dict()), metrics


def _rollout(traced: bool):
    env, params = make("evcharging", site="caltech", device="cpu")
    with (trace.recording() if traced else contextlib.nullcontext()):
        ts = env.fused_rollout(params, N_ENVS, 300, generator=_gen(3))
    return [ts.reward, ts.terminated] + [ts.info[k] for k in sorted(ts.info)]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("what", ["fused", "episodic", "fused_rollout"])
def test_tracing_off_gives_the_same_bits_and_records_nothing(what):
    run = _rollout if what == "fused_rollout" else (
        lambda traced: _train(what, traced))
    off = run(False)
    assert trace.active() is None
    assert trace.span("ppo.step") is trace.span("ev.prelaunch")  # no-op
    on = run(True)
    assert _equal(off, on)
    # nothing was kept from the untraced calls
    with trace.recording() as rec:
        pass
    snap = rec.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def _by_name(snap):
    out = {}
    for i, s in enumerate(snap["spans"]):
        out.setdefault(s["name"], []).append(i)
    return out


def test_spans_nest_with_parents_steps_and_self_times():
    env, params, cfg, init_state, step = _trainer("fused")
    gen = _gen(1)
    carry = init_state(gen)
    with trace.recording() as rec:
        step(carry, gen)
        step(carry, gen)
        env.fused_rollout(params, N_ENVS, 288, generator=gen)
    snap = rec.snapshot()
    spans, names = snap["spans"], _by_name(snap)
    parent_of = {"ppo.rollout": "ppo.step", "ppo.score": "ppo.step",
                 "ppo.update": "ppo.step", "ppo.update.perms": "ppo.update",
                 "ev.prelaunch": "ev.fused_rollout"}
    for name, parent in parent_of.items():
        for i in names[name]:
            assert spans[spans[i]["parent"]]["name"] == parent, name
    # the rollout's episode under ppo.rollout; the lone call's at the top
    tops = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in tops] == ["ppo.step", "ppo.step",
                                         "ev.fused_rollout"]
    assert [s["step"] for s in tops] == [0, 1, 2]
    for s in spans:
        if s["parent"] is not None:
            assert s["step"] == spans[s["parent"]]["step"]
        assert s["device_ms"] is None          # the CPU records no events
    kids = [i for i in names["ev.fused_rollout"]
            if spans[i]["parent"] is not None]
    assert len(kids) == 2 and all(
        spans[spans[i]["parent"]]["name"] == "ppo.rollout" for i in kids)
    # a span's self time and its children's durations make its duration,
    # so the self times of a step's spans add up to the step's
    for i, s in enumerate(spans):
        children = sum(c["host_ms"] for c in spans if c["parent"] == i)
        assert s["self_ms"] >= 0
        assert s["self_ms"] + children == pytest.approx(s["host_ms"],
                                                        abs=1e-9)
    for top in (0, 1):
        total = sum(s["self_ms"] for s in spans if s["step"] == top)
        root = next(s for s in tops if s["step"] == top)
        assert total == pytest.approx(root["host_ms"], abs=1e-6)
    # one seed read an episode: two train steps and the lone episode
    assert snap["counters"] == {"host_syncs.kernel_seed": 3}
    assert set(snap["launches"]) >= {"ev_segment", "ev_policy_segment"}
    assert json.loads(json.dumps(snap)) == snap


def test_counters_fire_at_their_sites(monkeypatch):
    """``graphs.replays.<slot>`` adds each call's ``repeat`` (a card's
    replay path, its graph a stand-in); ``host_syncs.kernel_seed`` counts
    each seed read; ``ev.prelaunch`` ends where the kernel wrapper
    launches (here its plain version)."""
    replays = []

    class FakeGraph:
        def replay(self):
            replays.append(1)

    def fake_capture(self, fn, inputs, generators, state):
        return graph_mod._Captured(graph=FakeGraph(),
                                   inputs=graph_mod._tree_clone(inputs),
                                   outputs=(), fn=fn, state=(),
                                   launches=())

    monkeypatch.setattr(Graphs, "on_card", property(lambda self: True))
    monkeypatch.setattr(Graphs, "_capture", fake_capture)
    monkeypatch.setattr(Graphs, "_held_bytes", lambda self: 0)
    graphs = Graphs("cpu")
    x = torch.ones(2)
    graphs("k", lambda t: t, x, repeat=3, slot="update")
    with trace.recording() as rec:
        graphs("k", lambda t: t, x, repeat=4, slot="update")
        graphs(("k", 1), lambda t: t, x, slot=("rollout", True))
        kernel_seed(_gen(0))
        kernel_seed(_gen(1))
    snap = rec.snapshot()
    assert len(replays) == 3 + 4 + 1
    assert snap["counters"] == {"graphs.replays.update": 4,
                                "graphs.replays.rollout.True": 1,
                                "host_syncs.kernel_seed": 2}
    tags = [(s["name"], s["tag"]) for s in snap["spans"]]
    assert tags == [("graphs.replay", "update"),
                    ("graphs.replay", "rollout.True")]

    env, params = make("evcharging", site="caltech", device="cpu")
    from sustaingym_tpu_torch.ops.cuda import ev_rollout
    real = ev_rollout.ev_segment_ref
    seen = {}

    def plain(*args, **kwargs):
        seen["open"] = [rec2.spans[i].name for i in rec2.stack]
        return real(*args, **kwargs)

    monkeypatch.setattr(ev_rollout, "ev_segment_ref", plain)
    with trace.recording() as rec2:
        env.fused_rollout(params, 2, 288, generator=_gen(2))
    assert seen["open"] == ["ev.fused_rollout"]   # prelaunch closed
    names = [s["name"] for s in rec2.snapshot()["spans"]]
    assert names == ["ev.fused_rollout", "ev.prelaunch"]


def test_recordings_do_not_nest_and_close_what_is_left_open():
    with trace.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
        trace.begin("ev.prelaunch")
        with trace.span("outer"):
            trace.begin("inner")          # never ended: closed by outer
        trace.end("no such span")         # not the innermost: no-op
    assert trace.active() is None
    snap = rec.snapshot()
    assert [(s["name"], s["parent"]) for s in snap["spans"]] == [
        ("ev.prelaunch", None), ("outer", 0), ("inner", 1)]
    assert all(s["host_ms"] is not None for s in snap["spans"])
    # a slot of core.rollout.episode_loop: function, integers, shapes
    assert trace.label((trace.label, 288, (4, 2))) == "label.288"


@pytest.mark.gpu
def test_sync_warnings_equal_the_host_sync_counters():
    """One captured fused train step and one simulation episode on the
    card under ``torch.cuda.set_sync_debug_mode("warn")``: each
    synchronising call warns once, and the ``host_syncs`` counters count
    the same calls; every span holds device time; the graphs' pool
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    env, params, cfg, init_state, step = _trainer("fused", dev)
    gen = _gen(0, dev)
    carry = init_state(gen)
    step(carry, gen)                      # captures the graphs
    torch.cuda.synchronize()
    assert step.graphs.pool_bytes > 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with trace.recording() as rec:
                step(carry, gen)
                env.fused_rollout(params, N_ENVS, 288, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    snap = rec.snapshot()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    counted = {k: v for k, v in snap["counters"].items()
               if k.startswith("host_syncs.")}
    assert counted == {"host_syncs.kernel_seed": 2,
                       "host_syncs.ev_days_min": 2,
                       "host_syncs.ev_days_max": 2}
    assert len(syncs) == sum(counted.values()), [str(w.message)
                                                  for w in syncs]
    assert snap["counters"]["graphs.replays.update"] == \
        cfg.epochs * cfg.minibatches
    assert snap["counters"]["graphs.replays.score"] == 1
    device_spans = {"ppo.step", "ppo.rollout", "ppo.score", "ppo.update",
                    "ev.fused_rollout"}
    for s in snap["spans"]:
        assert (s["device_ms"] is not None) == (s["name"] in device_spans)
    assert snap["launches"]["ev_policy_segment"] == 1
    assert snap["launches"]["ev_segment"] == 1
