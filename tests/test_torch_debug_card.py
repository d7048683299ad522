"""Card test of the debug checks (sustaingym_tpu_torch.utils.debug): a
checked step loop captured as a CUDA graph. Marked ``gpu``; skips without
a card. Imports no JAX, so it runs on the card's machine."""
import pytest
import torch

import chip_smoke
from sustaingym_tpu_torch.core.graph import Graphs, tree_leaves
from sustaingym_tpu_torch.utils import debug

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def test_captured_checked_loop_raises_as_eager(cuda):
    """A checked step loop of ``chip_smoke.NaNEnv`` (its reward NaN after
    step 3) captured as a CUDA graph raises "non-finite reward" after its
    replay, as the eager loop does, and its outputs (the error word
    included) equal the eager loop's bit for bit: no check reads the
    host inside the step."""
    env, batch, steps = chip_smoke.NaNEnv(), 1024, 6
    gen = torch.Generator(device=cuda).manual_seed(0)
    step = debug.checked_step(env, check_bounds=True)
    space = env.action_space(None)

    def loop(state, ts0):
        # the reset's table lacks the step's info entry: merge renumbers
        err, rewards = debug.check_timestep(ts0, space0), []
        for _ in range(steps):
            (state, ts), e = step(None, state, space.sample_batch(gen, batch))
            err = err.merge(e)
            rewards.append(ts.reward)
        return state, torch.stack(rewards), err

    space0 = env.observation_space(None)
    state0, ts0 = env.reset(None, gen, batch)
    start = gen.get_state()
    eager = loop(state0.clone(), ts0)
    gen.set_state(start)
    graphs = Graphs(cuda)
    captured = graphs("nan-loop", loop, state0, ts0, generators=(gen,))
    assert graphs.captures == 1
    for a, b in zip(tree_leaves(eager), tree_leaves(captured)):
        assert a.dtype == b.dtype
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert captured[2].messages == eager[2].messages
    for err in (eager[2], captured[2]):
        with pytest.raises(debug.CheckError, match="non-finite reward"):
            err.throw()


def test_validate_batch_rollout_on_the_card(cuda):
    """The checked rollout of cogen on the card: clean with bounds, and
    its reward sum bit-equal to the unchecked rollout's."""
    from sustaingym_tpu_torch import make
    env, p = make("cogen", device=cuda)
    sums = []
    for armed in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(1)
        sums.append(debug.validate_batch_rollout(
            env, p, gen, batch=256, steps=96, check_bounds=True,
            armed=armed))
    assert torch.equal(sums[0], sums[1]) and torch.isfinite(sums[0])
