"""GMM-sampled EV days in the PyTorch port (sustaingym_tpu_torch.data.
ev_gmm, make_params(trace="gmm")) against the JAX package's data.ev_gmm
and the banks it committed, and the port's simulation tier on a bank
longer than the JAX kernel's 512-day limit."""
import os

import numpy as np
import pytest
import torch

from sustaingym_tpu.data import ev_gmm as jgmm
from sustaingym_tpu.envs import evcharging as jev
from sustaingym_tpu_torch.data import ev_gmm as tgmm
from sustaingym_tpu_torch.data import paths as tpaths
from sustaingym_tpu_torch.envs import evcharging as tev
from sustaingym_tpu_torch.ops.cuda import ev_rollout as K

PERIOD = "Summer 2021"
KEYS = ("ev_data", "ev_station", "ev_mask")


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_sample_gmm_bit_equal(site):
    data = tgmm.load_gmm(site, PERIOD)
    jdata = jgmm.load_gmm(site, PERIOD)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])
    for n, seed in ((40, 0), (7, 123)):
        np.testing.assert_array_equal(
            tgmm.sample_gmm(data["weights"], data["means"],
                            data["covariances"], n, seed),
            jgmm.sample_gmm(jdata["weights"], jdata["means"],
                            jdata["covariances"], n, seed))


@pytest.mark.parametrize("days", [10, 60])
def test_sampled_banks_equal_the_committed_packs(days):
    """Sampling the banks the JAX package committed reproduces them bit for
    bit; build_gmm_trace_pack reads them as they are."""
    path = os.path.join(tpaths.COMMITTED_DIR,
                        f"evgmm_caltech_2021-05-01_2021-08-31_30_{days}_0.npz")
    with np.load(path) as d:
        committed = {k: d[k] for k in KEYS}
    sampled = tgmm.sample_bank("caltech", PERIOD, days)
    read = tgmm.build_gmm_trace_pack("caltech", PERIOD, n_days=days)
    for k in KEYS:
        np.testing.assert_array_equal(sampled[k], committed[k])
        np.testing.assert_array_equal(read[k], committed[k])


def _listings():
    """The files of the port's pack directory (None while it is absent)
    and of the committed one."""
    return {d: set(os.listdir(d)) if os.path.isdir(d) else None
            for d in (tpaths.PACKED_DIR, tpaths.COMMITTED_DIR)}


@pytest.mark.parametrize("site", ["caltech", "jpl"])
def test_uncommitted_bank_matches_jax(site):
    """A 12-day bank (committed by neither package) equals the JAX
    package's, which is asked not to cache it into its data directory;
    the port writes it nowhere."""
    before = _listings()
    want = jgmm.build_gmm_trace_pack(site, PERIOD, n_days=12, cache=False,
                                     requested_energy_cap=40.0)
    got = tgmm.build_gmm_trace_pack(site, PERIOD, n_days=12,
                                    requested_energy_cap=40.0)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["ev_mask"].sum() > 0 and got["ev_data"][..., 3].max() <= 40.0
    assert _listings() == before


def test_make_params_gmm_matches_jax():
    """make_params(trace="gmm") compiles the same step table, MOER pack
    (tiled under the bank) and day info as the JAX package's."""
    _, jp = jev.make_env(site="caltech", trace="gmm", gmm_days=10)
    _, tp = tev.make_env(site="caltech", trace="gmm", gmm_days=10,
                         device="cpu")
    assert tp.n_days == jp.n_days == 10
    for name in ("step_table", "moer", "day_max_profit", "day_num_evs"):
        np.testing.assert_allclose(
            getattr(tp, name).numpy().astype(np.float64),
            np.asarray(getattr(jp, name), np.float64), rtol=0, atol=1e-6,
            err_msg=name)
    with pytest.raises(ValueError, match="trace"):
        tev.make_params(trace="sim", device="cpu")


@pytest.mark.parametrize("proj_method", ["dual", "admm"])
def test_fused_rollout_on_a_600_day_bank(monkeypatch, proj_method):
    """The simulation tier runs ev_segment with either projection operator
    and on a 600-day bank (no 512-day limit, no hand-over to another path):
    prescribed actions on days past 512 give the plain version's rows."""
    env, p = tev.make_env(site="caltech", trace="gmm", gmm_days=600,
                          proj_method=proj_method, proj_iters=6,
                          device="cpu")
    assert p.n_days == 600 and p.moer.shape[0] == 600
    calls = []
    segment = K.ev_segment

    def counted(*args, **kwargs):
        calls.append(args[0].proj)
        return segment(*args, **kwargs)

    monkeypatch.setattr(K, "ev_segment", counted)
    days = torch.tensor([0, 511, 512, 599, 598, 300])
    T = 10
    rng = np.random.default_rng(0)
    acts = torch.from_numpy(
        rng.uniform(0, 1, (T, 6, p.n_stations)).astype(np.float32))
    out = env.fused_rollout(p, 6, T, days=days, actions=acts)
    assert len(calls) == 1 and calls[0] is p.proj
    ref, _ = K.ev_segment_ref(p, days, T, actions=acts)
    torch.testing.assert_close(out.reward, ref[..., 0], rtol=0, atol=0)
    np.testing.assert_array_equal(out.info["max_profit"][0].numpy(),
                                  p.day_max_profit[days].numpy())
