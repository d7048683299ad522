"""Data-driven BuildingEnv dynamics identification: the port of
``sustaingym_tpu.envs.building.datadriven``.

Fits next-state = [A_d | BD_d] @ [X; Y] by non-negative least squares
with no intercept over an observed (state, action) trajectory, where
Y = [avg^2, avg, meta^2, meta, ground, out, a / max_power, ghi] (the
reference BuildingEnv.train). The JAX package fits with sklearn's
``LinearRegression(fit_intercept=False, positive=True)``, which solves one
``scipy.optimize.nnls`` per output column; this fit calls ``nnls`` per
zone directly. Returns new ``BuildingParams`` with the identified
matrices and ``data_driven=True``, on the params' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import replace
from .env import BuildingParams

__all__ = ["fit_data_driven"]


def fit_data_driven(params: BuildingParams, states: np.ndarray,
                    actions: np.ndarray, start_epoch: int = 0
                    ) -> BuildingParams:
    """Identifies A_d / BD_d from a trajectory.

    Args:
        params: physics-model params (the source of the exogenous series).
        states: (T+1, n) zone-temperature trajectory.
        actions: (T, n) applied HVAC powers IN WATTS (the reference stores
            ``action * maxpower``).
        start_epoch: epoch of states[0] in the weather arrays.
    """
    from scipy.optimize import nnls

    n = params.n
    out_temp, ground, ghi, meta_arr = (
        getattr(params, k).cpu().numpy()
        for k in ("out_temp", "ground_temp", "ghi", "metabolism"))
    states = np.asarray(states, dtype=np.float64)
    xs, ys = [], []
    for i in range(len(states) - 1):
        x = states[i]
        e = start_epoch + i
        avg = x.sum() / n
        meta = meta_arr[e]
        y = np.concatenate([
            [avg ** 2, avg, meta ** 2, meta, ground[e], out_temp[e]],
            np.asarray(actions[i]) / params.max_power,
            [ghi[e]],
        ])
        xs.append(np.concatenate([x, y]))
        ys.append(states[i + 1])
    X, Y = np.asarray(xs), np.asarray(ys)
    beta = np.stack([nnls(X, Y[:, j])[0] for j in range(Y.shape[1])])

    def t(a):
        return torch.as_tensor(a, dtype=params.A_d.dtype,
                               device=params.device)

    return replace(params, A_d=t(beta[:, :n]), BD_d=t(beta[:, n:]),
                   data_driven=True)
