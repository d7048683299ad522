"""Stochastic ambient-feature generator for BuildingEnv.

A NumPy copy of ``sustaingym_tpu.envs.building.stochastic``, draw for draw
(the same ``default_rng(seed)`` calls in the same order): fit
block-multivariate-normal distributions to each ambient feature (out-temp,
GHI, ground-temp) separately for winter (January) and summer (July), blend
the season means and covariances by ``summer_frac``, and draw block-shaped
samples.
"""
from __future__ import annotations

import numpy as np

__all__ = ["StochasticAmbientGenerator", "generate_stochastic_ambients"]


class StochasticAmbientGenerator:
    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._season_stats: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}

    def split_seasons(self, data: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """winter = first 1/12 of the year (January), summer = the months
        6-7 window."""
        n = data.shape[0]
        winter = data[: n // 12]
        summer = data[n // 12 * 6: n // 12 * 7]
        self._fit("winter", winter)
        self._fit("summer", summer)
        return summer, winter

    def _fit(self, season: str, obs: np.ndarray) -> None:
        num_obs, num_features = obs.shape
        b = self.block_size
        assert b < num_obs, "Block size should be less than number of obs"
        stats = []
        for i in range(num_features):
            col = obs[:, i][: (num_obs // b) * b]
            blocks = col.reshape(b, num_obs // b, order="F")
            stats.append((blocks.mean(axis=1), np.cov(blocks)))
        self._season_stats[season] = stats

    def sample(self, num_samples: int, summer_frac: float,
               rng: np.random.Generator) -> np.ndarray:
        """Blend season distributions and draw (num_samples, n_features)."""
        if not (0 <= summer_frac <= 1):
            raise ValueError("`summer_frac` must be between 0 and 1")
        summer = self._season_stats["summer"]
        winter = self._season_stats["winter"]
        b = self.block_size
        num_blocks = num_samples // b + 1
        cols = []
        for (mu_s, cov_s), (mu_w, cov_w) in zip(summer, winter):
            mu = mu_s * summer_frac + (1 - summer_frac) * mu_w
            cov = cov_s * summer_frac + (1 - summer_frac) * cov_w
            draws = rng.multivariate_normal(
                mu, cov, size=num_blocks, check_valid="ignore")
            cols.append(draws.reshape(-1)[:num_samples])
        return np.stack(cols, axis=1)


def generate_stochastic_ambients(summer_frac: float, num_rows: int,
                                 data: np.ndarray, block_size: int,
                                 seed: int | None = None) -> np.ndarray:
    """Functional wrapper: fit the seasons of ``data``, draw ``num_rows``
    rows from ``default_rng(seed)``."""
    gen = StochasticAmbientGenerator(block_size)
    gen.split_seasons(data)
    rng = np.random.default_rng(seed)
    return gen.sample(num_rows, summer_frac, rng)
