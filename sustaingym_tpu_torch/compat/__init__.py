"""Host-edge compatibility layer: the Gymnasium and PettingZoo APIs over
the port (needs ``gymnasium`` and ``pettingzoo``, which
``import sustaingym_tpu_torch`` does not).

Importing this module registers the port's own Gymnasium IDs:

    sustaingym_torch/Building-v0
    sustaingym_torch/Cogen-v0
    sustaingym_torch/EVCharging-v0
    sustaingym_torch/ElectricityMarket-v0
    sustaingym_torch/DataCenter-v0

It leaves the JAX package's ``sustaingym/*`` IDs alone, so both packages
can be imported in one process. ``gymnasium.make(id, device="cpu")``
passes ``device`` (and any other keyword) to the adapter.
"""
from __future__ import annotations

from .gym import (BuildingGymEnv, CogenGymEnv, DataCenterGymEnv,
                  DiscreteActionWrapper, ElectricityMarketGymEnv,
                  EVChargingGymEnv, FunctionalGymEnv,
                  FunctionalVectorGymEnv, make_vec, to_gym_space)
from .pettingzoo import (MultiAgentBuildingParallelEnv,
                         MultiAgentCogenParallelEnv,
                         MultiAgentEVChargingParallelEnv)

ENV_IDS = {
    "sustaingym_torch/Building-v0": "BuildingGymEnv",
    "sustaingym_torch/Cogen-v0": "CogenGymEnv",
    "sustaingym_torch/EVCharging-v0": "EVChargingGymEnv",
    "sustaingym_torch/ElectricityMarket-v0": "ElectricityMarketGymEnv",
    "sustaingym_torch/DataCenter-v0": "DataCenterGymEnv",
}


def _register() -> None:
    from gymnasium.envs.registration import register, registry
    for env_id, cls in ENV_IDS.items():
        if env_id not in registry:
            register(id=env_id, entry_point=f"{__name__}.gym:{cls}",
                     nondeterministic=False)


_register()

__all__ = [
    "FunctionalGymEnv", "BuildingGymEnv", "CogenGymEnv", "EVChargingGymEnv",
    "ElectricityMarketGymEnv", "DataCenterGymEnv", "DiscreteActionWrapper",
    "FunctionalVectorGymEnv", "make_vec", "to_gym_space", "ENV_IDS",
    "MultiAgentBuildingParallelEnv", "MultiAgentCogenParallelEnv",
    "MultiAgentEVChargingParallelEnv",
]
