"""Core runtime: dataclass helpers, spaces and the env protocol."""
from .env import FunctionalEnv, TimeStep
from .spaces import Box, DictSpace, Space, flatdim, flatten
from .struct import dataclass, replace

__all__ = ["FunctionalEnv", "TimeStep", "Box", "DictSpace", "Space",
           "flatdim", "flatten", "dataclass", "replace"]
