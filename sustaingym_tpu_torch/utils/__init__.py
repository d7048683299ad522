"""Host-side helpers (NumPy only)."""
from .epw import read_epw

__all__ = ["read_epw"]
