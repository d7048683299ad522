"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use (``build.py``)."""
