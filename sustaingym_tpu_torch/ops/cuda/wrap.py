"""What every kernel wrapper of ``ops/cuda`` does around a launch: decide
by device (a CPU tensor runs the plain version, a CUDA tensor launches the
kernel), check operands, bind the ``ctypes`` signatures and raise on a
launch error."""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["on_card", "check", "ptr", "pad16", "seeded", "env_normals", "bind", "ctas_per_sm",
           "raise_on"]

P, I, U64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_float
PI = ctypes.POINTER(ctypes.c_int)


def on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU, got {x.device}")
    return True


def check(name: str, x: torch.Tensor, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def pad16(v: int) -> int:
    """``v`` rounded up to a multiple of 16 (an mma tile edge)."""
    return -(-v // 16) * 16


def seeded(device, seed: int) -> torch.Generator:
    """The plain versions' generator for ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def env_normals(device, seed: int, t: int, env_offset: int, B: int,
                n: int) -> torch.Tensor:
    """(B, n) N(0, 1) draws of step ``t`` for the global envs
    ``[env_offset, env_offset + B)``: Box–Muller normals of the uniforms
    of a generator seeded by (``seed``, ``t``), env-major. A CPU
    generator fills uniforms in order, so on the CPU an env's draws do not
    depend on the envs before or after it: a launch over a slice of a
    global batch draws that slice's rows (the policy kernels key their
    Philox stream by the global env index for the same reason)."""
    g = seeded(device, (seed + t * 0x9E3779B97F4A7C15) % 2 ** 64)
    u = torch.rand((env_offset + B, n, 2), generator=g,
                   device=device)[env_offset:]
    r = torch.sqrt(-2.0 * torch.log1p(-u[..., 0]))
    return r * torch.cos(2.0 * math.pi * u[..., 1])


_BOUND: dict[str, ctypes.CDLL] = {}


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """Builds or loads ``csrc/<name>.cu`` and declares its functions'
    argument types (once); each returns a cudaError_t."""
    if name not in _BOUND:
        from .build import load_library
        lib = load_library(name)
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _BOUND[name] = lib
    return _BOUND[name]


def ctas_per_sm(fn, *args) -> tuple[int, ...]:
    """Calls a kernel's occupancy query ``fn(*args, int*...)`` and returns
    what it stores: CTAs resident per SM first."""
    out = [ctypes.c_int() for _ in range(len(fn.argtypes) - len(args))]
    raise_on(fn(*args, *(ctypes.byref(o) for o in out)), fn.__name__)
    return tuple(o.value for o in out)


def raise_on(err: int, kernel: str):
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
