"""The process group and the seed contract: ``sustaingym_tpu.parallel.
distributed`` on ``torch.distributed``.

The JAX package runs one SPMD program over a global device mesh, and its
only host-side machinery is the process group's bootstrap and a seed
contract. The port runs one process a rank (``parallel/mesh.py`` lays the
ranks out as a (dp, mp) mesh) and keeps the same two pieces:

1. **Process-group init** (:func:`init_distributed`): one
   ``torch.distributed.init_process_group`` a process, from explicit
   arguments or from torchrun's ``RANK`` / ``WORLD_SIZE`` /
   ``MASTER_ADDR``. The backend is NCCL only where every rank of the host
   has a card of its own; otherwise gloo, which runs on the CPU and lets
   several ranks share one card (NCCL refuses two ranks on one GPU). The
   choice is printed and never switched.

2. **The seed contract**: the same global seed gives the same global
   batch for any rank count, and rank r of R owns rows ``[r B / R, (r + 1)
   B / R)`` of it. The port keeps it by drawing every env-batch draw at
   the global size and keeping the rank's rows (``core.env_shard``, which
   the learners enter under a mesh; the kernels key their Philox streams
   by the global env index): every rank's generator then stays in the
   state of the one-rank run, at the cost of R times the draws.
   :func:`process_rows` is the slice arithmetic; a batch that R does not
   divide raises ``ValueError`` (not an assert, which ``python -O``
   drops).

A run of one process with no coordinator configured skips the init, and
every helper degrades to the one-rank case.
"""
from __future__ import annotations

import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["init_distributed", "is_distributed", "world", "choose_backend",
           "process_rows", "process_local_batch", "spawn", "free_port"]


def choose_backend(world_size: int, device="cuda") -> tuple[str, str]:
    """(backend, reason): NCCL where every rank of the host has a card of
    its own, gloo otherwise (the CPU, or ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo", "the ranks run on the CPU"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count()
    if cards >= local:
        return "nccl", f"{local} ranks on this host, {cards} cards"
    return "gloo", (f"{local} ranks share {cards} card(s); NCCL needs a "
                    f"card a rank")


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None, device="cuda") -> bool:
    """Joins (or creates) the process group; idempotent. Returns whether
    a group of more than one process is up.

    With no arguments it reads torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``); explicit arguments
    serve a spawned group (``init_distributed("tcp://localhost:29500",
    2, rank)``). A run of one process with no coordinator configured does
    nothing, so library code may call it unconditionally. ``backend``
    None is :func:`choose_backend`'s for ``device``; the choice is
    printed."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and (world_size or 1) == 1:
        return False                # one process, no coordinator
    if init_method is None or world_size is None or rank is None:
        raise ValueError(
            f"init_distributed: init_method={init_method!r}, world_size="
            f"{world_size!r}, rank={rank!r}: give all three, or run under "
            f"torchrun")
    reason = "asked for"
    if backend is None:
        backend, reason = choose_backend(world_size, device)
    print(f"init_distributed: rank {rank} of {world_size}, backend "
          f"{backend} ({reason}), {init_method}", flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return world_size > 1


def is_distributed() -> bool:
    """Whether a process group of more than one process is up."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_rows(global_batch: int, index: int, count: int) -> slice:
    """The rows ``[index B / count, (index + 1) B / count)`` of a global
    batch of ``B`` that process ``index`` of ``count`` owns."""
    local = process_local_batch(global_batch, count)
    if not 0 <= index < count:
        raise ValueError(f"process index {index} outside 0..{count - 1}")
    return slice(index * local, (index + 1) * local)


def process_local_batch(global_batch: int, count: int | None = None) -> int:
    """One process's share of a global batch over ``count`` processes
    (default: the world size); it must divide evenly."""
    if count is None:
        count = world()[1]
    if count < 1 or global_batch % count != 0:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"process count {count}")
    return global_batch // count


def free_port() -> int:
    """A free TCP port on localhost for a spawned group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, port, backend, device, args, results):
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores (and whatever else runs on
        # them): one thread each, not a spinning pool of all of them
        torch.set_num_threads(1)
        torch.set_num_interop_threads(1)
    try:
        init_distributed(f"tcp://localhost:{port}", nprocs, rank, backend,
                         device)
        results.put((rank, True, fn(*args)))
    except BaseException:               # reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), device="cuda",
          backend: str | None = None, timeout: float = 120.0) -> list:
    """Runs ``fn(*args)`` in ``nprocs`` fresh processes (the ``spawn``
    start method), each rank of one process group on a free localhost
    port (:func:`init_distributed`; the backend as :func:`choose_backend`
    picks it for ``device``); returns their results by rank. ``fn`` and
    its results must pickle. A rank that raises, or a group that does not
    finish within ``timeout`` seconds, raises here; every process is
    stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, nprocs, port, backend, device, args, results))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(nprocs):
            rank, ok, value = results.get(timeout=timeout)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except queue.Empty:
        errors.append(f"the group did not finish within {timeout} s")
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
    return [out[r] for r in range(nprocs)]
