"""Multi-process initialization on ``torch.distributed``.

Counterpart of ``lantern_tpu/parallel/dist.py``.  The JAX module hands the
rendezvous to ``jax.distributed.initialize``; here the processes join one
``torch.distributed`` process group with the same conventions: explicit
arguments, then ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` (what ``torchrun`` sets), then ``SLURM_NPROCS`` /
``SLURM_PROCID``, then a single process.

One process drives one device.  The default backend is NCCL on
``cuda:LOCAL_RANK``; gloo runs only where the caller names it
(``backend="gloo"``, or ``device="cpu"``).  A failed NCCL init raises: it
never drops to gloo or the CPU.  NCCL refuses two ranks on one device, so
two processes sharing one card pass ``backend="gloo"``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist


def resolve(coordinator: Optional[str] = None,
            num_processes: Optional[int] = None,
            process_id: Optional[int] = None, env=None):
    """``(init_method, num_processes, process_id)`` by the JAX function's
    precedence: explicit arguments win, the environment fills the gaps.
    ``num_processes`` is None for a lone process that named no world.
    ``coordinator`` is ``host:port`` or a URL (``tcp://``, ``file://``,
    ``env://``)."""
    env = os.environ if env is None else env
    if num_processes is None:
        if "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        elif "SLURM_NPROCS" in env:
            num_processes = int(env["SLURM_NPROCS"])
    if process_id is None:
        if "RANK" in env:
            process_id = int(env["RANK"])
        elif "SLURM_PROCID" in env:
            process_id = int(env["SLURM_PROCID"])
        elif num_processes is not None:
            process_id = 0
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = (f"{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '1234')}")
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    return coordinator, num_processes, process_id


def local_device(env=None) -> torch.device:
    """``cuda:LOCAL_RANK`` (``SLURM_LOCALID`` under SLURM; 0 alone)."""
    env = os.environ if env is None else env
    idx = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0")))
    return torch.device("cuda", idx)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None) -> dict:
    """Join the process group, or stay a single process when no world is
    named (no argument, no ``WORLD_SIZE`` / ``SLURM_NPROCS``).  A named
    world of one joins too, so NCCL is exercised on a lone card.

    ``device``: this process's device (default ``cuda:LOCAL_RANK``);
    ``backend``: default NCCL, or gloo where ``device`` is the CPU.
    Returns ``{"process_id", "num_processes", "local_devices",
    "global_devices"}`` (``torch.device``s; ``global_devices`` by rank)."""
    init, n, pid = resolve(coordinator, num_processes, process_id)
    dev = local_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: CUDA device requested but torch.cuda is "
                "not available; pass device='cpu' to run over gloo")
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("init_distributed: NCCL needs a CUDA device")
    if n is not None and not tdist.is_initialized():
        tdist.init_process_group(backend=backend, world_size=n, rank=pid,
                                 init_method=init or "env://")
    if not tdist.is_initialized():
        return {"process_id": 0, "num_processes": 1, "local_devices": [dev],
                "global_devices": [dev]}
    world = tdist.get_world_size()
    # the first collective: a backend that cannot run raises here
    devs = [None] * world
    tdist.all_gather_object(devs, str(dev))
    return {"process_id": tdist.get_rank(), "num_processes": world,
            "local_devices": [dev],
            "global_devices": [torch.device(d) for d in devs]}


def is_main_process() -> bool:
    return not tdist.is_initialized() or tdist.get_rank() == 0


def _collective_device() -> torch.device:
    """Where a collective's tensor lives: the current card under NCCL, the
    host otherwise."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_mean(value: float) -> float:
    """Mean of a scalar over the processes (an f64 all-reduce divided by the
    world size); the identity for one process."""
    if not tdist.is_initialized() or tdist.get_world_size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_collective_device())
    tdist.all_reduce(t)
    return float(t.item()) / tdist.get_world_size()


def shard_requests(items, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None):
    """This process's share of ``items``: ``items[pid::n]`` (item ``i`` goes
    to process ``i % n``)."""
    initialized = tdist.is_initialized()
    pid = (tdist.get_rank() if initialized else 0) if process_id is None \
        else process_id
    n = (tdist.get_world_size() if initialized else 1) \
        if num_processes is None else num_processes
    return items[pid::n]
