"""Multi-process launch: ``torch.distributed`` wiring (counterpart of the
JAX package's ``parallel/launch.py``).

One process per GPU. :func:`initialize_distributed` joins the process group
once, before any collective, with its values taken in this order:

1. explicit arguments (the ``--coordinator`` / ``--num-processes`` /
   ``--process-id`` flags of ``scripts/train.py``),
2. the ``SEG_COORDINATOR`` / ``SEG_NUM_PROCESSES`` / ``SEG_PROCESS_ID`` env
   vars (as the JAX package reads them),
3. torchrun's env (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
   ``RANK``).

The backend is NCCL for CUDA ranks and gloo for CPU ranks. The port's
collectives are ``all_reduce`` (SUM; MAX for the QAT calibration),
``all_gather`` (ZeRO-1's fresh parameter slices and its checkpoint's
moments) and ``barrier``, which gloo also takes for CUDA tensors, so a test
may run gloo ranks that share one GPU (``chip_smoke.py``'s grid and
multi-rank phases). Collectives time out after ``TIMEOUT_S``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_primary", "barrier", "local_device"]

TIMEOUT_S = 600.0


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: str | torch.device = "cuda") -> tuple[int, int]:
    """Join the process group (idempotent); returns ``(rank, world)``.

    ``coordinator`` is ``host:port`` of rank 0. Without it, ``SEG_COORDINATOR``
    or torchrun's ``MASTER_ADDR``/``MASTER_PORT`` must be set; the world size
    and rank come from the arguments or the env the same way. Raises with
    the missing value's name otherwise."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("SEG_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SEG_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("SEG_PROCESS_ID", "RANK")
    if coordinator:
        init_method = f"tcp://{coordinator}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    else:
        raise ValueError("no coordinator: pass --coordinator host:port or set "
                         "SEG_COORDINATOR (or run under torchrun)")
    if num_processes is None or process_id is None:
        raise ValueError("the world size and this process's rank are needed: "
                         "--num-processes/--process-id, SEG_NUM_PROCESSES/"
                         "SEG_PROCESS_ID or torchrun's WORLD_SIZE/RANK")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def local_device(device: str | torch.device) -> torch.device:
    """This process's device: ``cuda`` becomes ``cuda:<LOCAL_RANK>`` (the
    rank when LOCAL_RANK is unset), modulo the cards this host has, so that
    ranks beyond the cards share them; anything else is returned as is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local = _env_int("LOCAL_RANK")
    local = dist.get_rank() if local is None else local
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def is_primary() -> bool:
    """True on the one process that owns logging and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Block until every rank reaches this point (no-op on one rank)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
