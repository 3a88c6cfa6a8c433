"""Multi-process runtime: `torch.distributed` wiring.

Port of `distgcn_tpu/parallel/distributed.py`. Each process owns one device
(one card, or the CPU in tests); `initialize` joins the processes into one
process group, and the sharded programs (`parallel/halo.py`,
`parallel/large_sharded.py`, `parallel/mesh.py`) run over it. The JAX
package's global mesh and named shardings have no counterpart: each rank
holds its own slab and the programs exchange slabs with explicit
collectives (NCCL between cards, gloo between CPU processes).

Environment contract (set by the launcher or a scheduler), as in the JAX
package:

    DISTGCN_COORDINATOR   host:port of process 0 (``tcp://host:port``), or
                          a ``scheme://`` init URL such as ``file:///path``
    DISTGCN_NUM_PROCESSES total process count
    DISTGCN_PROCESS_ID    this process's rank

With nothing set, `initialize` returns False and the sharded programs run
as a one-rank ring in this process. The JAX package's TPU-pod auto-detect
(``DISTGCN_DISTRIBUTED=1``) has no counterpart on GPUs: nothing on a GPU
machine tells a process its cluster.

Data convention for host-loaded inputs: every process loads the SAME host
data and `host_to_local` slices its rows (the slice that the JAX
`host_to_global` materialises per device); no broadcast from rank 0.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distgcn_tpu_torch.utils.device import resolve_device

INIT_TIMEOUT_S = 120      # rendezvous and every collective


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group. Arguments default from the DISTGCN_* env
    variables; with nothing set this is a no-op that returns False.

    ``device`` names this process's device and with it the backend: NCCL
    for a CUDA device (default; ``cuda`` without an index takes card
    ``process_id % device_count`` and makes it current), gloo for the CPU.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DISTGCN_COORDINATOR")
    if num_processes is None and "DISTGCN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DISTGCN_NUM_PROCESSES"])
    if process_id is None and "DISTGCN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DISTGCN_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("set the coordinator, the process count and this "
                         "process's id together")
    dev = resolve_device(device)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return True


def rank_world(group=None) -> Tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) with no process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def process_info() -> tuple:
    """(process_id, num_processes, local_devices, global_devices), the
    JAX package's tuple: one device per process."""
    rank, world = rank_world()
    return rank, world, 1, world


def host_to_local(host_array, rank: int, world: int,
                  device=None) -> torch.Tensor:
    """This rank's rows of a host array that every process holds: rows
    ``[rank * n / world, (rank + 1) * n / world)`` on `device`."""
    host_array = np.asarray(host_array)
    n = host_array.shape[0]
    if n % world:
        raise ValueError(f"{n} rows do not split into {world} equal slabs")
    n_loc = n // world
    rows = np.ascontiguousarray(host_array[rank * n_loc:(rank + 1) * n_loc])
    return torch.from_numpy(rows).to(resolve_device(device))


def gather_global(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's slab, concatenated along dim 0 on every rank (an
    all_gather); the slab itself with no process group."""
    _, world = rank_world(group)
    if world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
