"""Multi-process runtime initialization, the counterpart of the JAX
package's parallel/runtime.py.

The contract follows JAX's:

 1. every process calls `initialize()` before it builds a mesh;
 2. tensors are global: every rank holds the same global tensors and the
    parallel functions compute on this rank's shard, with explicit
    collectives (parallel._comm);
 3. per-process data loading feeds the global batch through
    `global_batch_from_host_local`, which gathers every rank's piece.

The backend is NCCL when each rank has a card of its own (the card count
covers the world) and gloo otherwise: NCCL refuses two ranks on one card,
so several ranks sharing one card, or ranks on the CPU, take gloo.  A lost
process fails the step; restart and checkpoint restore is the recovery path
(utils.checkpoint), as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.transfer import to_device
from ._comm import all_gather

__all__ = ["initialize", "global_batch_from_host_local"]


def _backend_for(num_processes: int) -> str:
    """"nccl" when every rank can have a card of its own, else "gloo"."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the default process group (no-op on a single process).

    `coordinator_address` is "host:port" (a TCP rendezvous, as JAX's) or a
    URL such as "file:///path/store"; without it, the process group reads
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the environment.
    Under NCCL each rank takes card `process_id % device_count`.
    """
    if num_processes is not None and num_processes <= 1:
        return
    world = (num_processes if num_processes is not None
             else int(os.environ["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    backend = _backend_for(world)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def global_batch_from_host_local(mesh, sharding_spec, host_local_batch):
    """Assemble the global tensor from every rank's local piece.

    `sharding_spec` names, per dimension, the mesh axis it is sharded over
    (None: not sharded), as a PartitionSpec does; each sharded dimension is
    gathered over its axis in rank order.  The piece lands on the mesh's
    device with the JAX package's transfer dtypes (utils.transfer).
    """
    x = to_device(torch.as_tensor(host_local_batch), mesh.device)
    for dim, axis in enumerate(sharding_spec):
        if axis is not None:
            x = all_gather(x, mesh, axis, dim)
    return x
