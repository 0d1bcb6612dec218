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
(utils.checkpoint), as in the JAX package.  `spawn_world` starts a world
of rank processes on this machine and waits for them under a deadline.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.transfer import to_device
from ._comm import all_gather

__all__ = ["initialize", "global_batch_from_host_local", "spawn_world"]

# The repository's root: spawned ranks start there, so that
# `python -m di_hpc_tpu_torch...` and scripts beside the package import it.
ROOT = Path(__file__).resolve().parents[2]


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


def spawn_world(argv, world, timeout, env=None) -> list:
    """Runs `python *argv RANK WORLD` for every rank, from the repository's
    root (in `env`, default this process's), and returns each rank's
    output.  Each rank writes to a file of its own (a pipe left unread
    could stall a rank in a collective), and all are waited on under one
    deadline.  Every process still running at the deadline is killed; a
    rank that fails, or a deadline that passes, raises with the tails of
    the ranks' outputs."""
    with tempfile.TemporaryDirectory() as logs:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w+")
                 for r in range(world)]
        procs = [subprocess.Popen([sys.executable, *argv, str(r),
                                   str(world)], cwd=ROOT, env=env,
                                  stdout=files[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        late = False
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            late = True
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late or bad:
        why = f"passed its {timeout} s deadline" if late else "failed"
        raise RuntimeError(f"a world of {world}: {why}; ranks {bad} "
                           f"ended non-zero:\n" + "\n".join(
                               f"--- rank {r}:\n{outs[r][-4000:]}"
                               for r in range(world) if late or r in bad))
    return outs
