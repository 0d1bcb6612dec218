"""Parallelism layer on torch.distributed: rank meshes, batch-sharded
losses, time-sharded scans; the counterpart of the JAX package's parallel.

The JAX package gets its collectives from GSPMD and `shard_map`; here a
mesh spans the ranks of a process group (gloo or NCCL, parallel.initialize)
and every collective is explicit, all of them in one helper
(parallel._comm: all-gathers, and means and sums taken in rank order so
that every rank gets the same bits).  Functions take the global tensors on
every rank and return the global result; the local work runs the port's
ops and kernels on this rank's shard (kernel 6 for each time chunk,
kernels 2 and 3 under a data-parallel V-trace on the card).
"""

from .mesh import (
    DATA_AXIS,
    TIME_AXIS,
    MODEL_AXIS,
    make_mesh,
    batch_sharding,
    shard_batch_pytree,
    replicated,
    shard_params,
    gather_params,
)
from .dscan import (
    linear_recurrence_reverse_sharded,
    linear_recurrence_forward_sharded,
)
from .api import (
    data_parallel,
    gae_time_sharded,
    lambda_returns_time_sharded,
    lstm_param_shardings,
    td_lambda_error_time_sharded,
    upgo_loss_time_sharded,
    vtrace_error_time_sharded,
)
from .runtime import initialize, global_batch_from_host_local, spawn_world
