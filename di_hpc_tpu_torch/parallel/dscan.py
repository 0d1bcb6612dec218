"""Time-sharded (sequence-parallel) linear recurrences, the counterpart of
the JAX package's parallel/dscan.py.

T is split over a mesh axis and the recurrence y_t = a_t + b_t * y_{t+1}
runs blockwise:

 1. each rank solves its own chunk with a zero terminal condition through
    the port's scan core (`ops.scan.linear_recurrence_reverse`, "auto": on
    a float32 (T, B) CUDA chunk that is kernel 6, csrc/linear_scan.cu) and
    forms the chunk's suffix products;
 2. one all-gather over the axis brings every chunk's affine map (b_prod,
    a) to every rank (parallel._comm);
 3. every rank composes the maps of the chunks after (resp. before) its own
    with the associative method to get its incoming carry, then applies the
    carry through its suffix (resp. prefix) products.

The boundary exchange is O(K * B) while the local work is O(T/K * B).
Every rank passes the global (T, ...) tensors and gets the global result;
an optional batch axis also shards dim 1.

Gradients flow as through JAX's: where an input needs one, the scan core
takes its differentiable associative method for the local chunk, and the
gather of the chunk maps sums every rank's gradient of each map
(`all_gather(..., each_own=True)`), since each rank reads only the carry
of its own chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.scan import linear_recurrence_forward, linear_recurrence_reverse
from ._comm import all_gather, shard

__all__ = ["linear_recurrence_reverse_sharded",
           "linear_recurrence_forward_sharded"]


def _chunk_maps(b_prod_edge, y_edge, mesh, axis):
    """Every chunk's map (b_prod, a) at its edge row, (K, ...) each."""
    maps = all_gather(torch.stack([b_prod_edge, y_edge])[None], mesh, axis, 0,
                      each_own=True)
    return maps[:, 0], maps[:, 1]


def reverse_local(a_loc, b_loc, mesh, axis: str) -> torch.Tensor:
    """y on this rank's chunk of y_t = a_t + b_t * y_{t+1}, y_T = 0, where
    the chunks of `axis` tile T in rank order."""
    y_loc = linear_recurrence_reverse(a_loc, b_loc)
    bprod = torch.cumprod(b_loc.flip(0), 0).flip(0)     # prod_{u >= t} b_u
    all_b, all_a = _chunk_maps(bprod[0], y_loc[0], mesh, axis)
    # z[k] = the composition over chunks k..K-1 applied to 0; the carry
    # entering chunk k is z[k+1] (0 for the last chunk).
    z = linear_recurrence_reverse(all_a, all_b, method="associative")
    carry_all = torch.cat([z[1:], torch.zeros_like(z[-1:])])
    return y_loc + bprod * carry_all[mesh.axis_index(axis)]


def forward_local(a_loc, b_loc, mesh, axis: str) -> torch.Tensor:
    """y on this rank's chunk of y_t = a_t + b_t * y_{t-1}, y_{-1} = 0."""
    y_loc = linear_recurrence_forward(a_loc, b_loc)
    bprod = torch.cumprod(b_loc, 0)                     # prod_{u <= t} b_u
    all_b, all_a = _chunk_maps(bprod[-1], y_loc[-1], mesh, axis)
    z = linear_recurrence_forward(all_a, all_b, method="associative")
    carry_all = torch.cat([torch.zeros_like(z[:1]), z[:-1]])
    return y_loc + bprod * carry_all[mesh.axis_index(axis)]


def local_plane(x, mesh, time_axis: str, batch_axis: Optional[str]):
    """This rank's (T/K, B/Kb, ...) block of a global (T, B, ...) tensor."""
    x = shard(x, mesh, time_axis, 0)
    return shard(x, mesh, batch_axis, 1) if batch_axis else x


def global_plane(x, mesh, time_axis: str, batch_axis: Optional[str]):
    """The global tensor from every rank's block (local_plane's inverse)."""
    x = all_gather(x, mesh, time_axis, 0)
    return all_gather(x, mesh, batch_axis, 1) if batch_axis else x


def _sharded(local_fn, a, b, mesh, time_axis, batch_axis):
    a = torch.as_tensor(a)
    b = torch.broadcast_to(torch.as_tensor(b, dtype=a.dtype, device=a.device),
                           a.shape)
    y = local_fn(local_plane(a, mesh, time_axis, batch_axis),
                 local_plane(b, mesh, time_axis, batch_axis), mesh, time_axis)
    return global_plane(y, mesh, time_axis, batch_axis)


def linear_recurrence_reverse_sharded(
    a: torch.Tensor,
    b,
    mesh,
    time_axis: str = "time",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """y_t = a_t + b_t * y_{t+1} with axis 0 (time) sharded over `time_axis`
    and, optionally, axis 1 (batch) sharded over `batch_axis`."""
    return _sharded(reverse_local, a, b, mesh, time_axis, batch_axis)


def linear_recurrence_forward_sharded(
    a: torch.Tensor,
    b,
    mesh,
    time_axis: str = "time",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """y_t = a_t + b_t * y_{t-1} with time sharded over `time_axis`."""
    return _sharded(forward_local, a, b, mesh, time_axis, batch_axis)
