"""Scatter connection as one-hot products, the counterpart of the JAX
package's network/scatter_connection.py.

Both modes are computed as batched products with a one-hot (B, M, H*W)
selection, `torch.bmm` in float32 (a plain product, as the JAX package
leaves its einsum to XLA, outside any Pallas kernel):

 - 'add':   out[b, hw, :] = sum_m 1[cell_bm == hw] * x[b, m, :];
 - 'cover': winner[b, hw] = max_m (cell_bm == hw ? m : -1), then the one-hot
   of the winning entity selects its row: the last writer by entity index.

The products are exact selections and sums of x, and they use no float
atomics, so the result is deterministic on the card (index_add_ would add in
an order that changes from run to run).  An entity whose cell y*W + x lies
outside [0, H*W) matches no column: it writes nothing and gets a zero
gradient.

The backward is the JAX package's custom VJP (`_bwd_impl`), an
autograd.Function: every entity reads the output gradient at its own cell.
That is the gradient of 'add'; for 'cover' it is the reference's documented
approximation, where colliding entities all read the winner's gradient,
and not what autograd through the forward would give (the winner only).

The JAX package's budget gates (_ONEHOT_BUDGET_BYTES, _MAX_HW_FOR_MATMUL)
choose between the TPU's matrix unit and its serialized scatter; they are
facts about the TPU and are not carried over.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops._validate import _fail, _is_int

__all__ = ["scatter_connection", "ScatterConnection"]


def _cells(location, W):
    return location[..., 0].long() * W + location[..., 1].long()   # (B, M)


def _onehot(cell, HW, dtype):
    """(B, M, HW) with a one where column hw is entity m's cell."""
    hw = torch.arange(HW, device=cell.device)
    return (cell[..., None] == hw).to(dtype)


class _ScatterFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spatial_size, location, scatter_type):
        B, M, N = x.shape
        H, W = spatial_size
        cell = _cells(location, W)
        hit = _onehot(cell, H * W, torch.bool)                  # (B, M, HW)
        if scatter_type == "cover":
            m_ids = torch.arange(M, device=x.device)[None, :, None]
            winner = torch.where(hit, m_ids, -1).amax(dim=1)     # (B, HW)
            hit = m_ids == winner[:, None, :]
        out = torch.bmm(hit.to(x.dtype).transpose(1, 2), x)     # (B, HW, N)
        ctx.spatial_size = spatial_size
        ctx.save_for_backward(location)
        return out.reshape(B, H, W, N).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        (location,) = ctx.saved_tensors
        H, W = ctx.spatial_size
        B, N = g.shape[:2]
        g_flat = g.permute(0, 2, 3, 1).reshape(B, H * W, N)    # (B, HW, N)
        onehot = _onehot(_cells(location, W), H * W, g.dtype)
        return torch.bmm(onehot, g_flat), None, None, None


def scatter_connection(x: torch.Tensor, spatial_size: Tuple[int, int],
                       location: torch.Tensor,
                       scatter_type: str = "cover") -> torch.Tensor:
    """(B, M, N) entities + (B, M, 2) (y, x) locations -> (B, N, H, W)."""
    if x.ndim != 3:
        _fail("scatter_connection", f"x must be (B, M, N); got "
                                    f"{tuple(x.shape)}")
    if tuple(location.shape) != tuple(x.shape[:2]) + (2,):
        _fail("scatter_connection",
              f"location must have shape {tuple(x.shape[:2]) + (2,)} ((B, M, "
              f"2) (y, x) pairs); got {tuple(location.shape)}")
    if not _is_int(location):
        _fail("scatter_connection", "location must be an integer tensor; "
                                    f"got dtype {location.dtype}")
    if scatter_type not in ("cover", "add"):
        _fail("scatter_connection",
              f"scatter_type must be 'cover' or 'add'; got {scatter_type!r}")
    return _ScatterFunction.apply(x, tuple(spatial_size), location,
                                  scatter_type)


class ScatterConnection:
    """Wrapper mirroring the reference module API."""

    def __init__(self, scatter_type: str):
        assert scatter_type in ("cover", "add")
        self.scatter_type = scatter_type

    def __call__(self, x, spatial_size, location):
        return scatter_connection(x, tuple(spatial_size), location,
                                  self.scatter_type)

    forward = __call__
