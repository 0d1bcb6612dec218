"""AlphaStar entity-scatter oracle (plain PyTorch), the counterpart of the
JAX package's origin/scatter_connection.py: scatter (B, M, N) entity
embeddings to a (B, N, H, W) spatial map at (y, x) locations.

Both modes are deterministic: 'add' sums collisions and 'cover' keeps the
highest entity index m (the last writer in entity order).  An entity whose
cell y*W + x lies outside [0, H*W) writes nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch


def scatter_connection(
    x: torch.Tensor,               # (B, M, N)
    spatial_size: Tuple[int, int],
    location: torch.Tensor,        # (B, M, 2) int (y, x)
    scatter_type: str = "cover",
) -> torch.Tensor:
    assert scatter_type in ("cover", "add"), scatter_type
    B, M, N = x.shape
    H, W = spatial_size
    cell = (location[..., 0] * W + location[..., 1]).long()     # (B, M)
    valid = (cell >= 0) & (cell < H * W)
    safe = torch.where(valid, cell, torch.zeros_like(cell))
    if scatter_type == "add":
        out = torch.zeros((B, H * W, N), dtype=x.dtype, device=x.device)
        out = out.scatter_add(1, safe[..., None].expand(B, M, N),
                              torch.where(valid[..., None], x,
                                          torch.zeros_like(x)))
    else:
        m_ids = torch.arange(M, device=x.device).expand(B, M)
        winner = torch.full((B, H * W), -1, dtype=torch.long,
                            device=x.device)
        winner = winner.scatter_reduce(1, safe, torch.where(valid, m_ids, -1),
                                       "amax")
        gathered = torch.gather(x, 1, winner.clamp_min(0)[..., None]
                                .expand(B, H * W, N))
        out = torch.where(winner[..., None] >= 0, gathered,
                          torch.zeros_like(gathered))
    return out.reshape(B, H, W, N).permute(0, 3, 1, 2)


class ScatterConnection:
    """Thin stateful wrapper mirroring the reference nn.Module API."""

    def __init__(self, scatter_type: str):
        assert scatter_type in ("cover", "add")
        self.scatter_type = scatter_type

    def __call__(self, x, spatial_size, location):
        return scatter_connection(x, spatial_size, location,
                                  self.scatter_type)

    forward = __call__
