"""Ragged-batch padding oracles, the counterpart of the JAX package's
origin/padding.py (reference semantics, plain Python and numpy).

Pack a list of different-shaped arrays into a padded dense batch, a mask
and the list of shapes, optionally split into at most `group` buckets (by
random-sample pivots or by an exact DP) to cut pad waste.  The batch is
assembled on the host with numpy and moved to `device` once; inputs may be
numpy arrays or tensors on any device (a CUDA tensor is read back to the
host first, as the JAX oracle reads device arrays with np.asarray).  The
production path, with the C host core and a pack on the card for CUDA
inputs, is di_hpc_tpu_torch.ops.padding.
"""

from __future__ import annotations

from functools import reduce
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["cum", "oracle_split_group", "Padding1D", "Padding2D",
           "Padding3D", "UnPadding1D", "UnPadding2D", "UnPadding3D"]


def cum(t: Sequence[int]) -> int:
    return reduce(lambda a, b: a * b, t)


def oracle_split_group(x: List, group: int) -> Tuple[List[Tuple], List[int]]:
    """Exact DP bucketing minimizing total padded cost, O(M*N^2).

    Inputs must be sorted ascending by numel.  Returns (shapes, positions)
    where positions are the split indices into x (len group+1, positions[0]=0)
    and shapes[i] is the max shape of bucket i.
    """
    arr = [None] + [cum(tuple(t.shape)) for t in x]
    N, M = len(arr) - 1, group

    def p(start: int, end: int) -> int:
        return arr[end] * (end - start + 1)

    f = {(0, 0): (0, 0)}
    for i in range(1, N + 1):
        for j in range(1, M + 1):
            ress = []
            for k in range(0, i):
                if (k, j - 1) in f:
                    last_cost, _ = f[(k, j - 1)]
                    ress.append((last_cost + p(k + 1, i), k))
            if ress:
                f[(i, j)] = min(ress)

    last_position, last_cnt = N, M
    positions = [N]
    while last_position > 0:
        _, last_position = f[(last_position, last_cnt)]
        last_cnt -= 1
        positions.append(last_position)
    assert len(positions) == M + 1
    positions = positions[::-1]
    shapes = [tuple(x[i - 1].shape) for i in positions[1:]]
    return shapes, positions


def _to_host(t) -> np.ndarray:
    """A numpy view or copy of one input: tensors are detached and read back
    to the host."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _pad_nd_host(x: List, value=0, ndim: int = 1):
    """The numpy pack: (padded (len(x), *max_shape), mask, shapes), both in
    x[0]'s dtype.  The mask holds the fill value outside the valid regions
    and 1 inside, as the reference's does."""
    shapes = [tuple(t.shape) for t in x]
    for s in shapes:
        assert len(s) == ndim, (s, ndim)
    max_shape = [max(d) for d in zip(*shapes)]
    new_shape = (len(x), *max_shape)
    dtype = _to_host(x[0]).dtype
    padded = np.full(new_shape, value, dtype=dtype)
    mask = np.full(new_shape, value, dtype=dtype)
    for i, t in enumerate(x):
        region = (i,) + tuple(slice(0, d) for d in shapes[i])
        padded[region] = _to_host(t)
        mask[region] = 1
    return padded, mask, shapes


def _pad_nd(x: List, value=0, ndim: int = 1, device="cuda"):
    """Pad a list of ndim-dimensional arrays to the elementwise-max shape:
    (padded, mask, shapes), the two tensors on `device`."""
    padded, mask, shapes = _pad_nd_host(x, value, ndim)
    return (torch.from_numpy(padded).to(device),
            torch.from_numpy(mask).to(device), shapes)


def _grouped_padding(x: List, value, group: int, group_mode: str, ndim: int,
                     rng=None, device="cuda"):
    assert group_mode in ("sample", "oracle"), group_mode
    x = sorted(x, key=lambda t: cum(tuple(t.shape)))
    if group_mode == "sample":
        rng = np.random.default_rng() if rng is None else rng
        sampled_idx = set(rng.choice(len(x), group - 1).tolist())
        group_shape = [tuple(t.shape) for i, t in enumerate(x) if i in sampled_idx]
        group_shape += [tuple(x[-1].shape)]
        # Deduped by shape, as the reference does: two sampled shapes with
        # one numel leave fewer splits than buckets, and the assert below
        # fails, as the reference's does.
        group_shape = sorted(set(group_shape), key=cum)
        group_shape_idx = 0
        group_idx = [0]
        for i, t in enumerate(x):
            if cum(tuple(t.shape)) > cum(group_shape[group_shape_idx]):
                group_idx.append(i)
                group_shape_idx += 1
        group_idx.append(len(x))
    else:
        group_shape, group_idx = oracle_split_group(x, group)
    assert len(group_idx) == len(group_shape) + 1
    ret = [
        _pad_nd(x[group_idx[i]:group_idx[i + 1]], value, ndim, device)
        for i in range(len(group_shape))
    ]
    return list(zip(*ret))


def _padding(x, ndim, mode, value, group, group_mode, rng, device):
    assert mode == "constant", mode
    assert group >= 1, group
    if group > 1:
        return _grouped_padding(x, value, group, group_mode, ndim, rng,
                                device)
    return _pad_nd(x, value, ndim, device)


def Padding1D(x: List, mode: str = "constant", value=0, group: int = 1,
              group_mode: str = "sample", rng=None, device="cuda"):
    return _padding(x, 1, mode, value, group, group_mode, rng, device)


def Padding2D(x: List, mode: str = "constant", value=0, group: int = 1,
              group_mode: str = "sample", rng=None, device="cuda"):
    return _padding(x, 2, mode, value, group, group_mode, rng, device)


def Padding3D(x: List, mode: str = "constant", value=0, group: int = 1,
              group_mode: str = "sample", rng=None, device="cuda"):
    return _padding(x, 3, mode, value, group, group_mode, rng, device)


def _unpad(x, shapes: List, deepcopy: bool = False):
    out = []
    for i in range(x.shape[0]):
        region = (i,) + tuple(slice(0, d) for d in shapes[i])
        item = x[region]
        if deepcopy:
            item = item.clone()
        out.append(item)
    return out


def UnPadding1D(x, shapes, deepcopy: bool = False):
    """The items of a padded batch (or of a list of buckets) cut back to
    their shapes: views of `x`, or copies with `deepcopy`."""
    if isinstance(x, (list, tuple)):
        return sum((_unpad(t, s, deepcopy) for t, s in zip(x, shapes)), [])
    return _unpad(x, shapes, deepcopy)


UnPadding2D = UnPadding1D
UnPadding3D = UnPadding1D
