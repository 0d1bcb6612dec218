"""Production ragged-batch padding, the counterpart of the JAX package's
ops/padding.py: host bucketing, then dense padded batches on a device.

Same API and semantics as the oracle (di_hpc_tpu_torch.origin.padding),
with a `device` argument (default "cuda") for where the batches land:

 - the oracle bucketing DP runs in the C host core (csrc/host/bucketing.cpp);
 - host inputs (numpy arrays, CPU tensors) are packed on the host, then
   moved to `device` in one transfer per tensor.  The route is decided
   before the pack: when every item is a contiguous float32 array the C
   pack (csrc/host/hostcore.c) writes the batch and its float32 mask;
   otherwise the oracle's numpy pack runs in the first item's dtype;
 - inputs already on the card (CUDA tensors) are packed there: one
   preallocated batch and mask, one slice copy per item, no round trip
   through the host.  It writes the bits the host route writes.

On every route the batch and its mask land in the first item's dtype
narrowed as the JAX package's transfers narrow it (float64 to float32,
int64 to int32; utils.transfer), so both packages give one dtype.

Grouped bucketing bounds the set of padded shapes, which is what a
consumer with per-shape work (a cached plan, a captured graph) needs.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..origin import padding as _origin
from ..origin.padding import (
    UnPadding1D,
    UnPadding2D,
    UnPadding3D,
    cum,
)
from ..utils.native import native_oracle_split_group, native_pack_padded_f32
from ..utils.transfer import device_dtype, to_device

__all__ = [
    "Padding1D", "Padding2D", "Padding3D",
    "UnPadding1D", "UnPadding2D", "UnPadding3D",
    "oracle_split_group", "sample_split_group",
]


def _on_cuda(x) -> bool:
    """True when the items are CUDA tensors (all on one card); raises for
    a list that mixes them with host items or cards."""
    cuda = [isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in x]
    if not any(cuda):
        return False
    devices = {t.device for t in x if isinstance(t, torch.Tensor)}
    if not all(cuda) or len(devices) > 1:
        raise ValueError("padding: the items must all lie on one CUDA device "
                         f"or all on the host; got {sorted(map(str, devices))}"
                         f" and {cuda.count(False)} host items")
    return True


def _pad_on_card(x, value, ndim):
    """The pack on the card: the batch and mask in x[0]'s dtype after the
    transfer rule (utils.transfer.device_dtype), `value` outside each item,
    the item (and 1 in the mask) inside."""
    shapes = [tuple(t.shape) for t in x]
    for s in shapes:
        assert len(s) == ndim, (s, ndim)
    max_shape = [max(d) for d in zip(*shapes)]
    like = dict(dtype=device_dtype(x[0].dtype), device=x[0].device)
    padded = torch.full((len(x), *max_shape), value, **like)
    mask = torch.full((len(x), *max_shape), value, **like)
    for i, t in enumerate(x):
        region = (i,) + tuple(slice(0, d) for d in shapes[i])
        padded[region] = t.detach()
        mask[region] = 1
    return padded, mask, shapes


def _pad_nd_fast(x, value, ndim, device):
    """(padded, mask, shapes) on `device`, by the route the module docstring
    gives."""
    if _on_cuda(x):
        padded, mask, shapes = _pad_on_card(x, value, ndim)
        return padded.to(device), mask.to(device), shapes
    host = [_origin._to_host(t) for t in x]
    shapes = [tuple(a.shape) for a in host]
    if (host and all(len(s) == ndim for s in shapes)
            and all(a.dtype == np.float32 and a.flags.c_contiguous
                    for a in host)):
        max_shape = [max(d) for d in zip(*shapes)]
        padded, mask = native_pack_padded_f32(host, max_shape, value)
    else:
        padded, mask, shapes = _origin._pad_nd_host(host, value, ndim)
    return to_device(padded, device), to_device(mask, device), shapes


def oracle_split_group(x: List, group: int):
    """Exact min-cost bucketing through the C DP (the oracle's semantics and
    tie-breaking).  Input must be sorted ascending by numel."""
    numels = [cum(tuple(t.shape)) for t in x]
    positions, _cost = native_oracle_split_group(numels, group)
    shapes = [tuple(x[i - 1].shape) for i in positions[1:]]
    return shapes, positions


def sample_split_group(x: List, group: int, rng=None):
    """Random-pivot bucketing: sample group-1 pivot shapes + the max shape,
    dedupe, and split the sorted list at each pivot.  Returns (group_shapes,
    group_idx).  `rng` is a np.random.Generator, as in the JAX package, so
    one seed gives the same buckets on both.

    Unlike the reference (which dedupes pivots by shape and crashes its
    bucket-count invariant when two distinct shapes share a numel), pivots
    here are deduped by numel: the split comparisons are numel-based, so
    equal-numel shapes are one pivot.
    """
    rng = np.random.default_rng() if rng is None else rng
    x_sorted = sorted(x, key=lambda t: cum(tuple(t.shape)))
    sampled_idx = set(rng.choice(len(x_sorted), group - 1).tolist())
    group_shape = [tuple(t.shape) for i, t in enumerate(x_sorted) if i in sampled_idx]
    group_shape += [tuple(x_sorted[-1].shape)]
    group_shape = sorted({cum(s): s for s in group_shape}.values(), key=cum)
    group_shape_idx = 0
    group_idx = [0]
    for i, t in enumerate(x_sorted):
        if cum(tuple(t.shape)) > cum(group_shape[group_shape_idx]):
            group_idx.append(i)
            group_shape_idx += 1
    group_idx.append(len(x_sorted))
    return group_shape, group_idx


def _padding_nd(x, ndim, mode="constant", value=0, group=1,
                group_mode="sample", rng=None, device="cuda"):
    assert mode == "constant", mode
    assert group_mode in ("sample", "oracle"), group_mode
    assert group >= 1, group
    if group <= 1:
        return _pad_nd_fast(x, value, ndim, device)
    x = sorted(x, key=lambda t: cum(tuple(t.shape)))
    if group_mode == "oracle":
        group_shape, group_idx = oracle_split_group(x, group)
    else:
        group_shape, group_idx = sample_split_group(x, group, rng=rng)
    assert len(group_idx) == len(group_shape) + 1
    ret = [
        _pad_nd_fast(x[group_idx[i]:group_idx[i + 1]], value, ndim, device)
        for i in range(len(group_shape))
    ]
    return list(zip(*ret))


def Padding1D(x, mode="constant", value=0, group=1, group_mode="sample",
              rng=None, device="cuda"):
    return _padding_nd(x, 1, mode, value, group, group_mode, rng, device)


def Padding2D(x, mode="constant", value=0, group=1, group_mode="sample",
              rng=None, device="cuda"):
    return _padding_nd(x, 2, mode, value, group, group_mode, rng, device)


def Padding3D(x, mode="constant", value=0, group=1, group_mode="sample",
              rng=None, device="cuda"):
    return _padding_nd(x, 3, mode, value, group, group_mode, rng, device)
