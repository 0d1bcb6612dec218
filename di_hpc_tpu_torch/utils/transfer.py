"""The dtype host data takes when it lands on a device.

The JAX package runs without 64-bit mode, so its transfers (`jnp.asarray`,
`jax.device_put`) narrow float64 to float32 and int64 to int32; every other
dtype (bool, float32, bfloat16, int32, ...) lands as it is.  The port's
transfers -- `data.TrajectoryBuffer.sample_batch` and the padding of
`ops.padding` and `origin.padding`, on the host route and on the card
route -- follow the same rule through this module, so a float64 reward
field reaches the kernels' float32 path as it does in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_dtype", "to_device"]

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def device_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype an array of `dtype` has after a JAX transfer."""
    return _NARROW.get(dtype, dtype)


def to_device(x, device) -> torch.Tensor:
    """A numpy array or tensor on `device` in `device_dtype`: narrowed where
    it lies, then moved in one transfer (half the bytes of a float64 one)."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    return t.to(dtype=device_dtype(t.dtype)).to(device)
