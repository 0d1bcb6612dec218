"""GAE on the port's kernel, the counterpart of the JAX package's ops/gae.py.

Float32 (T, B) inputs under method "auto" (or "pallas") go to the GAE
kernel (kernels.gae): delta, the recurrence and the divide by the
denominators in one pass.  Other methods, dtypes and ranks take the scan
core: the denominator recurrence in closed form (ops.scan.gae_denominators),
then gae_t = denom_t*delta_t + (gamma*lambda)*gae_{t+1}.  The result is
detached, as the reference's GAE has no gradient.
"""

from __future__ import annotations

import torch

from ..kernels.rl_scans import gae as gae_kernel
from ..origin.gae import gae_data
from ._backend import fused_kernels_ok
from ._validate import check_time_batch
from .scan import Method, gae_denominators, linear_recurrence_reverse

__all__ = ["gae", "gae_data", "GAE"]


def gae(data: gae_data, gamma: float = 0.99, lambda_: float = 0.97,
        method: Method = "auto") -> torch.Tensor:
    """value (T+1, B), reward (T, B) -> advantage (T, B)."""
    value, reward = data
    check_time_batch("gae", value, reward)
    if fused_kernels_ok(value, reward, method=method):
        return gae_kernel(value, reward, gamma, lambda_).detach()

    T = reward.shape[0]
    delta = reward + gamma * value[1:] - value[:-1]
    denom = gae_denominators(T, lambda_, dtype=delta.dtype,
                             device=delta.device)
    denom_b = denom.reshape((T,) + (1,) * (delta.ndim - 1))
    gae_item = linear_recurrence_reverse(
        denom_b * delta, torch.full_like(delta, gamma * lambda_),
        method=method)
    return (gae_item / denom_b).detach()


class GAE:
    """Shape-static wrapper mirroring the reference module API."""

    def __init__(self, T: int, B: int):
        self.T, self.B = T, B

    def __call__(self, value, reward, gamma: float = 0.99,
                 lambda_: float = 0.97) -> torch.Tensor:
        for name, x, want in (("value", value, (self.T + 1, self.B)),
                              ("reward", reward, (self.T, self.B))):
            if tuple(x.shape) != want:
                raise ValueError(f"GAE: {name} must be {want}; got "
                                 f"{tuple(x.shape)}")
        return gae(gae_data(value, reward), gamma, lambda_)

    forward = __call__
